"""Packed block-quantized weights (q4_0, q8_0) as torch tensors.

The decode hot path is bound by device-memory bandwidth, so the weights
stay PACKED on the card (q4_0: 4.5 bits a weight with its f32 scale
plane counted as 1 bit) and are dequantized inside the matmul kernel
(quant/qmatmul.py).

Device layout — the same as ``tpu_llm/quant/qtensor.py``, so parameters
carry across unchanged:
- The logical weight W is (K, N) = (in_features, out_features), used as
  ``x @ W``.
- q4_0: ``q`` is (K//2, N) uint8 with ggml's block-local nibble pairing
  kept per column: byte (16*b + j, n) holds W[32*b + j, n] in its low
  nibble and W[32*b + 16 + j, n] in its high nibble.
  Value = (nibble - 8) * scale[k//32, n].
- q8_0: ``q`` is (K, N) int8; value = q * scale[k//32, n].
- ``scales`` is (K//32, N) float32.

Repacking from the ggml on-disk byte order is a numpy transpose at load
time.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from tpu_llm_torch.quant import blocks as qblocks

KINDS = ("q4_0", "q8_0")


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor        # packed quants, see module docstring
    scales: torch.Tensor   # (K//32, N) float32
    kind: str              # "q4_0" | "q8_0"

    @property
    def shape(self) -> Tuple[int, int]:
        kq, n = self.q.shape
        return (kq * 2 if self.kind == "q4_0" else kq, n)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scales.numel() * self.scales.element_size())


def _check_kind(kind: str):
    if kind not in KINDS:
        qblocks.not_in_slice(kind)


# -- host-side repacking -----------------------------------------------------

def _split_ggml_q4_0(raw: np.ndarray, rows: int, row_len: int):
    """ggml q4_0 bytes of a (rows, row_len) row-major tensor ->
    (packed (row_len//2, rows) uint8, scales (row_len//32, rows) f32) for
    the transposed logical weight W (K=row_len, N=rows)."""
    nb = row_len // qblocks.QK4_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q4_0_BLOCK_BYTES)
    d = raw[:, :, :2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    # ggml already stores block-local nibble pairs (j, j+16); keeping that
    # order per column is exactly the device layout — repack is a transpose
    qs = raw[:, :, 2:].reshape(rows, row_len // 2)
    return np.ascontiguousarray(qs.T), np.ascontiguousarray(d.T)


def _split_ggml_q8_0(raw: np.ndarray, rows: int, row_len: int):
    nb = row_len // qblocks.QK8_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q8_0_BLOCK_BYTES)
    d = raw[:, :, :2].copy().view(np.float16).astype(np.float32).reshape(rows, nb)
    q = raw[:, :, 2:].view(np.int8).reshape(rows, row_len)
    return np.ascontiguousarray(q.T), np.ascontiguousarray(d.T)


def qtensor_from_ggml(ggml_type: int, raw: np.ndarray, rows: int, row_len: int,
                      device="cpu") -> QTensor:
    """A QTensor on ``device`` from the on-disk ggml block bytes of a
    (rows, row_len) tensor, representing the transposed (row_len, rows)
    weight."""
    from tpu_llm_torch.io import gguf as gg

    if ggml_type == gg.GGML_Q4_0:
        q, scales = _split_ggml_q4_0(raw, rows, row_len)
        kind = "q4_0"
    elif ggml_type == gg.GGML_Q8_0:
        q, scales = _split_ggml_q8_0(raw, rows, row_len)
        kind = "q8_0"
    else:
        qblocks.not_in_slice(gg.GGML_TYPE_NAMES.get(ggml_type, str(ggml_type)))
    return QTensor(torch.from_numpy(q).to(device),
                   torch.from_numpy(scales).to(device), kind)


def quantize_tensor(w: np.ndarray, kind: str = "q4_0", device="cpu") -> QTensor:
    """Quantize a float (K, N) logical weight (tests / converters)."""
    from tpu_llm_torch.io import gguf as gg

    _check_kind(kind)
    k, n = w.shape
    flat = np.ascontiguousarray(np.asarray(w, np.float32).T).reshape(-1)
    if kind == "q4_0":
        raw = np.frombuffer(qblocks.quantize_q4_0(flat), np.uint8)
        return qtensor_from_ggml(gg.GGML_Q4_0, raw, n, k, device)
    raw = np.frombuffer(qblocks.quantize_q8_0(flat), np.uint8)
    return qtensor_from_ggml(gg.GGML_Q8_0, raw, n, k, device)


# -- device-side dequant -----------------------------------------------------

def unpack_q4(q: torch.Tensor) -> torch.Tensor:
    """(K//2, N) packed uint8 -> (K, N) int8 in [-8, 7]."""
    kh, n = q.shape
    blocks = q.reshape(kh // 16, 16, n)
    lo = (blocks & 0x0F).to(torch.int8) - 8
    hi = (blocks >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=1).reshape(kh * 2, n)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Materialize the logical (K, N) weight."""
    _check_kind(qt.kind)
    vals = unpack_q4(qt.q) if qt.kind == "q4_0" else qt.q
    k = vals.shape[0]
    scales = torch.repeat_interleave(qt.scales.float(), k // qt.scales.shape[0], dim=0)
    return (vals.float() * scales).to(dtype)
