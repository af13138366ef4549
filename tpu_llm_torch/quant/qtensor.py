"""Packed block-quantized weights as torch tensors.

The decode hot path is bound by device-memory bandwidth, so the weights
stay PACKED on the card (q4_0: 4.5 bits a weight with its f32 scale
plane counted as 1 bit) and are dequantized inside the matmul kernel
(quant/qmatmul.py).

Device layout — the same as ``tpu_llm/quant/qtensor.py``, so parameters
carry across unchanged:
- The logical weight W is (K, N) = (in_features, out_features), used as
  ``x @ W``.
- Nibble-packed kinds (q4_0, q4_1, q2_kp, q3_kp, q6_kp): ``q`` is
  (K//2, N) uint8 with ggml's block-local pairing kept per column: byte
  (16*b + j, n) holds W[32*b + j, n] in its low nibble and
  W[32*b + 16 + j, n] in its high nibble. Values: q4_0 nibble - 8; q4_1
  and q2_kp the nibble; q3_kp nibble - 4; q6_kp (nibble | qh << 4) - 32.
- int8-plane kinds (q8_0, q5_0, q5_1, q2_k, q3_k, q6_k): ``q`` is (K, N)
  int8 holding the value itself.
- q4_0i4, the int4-plane kind of the ``--scan`` program (``to_int4``):
  signed values in [-8, 7] at 0.5 byte a value. Torch has no int4 dtype,
  so ``q`` is (K//2, N) uint8 in q4_0's block-local layout, each nibble
  holding value + 8 (offset binary). A q4_0 plane is therefore already a
  q4_0i4 plane byte for byte, and so are the nibbles of q4_1 and q2_kp
  once their mins absorb the shift; q3_kp's nibbles move up by 4. Blocks
  of 32 rows (from q4_0 and q4_1) or 16 (from q2_kp and q3_kp).
- ``scales`` is (K//block, N), f32, bf16 or int16 holding f16 bits
  (``pack_scales_f16``): block 32 for the _0/_1 kinds and the folded
  q4_K/q5_K, 16 for the folded q2/q3/q6_K. Value = q * scale[k // block, n].
- ``mins`` (affine kinds q4_1, q5_1, q2_k, q2_kp) has the scales' layout
  and adds ``mins[k // block, n]``. For q6_kp the slot instead carries the
  (K//4, N) uint8 qh plane: byte (8*b + i, n) holds the high 2 bits of
  rows 32b + i, +8, +16, +24 at bit positions 0/2/4/6.

GGUF Q4_K and Q5_K load as q4_1 and q5_1 with their two-level scales
folded into flat bf16 planes; Q6_K loads as q6_k, Q3_K as q3_kp and Q2_K
as q2_kp. The JAX package's switches pick other layouts and are read here
at the same points: ``TPU_LLM_KQ_F32S`` (f32 folded planes),
``TPU_LLM_Q6K_PACK`` (q6_kp), ``TPU_LLM_Q23_INT8`` (q2_k / q3_k int8
planes). Repacking from the ggml on-disk byte order is numpy at load time.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_llm_torch.quant import blocks as qblocks

PACKED_KINDS = ("q4_0", "q4_1", "q2_kp", "q3_kp", "q6_kp", "q4_0i4")
INT8_KINDS = ("q8_0", "q5_0", "q5_1", "q2_k", "q3_k", "q6_k")
KINDS = PACKED_KINDS + INT8_KINDS
PLANE_DTYPES = (torch.float32, torch.bfloat16, torch.int16)   # int16: f16 bits


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor        # packed quants, see module docstring
    scales: torch.Tensor   # (K//block, N) float32, bfloat16 or int16 (f16 bits)
    kind: str              # one of KINDS
    mins: Optional[torch.Tensor] = None   # affine offsets, or q6_kp's qh plane

    @property
    def shape(self) -> Tuple[int, ...]:
        *lead, kq, n = self.q.shape
        return (*lead, kq * 2 if self.kind in PACKED_KINDS else kq, n)

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size()
                   for p in (self.q, self.scales, self.mins) if p is not None)


def qmap(fn, *qts: QTensor) -> QTensor:
    """Apply ``fn`` to each plane of same-kind QTensors (q, scales and mins
    share the N-axis layout, so concat / index / permute / ``.to`` apply
    the same function to every plane)."""
    mins = None if qts[0].mins is None else fn(*[t.mins for t in qts])
    return QTensor(fn(*[t.q for t in qts]), fn(*[t.scales for t in qts]),
                   qts[0].kind, mins)


# -- host-side repacking -----------------------------------------------------

def _f16_plane(raw: np.ndarray, rows: int, nb: int) -> np.ndarray:
    """(rows, nb, 2) f16 bytes -> (rows, nb) f32."""
    return raw.copy().view(np.float16).astype(np.float32).reshape(rows, nb)


def _t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def _split_ggml_q4_0(raw: np.ndarray, rows: int, row_len: int):
    """ggml q4_0 bytes of a (rows, row_len) row-major tensor ->
    (packed (row_len//2, rows) uint8, scales (row_len//32, rows) f32) for
    the transposed logical weight W (K=row_len, N=rows)."""
    nb = row_len // qblocks.QK4_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q4_0_BLOCK_BYTES)
    d = _f16_plane(raw[:, :, :2], rows, nb)
    # ggml already stores block-local nibble pairs (j, j+16); keeping that
    # order per column is exactly the device layout — repack is a transpose
    return _t(raw[:, :, 2:].reshape(rows, row_len // 2)), _t(d)


def _split_ggml_q4_1(raw: np.ndarray, rows: int, row_len: int):
    """ggml q4_1 -> (packed (row_len//2, rows) uint8, scales, mins
    (row_len//32, rows) f32)."""
    nb = row_len // qblocks.QK4_1
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q4_1_BLOCK_BYTES)
    d = _f16_plane(raw[:, :, 0:2], rows, nb)
    m = _f16_plane(raw[:, :, 2:4], rows, nb)
    return _t(raw[:, :, 4:].reshape(rows, row_len // 2)), _t(d), _t(m)


def _q5_values(qh: np.ndarray, qs: np.ndarray, rows: int, nb: int) -> np.ndarray:
    """(rows, nb, 4) high-bit words + (rows, nb, 16) nibbles -> (rows, nb*32)
    int16 5-bit values in [0, 31]."""
    hi_bit = qblocks._split_qh(qh.reshape(rows * nb, 4))
    lo = (qs & 0x0F).astype(np.int16)
    hi = (qs >> 4).astype(np.int16)
    q4 = np.concatenate([lo, hi], axis=2).reshape(rows * nb, 32)
    return (q4 | (hi_bit.astype(np.int16) << 4)).reshape(rows, nb * 32)


def _split_ggml_q5_0(raw: np.ndarray, rows: int, row_len: int):
    """ggml q5_0 -> (values (row_len, rows) int8 in [-16, 15], scales
    (row_len//32, rows) f32): the 4+1-bit packing recombined into an int8
    value plane at load."""
    nb = row_len // qblocks.QK5_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q5_0_BLOCK_BYTES)
    d = _f16_plane(raw[:, :, :2], rows, nb)
    q = (_q5_values(raw[:, :, 2:6], raw[:, :, 6:], rows, nb) - 16).astype(np.int8)
    return _t(q), _t(d)


def _split_ggml_q5_1(raw: np.ndarray, rows: int, row_len: int):
    """ggml q5_1 -> (values (row_len, rows) int8 in [0, 31], scales + mins
    (row_len//32, rows) f32)."""
    nb = row_len // qblocks.QK5_1
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q5_1_BLOCK_BYTES)
    d = _f16_plane(raw[:, :, 0:2], rows, nb)
    m = _f16_plane(raw[:, :, 2:4], rows, nb)
    q = _q5_values(raw[:, :, 4:8], raw[:, :, 8:], rows, nb).astype(np.int8)
    return _t(q), _t(d), _t(m)


def _split_ggml_q8_0(raw: np.ndarray, rows: int, row_len: int):
    nb = row_len // qblocks.QK8_0
    raw = np.asarray(raw, np.uint8).reshape(rows, nb, qblocks.Q8_0_BLOCK_BYTES)
    d = _f16_plane(raw[:, :, :2], rows, nb)
    return _t(raw[:, :, 2:].view(np.int8).reshape(rows, row_len)), _t(d)


def _pack_q4_unsigned(vals: np.ndarray) -> np.ndarray:
    """(K, N) u8 values in [0, 15] -> (K//2, N) packed uint8 in the device
    block-local layout (byte 16b+j holds W[32b+j] low / W[32b+16+j] high)."""
    k, n = vals.shape
    blk = vals.reshape(k // 32, 32, n)
    return (blk[:, :16, :] | (blk[:, 16:, :] << 4)).reshape(k // 2, n)


def _kq_split(split, block_bytes: int, raw: np.ndarray, rows: int, row_len: int,
              per: int):
    """A K-quant's superblocks -> (values (rows, row_len), folded scale
    plane (row_len//per, rows) f32, folded mins plane or None): scale =
    d*sc, min = -dmin*m — the two-level scheme folded into flat planes."""
    nb = row_len // qblocks.QK_K
    raw = np.asarray(raw, np.uint8).reshape(rows * nb, block_bytes)
    parts = split(raw)
    q = parts[0].reshape(rows, row_len)
    if len(parts) == 5:
        _, sc, m, d, dmin = parts
        mins = _t((-dmin * m).reshape(rows, nb * qblocks.QK_K // per).astype(np.float32))
    else:
        _, sc, d = parts
        mins = None
    scales = _t((d * sc).reshape(rows, nb * qblocks.QK_K // per).astype(np.float32))
    return q, scales, mins


def _split_ggml_q4_k(raw, rows, row_len):
    """q4_K -> the q4_1 device planes (packed values, per-32 scales, mins)."""
    q, s, m = _kq_split(qblocks._q4k_split, qblocks.Q4_K_BLOCK_BYTES, raw, rows, row_len, 32)
    return _pack_q4_unsigned(_t(q)), s, m


def _split_ggml_q5_k(raw, rows, row_len):
    """q5_K -> the q5_1 device planes (int8 values in [0, 31], scales, mins)."""
    q, s, m = _kq_split(qblocks._q5k_split, qblocks.Q5_K_BLOCK_BYTES, raw, rows, row_len, 32)
    return _t(q.astype(np.int8)), s, m


def _split_ggml_q6_k(raw, rows, row_len):
    """q6_K -> (int8 values in [-32, 31], per-16 scales)."""
    q, s, _ = _kq_split(qblocks._q6k_split, qblocks.Q6_K_BLOCK_BYTES, raw, rows, row_len, 16)
    return _t(q), s


def _split_ggml_q3_k(raw, rows, row_len):
    """q3_K -> (int8 values in [-4, 3], per-16 scales)."""
    q, s, _ = _kq_split(qblocks._q3k_split, qblocks.Q3_K_BLOCK_BYTES, raw, rows, row_len, 16)
    return _t(q), s


def _split_ggml_q2_k(raw, rows, row_len):
    """q2_K -> (int8 values in [0, 3], per-16 scales and mins)."""
    q, s, m = _kq_split(qblocks._q2k_split, qblocks.Q2_K_BLOCK_BYTES, raw, rows, row_len, 16)
    return _t(q.astype(np.int8)), s, m


def qtensor_from_ggml(ggml_type: int, raw: np.ndarray, rows: int, row_len: int,
                      device="cpu") -> QTensor:
    """A QTensor on ``device`` from the on-disk ggml block bytes of a
    (rows, row_len) tensor, representing the transposed (row_len, rows)
    weight."""
    from tpu_llm_torch.io import gguf as gg

    def qt(q, scales, kind, mins=None, kq=False):
        # folded K-quant planes ship in bf16 unless TPU_LLM_KQ_F32S is set
        plane = lambda a: None if a is None else (  # noqa: E731
            torch.from_numpy(a) if not kq or os.environ.get("TPU_LLM_KQ_F32S")
            else torch.from_numpy(a).bfloat16())
        return QTensor(torch.from_numpy(q).to(device), plane(scales).to(device), kind,
                       None if mins is None else plane(mins).to(device))

    if ggml_type == gg.GGML_Q4_0:
        return qt(*_split_ggml_q4_0(raw, rows, row_len), "q4_0")
    if ggml_type == gg.GGML_Q8_0:
        return qt(*_split_ggml_q8_0(raw, rows, row_len), "q8_0")
    if ggml_type == gg.GGML_Q4_1:
        q, s, m = _split_ggml_q4_1(raw, rows, row_len)
        return qt(q, s, "q4_1", m)
    if ggml_type == gg.GGML_Q5_0:
        return qt(*_split_ggml_q5_0(raw, rows, row_len), "q5_0")
    if ggml_type == gg.GGML_Q5_1:
        q, s, m = _split_ggml_q5_1(raw, rows, row_len)
        return qt(q, s, "q5_1", m)
    if ggml_type == gg.GGML_Q4_K:
        q, s, m = _split_ggml_q4_k(raw, rows, row_len)
        return qt(q, s, "q4_1", m, kq=True)
    if ggml_type == gg.GGML_Q5_K:
        q, s, m = _split_ggml_q5_k(raw, rows, row_len)
        return qt(q, s, "q5_1", m, kq=True)
    if ggml_type == gg.GGML_Q6_K:
        out = qt(*_split_ggml_q6_k(raw, rows, row_len), "q6_k", kq=True)
        return pack_q6_k(out) if os.environ.get("TPU_LLM_Q6K_PACK") else out
    if ggml_type == gg.GGML_Q3_K:
        q, s = _split_ggml_q3_k(raw, rows, row_len)
        if os.environ.get("TPU_LLM_Q23_INT8"):
            return qt(q, s, "q3_k", kq=True)
        # u = q + 4 in [0, 7], nibble-packed
        return qt(_pack_q4_unsigned((q.astype(np.int16) + 4).astype(np.uint8)), s,
                  "q3_kp", kq=True)
    if ggml_type == gg.GGML_Q2_K:
        q, s, m = _split_ggml_q2_k(raw, rows, row_len)
        if os.environ.get("TPU_LLM_Q23_INT8"):
            return qt(q, s, "q2_k", m, kq=True)
        return qt(_pack_q4_unsigned(q.astype(np.uint8)), s, "q2_kp", m, kq=True)
    raise ValueError(f"unsupported ggml type for QTensor: {ggml_type}")


def plane_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (ml_dtypes bf16 included: its bits are carried) as a
    tensor on ``device``."""
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def qtensor_from_numpy(q, scales, kind: str, mins=None, device="cpu") -> QTensor:
    """The JAX package's QTensor planes, as numpy, -> a QTensor. Its
    q4_0i4 value plane is a (K, N) int4 array (ml_dtypes, one byte a
    value), packed here into the port's nibble layout."""
    q = np.asarray(q)
    if kind == "q4_0i4" and q.dtype.name == "int4":
        *lead, K, N = q.shape
        u = (q.astype(np.int16) + 8).astype(np.uint8).reshape(*lead, K // 32, 32, N)
        q = (u[..., :16, :] | (u[..., 16:, :] << 4)).reshape(*lead, K // 2, N)
    return QTensor(plane_from_numpy(q, device), plane_from_numpy(scales, device), kind,
                   None if mins is None else plane_from_numpy(mins, device))


def quantize_tensor(w: np.ndarray, kind: str = "q4_0", device="cpu") -> QTensor:
    """Quantize a float (K, N) logical weight (tests / converters): ``kind``
    names a ggml codec (q4_0 ... q5_1, q2_k ... q6_k); the K-quants load
    through qtensor_from_ggml, so their device kind follows its defaults."""
    from tpu_llm_torch.io import gguf as gg

    ggml_type = {name: t for t, name in gg.QUANT_CODECS.items()}.get(kind)
    if ggml_type is None:      # q4_0i4 too: only to_int4 makes it
        raise ValueError(kind)
    k, n = w.shape
    flat = np.ascontiguousarray(np.asarray(w, np.float32).T).reshape(-1)
    raw = np.frombuffer(getattr(qblocks, f"quantize_{kind}")(flat), np.uint8)
    return qtensor_from_ggml(ggml_type, raw, n, k, device)


# -- device-side transforms and dequant --------------------------------------

def unpack_q4_unsigned(q: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) packed uint8 -> (..., K, N) uint8 in [0, 15]."""
    *lead, kh, n = q.shape
    blocks = q.reshape(*lead, kh // 16, 16, n)
    return torch.cat([blocks & 0x0F, blocks >> 4], dim=-2).reshape(*lead, kh * 2, n)


def unpack_q4(q: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) packed uint8 -> (..., K, N) int8 in [-8, 7]."""
    return unpack_q4_unsigned(q).to(torch.int8) - 8


def _pack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """(K, N) values in [0, 15] (any int dtype) -> (K//2, N) packed uint8."""
    K, N = u.shape
    b = u.to(torch.int32).reshape(K // 32, 32, N)
    return (b[:, :16] | (b[:, 16:] << 4)).to(torch.uint8).reshape(K // 2, N)


def pack_q2_k(qt: QTensor) -> QTensor:
    """int8-plane q2_k ([0, 3]) -> nibble-packed q2_kp; planes unchanged."""
    assert qt.kind == "q2_k", qt.kind
    return QTensor(_pack_nibbles(qt.q), qt.scales, "q2_kp", qt.mins)


def pack_q3_k(qt: QTensor) -> QTensor:
    """int8-plane q3_k ([-4, 3]) -> nibble-packed q3_kp storing u = q + 4."""
    assert qt.kind == "q3_k", qt.kind
    return QTensor(_pack_nibbles(qt.q.to(torch.int32) + 4), qt.scales, "q3_kp")


def pack_q6_k(qt: QTensor) -> QTensor:
    """int8-plane q6_k -> the 6-bit q6_kp: ql nibbles of u = q + 32 in the
    q4 layout, and the (K//4, N) qh plane in the mins slot (byte i of a
    32-row block holds the high 2 bits of rows i, i+8, i+16, i+24 at bit
    positions 0/2/4/6)."""
    assert qt.kind == "q6_k", qt.kind
    K, N = qt.q.shape
    u = qt.q.to(torch.int32) + 32
    ql = _pack_nibbles(u & 0x0F)
    hi = (u >> 4).reshape(K // 32, 32, N)
    qh = (hi[:, 0:8] | (hi[:, 8:16] << 2) | (hi[:, 16:24] << 4)
          | (hi[:, 24:32] << 6)).to(torch.uint8).reshape(K // 4, N)
    return QTensor(ql, qt.scales, "q6_kp", qh)


def to_int4(qt: QTensor) -> QTensor:
    """q4_0 / q4_1 / q2_kp / q3_kp -> the int4-plane kind q4_0i4 (the
    ``--scan`` program's weights); other kinds are returned as they are.
    Same logical weights and scales. q4_1 and q2_kp recentre into the
    signed range through their mins: q*s + m == (q-8)*s + (m + 8s), the
    new mins computed in f32 and kept at the scales' width (bf16 planes
    stay bf16). q3_kp's values are in range already (nibble + 4). The q
    plane is shared, not copied, for q4_0, q4_1 and q2_kp (module
    docstring)."""
    if qt.kind in ("q4_1", "q2_kp"):
        s = unpack_scales_f16(qt.scales)
        mins = _to_plane_dtype(unpack_scales_f16(qt.mins) + 8.0 * s, qt.scales.dtype)
        return QTensor(qt.q, qt.scales, "q4_0i4", mins)
    if qt.kind == "q3_kp":
        return QTensor(qt.q + 0x44, qt.scales, "q4_0i4")   # nibbles <= 7: no carry
    if qt.kind == "q4_0":
        return QTensor(qt.q, qt.scales, "q4_0i4")
    return qt


def _to_plane_dtype(p: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.int16:
        return p.to(torch.float16).view(torch.int16)
    return p.to(dtype)


def pack_scales_f16(qt: QTensor) -> QTensor:
    """f32 (or bf16) scale and mins planes -> f16 bits stored as int16:
    half the bytes of f32, exact for f16-valued scales (GGUF's block
    formats store an f16 ``d``); folded K-quant products round. The
    kernel rebuilds f32 from the bits in registers."""
    if qt.scales.dtype == torch.int16:
        return qt
    affine = qt.mins is not None and qt.kind != "q6_kp"
    return QTensor(qt.q, _to_plane_dtype(qt.scales, torch.int16), qt.kind,
                   _to_plane_dtype(qt.mins, torch.int16) if affine else qt.mins)


def pack_scales_bf16(qt: QTensor) -> QTensor:
    """f32 scale (and mins) planes -> bf16: half the scale bytes, rounding
    each block's scale by at most 2^-8 relative. bf16 and int16 planes are
    left as they are."""
    if qt.scales.dtype in (torch.bfloat16, torch.int16):
        return qt
    affine = qt.mins is not None and qt.kind != "q6_kp"
    return QTensor(qt.q, qt.scales.bfloat16(), qt.kind,
                   qt.mins.bfloat16() if affine else qt.mins)


def unpack_scales_f16(p: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A scale or mins plane as ``dtype``: int16 planes hold f16 bits."""
    if p.dtype == torch.int16:
        return p.view(torch.float16).to(dtype)
    return p.to(dtype)


def _check_plane_dtype(qt: QTensor):
    if qt.kind not in KINDS or qt.scales.dtype not in PLANE_DTYPES:
        raise ValueError(f"QTensor kind {qt.kind} with {qt.scales.dtype} scales")


def qvalues(qt: QTensor):
    """(values (..., K, N) int, affine): the unpacked integer value of every
    weight before its scale, and whether the mins plane holds affine mins
    (q6_kp's holds its qh bits, which ``values`` already include)."""
    _check_plane_dtype(qt)
    affine = qt.mins is not None
    if qt.kind in ("q4_0", "q4_0i4"):
        vals = unpack_q4(qt.q)
    elif qt.kind in ("q4_1", "q2_kp"):
        vals = unpack_q4_unsigned(qt.q)
    elif qt.kind == "q3_kp":
        vals = unpack_q4_unsigned(qt.q).to(torch.int32) - 4
    elif qt.kind == "q6_kp":
        lo = unpack_q4_unsigned(qt.q).to(torch.int32)
        *lead, kq4, n = qt.mins.shape              # the qh plane (K/4, N)
        hb = qt.mins.reshape(*lead, kq4 // 8, 8, n).to(torch.int32)
        hi = torch.cat([hb & 3, (hb >> 2) & 3, (hb >> 4) & 3, (hb >> 6) & 3],
                       dim=-2).reshape(*lead, kq4 * 4, n)
        vals = (lo | (hi << 4)) - 32
        affine = False                             # the mins slot is qh
    else:
        vals = qt.q
    return vals, affine


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Materialize the logical (..., K, N) weight: values times the scale
    of their block (K // scales rows), plus the block's min for the
    affine kinds; computed in ``dtype``."""
    vals, affine = qvalues(qt)
    vals = vals.to(dtype)
    rep = vals.shape[-2] // qt.scales.shape[-2]
    out = vals * torch.repeat_interleave(unpack_scales_f16(qt.scales, dtype), rep, dim=-2)
    if affine:
        out = out + torch.repeat_interleave(unpack_scales_f16(qt.mins, dtype), rep, dim=-2)
    return out


def pad_k(qt: QTensor, k_multiple: int = 1024) -> QTensor:
    """Zero-pad the contraction dim to a multiple of ``k_multiple``. The
    padded SCALE rows are zero, so every padded weight dequantizes to 0
    whatever its q / qh / mins bytes; the caller zero-pads x to match
    (quant/linear.matmul)."""
    *_, K, _ = qt.shape
    Kp = -(-K // k_multiple) * k_multiple
    if Kp == K:
        return qt
    extra = Kp - K

    def pad_plane(p):
        prows = p.shape[-2]
        assert (extra * prows) % K == 0, (qt.kind, K, extra, tuple(p.shape))
        return torch.nn.functional.pad(p, (0, 0, 0, extra * prows // K))

    return qmap(pad_plane, qt)
