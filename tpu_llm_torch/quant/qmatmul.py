"""Fused dequant-matmul for packed q4_0 / q8_0 QTensors: the wrapper of the
CUDA kernel in ``csrc/qmatmul.cu`` and its plain PyTorch twin.

Replaces ``tpu_llm/quant/pallas_matmul.py::qmatmul_pallas`` for kinds
q4_0 and q8_0 with f32 scales. ``x (..., K) @ W (K, N) -> (..., N)``,
accumulated in f32 for f32 and bf16 activations alike — what the Pallas
kernel computes in interpret mode; the TPU's bf16 MXU pass is not copied.

``qmatmul`` takes the plain twin for CPU tensors and launches the kernel
for CUDA tensors, or raises; ``qmatmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from tpu_llm_torch.kernels import build
from tpu_llm_torch.quant.qtensor import QTensor, dequantize

_KIND_CODE = {"q4_0": 0, "q8_0": 1}
_SM_COUNT = 132          # H100 SXM; the grid aims at ~2 blocks an SM
_COLS_PER_BLOCK = 128    # csrc/qmatmul.cu kCols
_ROWS_PER_BLOCK = 8      # largest row tile of the kernel
_WARPS = 8               # K slices inside one block


def qmatmul_plain(x: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """Dequantize to f32 and multiply in f32."""
    *lead, K = x.shape
    w = dequantize(qt, torch.float32)
    out = x.reshape(-1, K).float() @ w
    return out.reshape(*lead, w.shape[1]).to(out_dtype or x.dtype)


def k_split(rows: int, K: int, N: int):
    """(ksplit, k-blocks per split) for the kernel grid: split K until the
    grid has about two blocks an SM, keeping >= 8 32-row blocks a split
    (one for each warp)."""
    blocks = math.ceil(N / _COLS_PER_BLOCK) * math.ceil(rows / _ROWS_PER_BLOCK)
    nkb = K // 32
    ks = max(1, min(nkb // _WARPS, math.ceil(2 * _SM_COUNT / blocks)))
    kbps = math.ceil(nkb / ks)
    return math.ceil(nkb / kbps), kbps


def qmatmul(x: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """x (..., K) f32 or bf16 @ qt (K, N) -> (..., N) in ``out_dtype``
    (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and qt.device.type == "cpu":
        return qmatmul_plain(x, qt, out_dtype)
    if x.device.type != "cuda" or x.device != qt.device:
        raise ValueError(f"x on {x.device}, weight on {qt.device}")
    if qt.kind not in _KIND_CODE or qt.scales.dtype != torch.float32:
        raise ValueError(f"qmatmul kernel takes q4_0/q8_0 with f32 scales, "
                         f"got {qt.kind} with {qt.scales.dtype} scales")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmatmul kernel takes f32/bf16, got {x.dtype} -> {out_dtype}")
    *lead, K = x.shape
    Kq, N = qt.shape
    if K != Kq or K % 32:
        raise ValueError(f"x (..., {K}) @ W ({Kq}, {N}): K must match and be a "
                         f"multiple of 32")
    if not (qt.q.is_contiguous() and qt.scales.is_contiguous()) \
            or qt.q.data_ptr() % 4 or qt.scales.data_ptr() % 16:
        raise ValueError("packed planes must be contiguous and aligned")
    x2 = x.reshape(-1, K).contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, N), dtype=out_dtype, device=x.device)
    ks, kbps = k_split(rows, K, N)
    partial = (torch.empty((ks, rows, N), dtype=torch.float32, device=x.device)
               if ks > 1 else None)
    code = build.lib().tlt_qmatmul(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), qt.q.data_ptr(),
        qt.scales.data_ptr(), _KIND_CODE[qt.kind], out.data_ptr(),
        int(out_dtype == torch.bfloat16),
        None if partial is None else partial.data_ptr(), rows, K, N, ks, kbps,
        build.stream_ptr(x.device))
    build.check(code, "qmatmul")
    qmatmul.launches += 1
    return out.reshape(*lead, N)


qmatmul.launches = 0
