"""Fused dequant-matmul for packed QTensors: the wrapper of the CUDA kernel
in ``csrc/qmatmul.cu`` and its plain PyTorch twin.

Replaces ``tpu_llm/quant/pallas_matmul.py::qmatmul_pallas`` for every kind
of ``_PALLAS_KINDS``, the ``--scan`` program's int4-plane q4_0i4 included,
with f32, bf16 or f16-bit (int16) scale (and mins) planes and the optional
``row_scale`` operand:
``(x * row_scale) (..., K) @ W (K, N) -> (..., N)``, with the affine mins
added as ``(block sums of x * row_scale) @ mins``, accumulated in f32 for
f32 and bf16 activations alike — what the Pallas kernel computes in
interpret mode; the TPU's bf16 MXU pass is not copied. Like the Pallas
kernel, ``x * row_scale`` stays f32 (it is not rounded back to x's dtype).

``qmatmul`` takes the plain twin for CPU tensors and launches the kernel
for CUDA tensors, or raises for a weight the kernel does not take (no
quiet dequantize); ``qmatmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_llm_torch.kernels import build
from tpu_llm_torch.quant.qtensor import PLANE_DTYPES, QTensor, dequantize

# kind -> (value plane: 0 int8, 1 nibble-packed, 2 nibble + qh plane;
#          offset subtracted from each unpacked value)
_KIND_CODE = {"q4_0": (1, 8), "q4_0i4": (1, 8), "q4_1": (1, 0), "q2_kp": (1, 0),
              "q3_kp": (1, 4), "q6_kp": (2, 32), "q8_0": (0, 0), "q5_0": (0, 0),
              "q5_1": (0, 0), "q2_k": (0, 0), "q3_k": (0, 0), "q6_k": (0, 0)}
# scale / mins plane dtype -> csrc/qmatmul.cu Plane code (int16: f16 bits)
_PLANE_CODE = {dt: i for i, dt in enumerate(PLANE_DTYPES)}
_COLS_PER_BLOCK = 128    # csrc/qmatmul.cu kCols
_ROWS_PER_BLOCK = 8      # largest row tile of the kernel
_WARPS = 8               # K slices inside one block


def qmatmul_plain(x: torch.Tensor, qt: QTensor, out_dtype=None,
                  row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize to f32 (mins included) and multiply in f32; ``row_scale``
    multiplies x in f32 first."""
    *lead, K = x.shape
    w = dequantize(qt, torch.float32)
    xf = x.reshape(-1, K).float()
    if row_scale is not None:
        xf = xf * row_scale.float()
    return (xf @ w).reshape(*lead, w.shape[1]).to(out_dtype or x.dtype)


def k_split(rows: int, K: int, N: int, sm_count: int):
    """(ksplit, k-blocks per split) for the kernel grid: split K until the
    grid has about two blocks on each of the card's ``sm_count`` SMs,
    keeping >= 8 32-row blocks a split (one for each warp)."""
    blocks = math.ceil(N / _COLS_PER_BLOCK) * math.ceil(rows / _ROWS_PER_BLOCK)
    nkb = K // 32
    ks = max(1, min(nkb // _WARPS, math.ceil(2 * sm_count / blocks)))
    kbps = math.ceil(nkb / ks)
    return math.ceil(nkb / kbps), kbps


_sm_counts = {}


def _sm_count(device: torch.device) -> int:
    """The card's SM count, asked once a device."""
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.is_contiguous() and t.data_ptr() % nbytes == 0


def _check_weight(qt: QTensor, K: int):
    """Raise ValueError if the kernel does not take this weight: (pack,
    value offset, block, plane dtype code) if it does."""
    if qt.kind not in _KIND_CODE or qt.scales.dtype not in _PLANE_CODE:
        raise ValueError(f"qmatmul kernel: {qt.kind} with {qt.scales.dtype} scales "
                         f"is not taken")
    Kq, N = qt.shape
    if K != Kq or K % 32:
        raise ValueError(f"x (..., {K}) @ W ({Kq}, {N}): K must match and be a "
                         f"multiple of 32")
    pack, voff = _KIND_CODE[qt.kind]
    block = K // qt.scales.shape[0]
    if block not in (16, 32) or (pack == 2 and block != 16) or \
            tuple(qt.scales.shape) != (K // block, N):
        raise ValueError(f"qmatmul kernel: {qt.kind} scales {tuple(qt.scales.shape)} "
                         f"for K={K}: blocks of 16 or 32 rows (q6_kp: 16)")
    # 4 plane elements a vector load: 16 bytes of f32, 8 of bf16 / f16 bits
    plane_align = 4 * qt.scales.element_size()
    if pack == 2:
        ok = qt.mins is not None and qt.mins.dtype == torch.uint8 and \
            tuple(qt.mins.shape) == (K // 4, N) and _aligned(qt.mins, 4)
    elif qt.mins is not None:
        ok = qt.mins.dtype == qt.scales.dtype and qt.mins.shape == qt.scales.shape \
            and _aligned(qt.mins, plane_align)
    else:
        ok = True
    if not (ok and _aligned(qt.q, 4) and _aligned(qt.scales, plane_align)):
        raise ValueError(f"qmatmul kernel: {qt.kind} planes must be contiguous, "
                         f"aligned and of matching shapes and dtypes")
    return pack, voff, block, _PLANE_CODE[qt.scales.dtype]


def qmatmul(x: torch.Tensor, qt: QTensor, out_dtype=None,
            row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(x * row_scale) (..., K) f32 or bf16 @ qt (K, N) -> (..., N) in
    ``out_dtype`` (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and qt.device.type == "cpu":
        return qmatmul_plain(x, qt, out_dtype, row_scale)
    if x.device.type != "cuda" or x.device != qt.device or \
            (row_scale is not None and row_scale.device != x.device):
        raise ValueError(f"x on {x.device}, weight on {qt.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qmatmul kernel takes f32/bf16, got {x.dtype} -> {out_dtype}")
    *lead, K = x.shape
    pack, voff, block, plane = _check_weight(qt, K)
    N = qt.shape[1]
    if row_scale is not None:
        if tuple(row_scale.shape) != (K,):
            raise ValueError(f"row_scale {tuple(row_scale.shape)} for K={K}")
        row_scale = row_scale.float().contiguous()
    x2 = x.reshape(-1, K).contiguous()
    rows = x2.shape[0]
    out = torch.empty((rows, N), dtype=out_dtype, device=x.device)
    ks, kbps = k_split(rows, K, N, _sm_count(x.device))
    partial = (torch.empty((ks, rows, N), dtype=torch.float32, device=x.device)
               if ks > 1 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = build.lib().tlt_qmatmul(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), ptr(row_scale), qt.q.data_ptr(),
        ptr(qt.mins) if pack == 2 else None, qt.scales.data_ptr(),
        None if pack == 2 else ptr(qt.mins), plane, pack, voff, block,
        out.data_ptr(), int(out_dtype == torch.bfloat16), ptr(partial), rows, K, N,
        ks, kbps, build.stream_ptr(x.device))
    build.check(code, "qmatmul")
    qmatmul.launches += 1
    return out.reshape(*lead, N)


qmatmul.launches = 0
