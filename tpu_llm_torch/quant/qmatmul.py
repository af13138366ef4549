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
quiet dequantize); ``qmatmul.launches`` counts kernel launches. On the
card every row count is one launch of one tensor-core body (values exact
in bf16, scales on the f32 accumulators, f32 x' in three bf16 parts, the
K split merged in the launch); ``qmatmul_blocked_plain`` repeats that
arithmetic in plain PyTorch for the tests.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_llm_torch.kernels import build
from tpu_llm_torch.quant.qtensor import (PLANE_DTYPES, QTensor, dequantize, qvalues,
                                         unpack_scales_f16)

# kind -> (value plane: 0 int8, 1 nibble-packed, 2 nibble + qh plane;
#          offset subtracted from each unpacked value)
_KIND_CODE = {"q4_0": (1, 8), "q4_0i4": (1, 8), "q4_1": (1, 0), "q2_kp": (1, 0),
              "q3_kp": (1, 4), "q6_kp": (2, 32), "q8_0": (0, 0), "q5_0": (0, 0),
              "q5_1": (0, 0), "q2_k": (0, 0), "q3_k": (0, 0), "q6_k": (0, 0)}
# scale / mins plane dtype -> csrc/qmatmul.cu Plane code (int16: f16 bits)
_PLANE_CODE = {dt: i for i, dt in enumerate(PLANE_DTYPES)}
_COLS_PER_BLOCK = 128    # csrc/qmatmul.cu kCols
_TARGET_CTAS_PER_SM = 4  # the K split fills the card to about this
_MIN_BLOCKS_PER_SPLIT = 4


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


def split3_bf16(x: torch.Tensor):
    """f32 ``x`` as hi + mid + lo, three bf16-valued f32 tensors holding
    all 24 bits (csrc/common.cuh split3_bf16)."""
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def qmatmul_blocked_plain(x: torch.Tensor, qt: QTensor, out_dtype=None,
                          row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (for the tests): x' = x *
    row_scale in f32, as one bf16 part (bf16 x, no row_scale: exact) or
    three (hi + mid + lo); per k16 step the dot products of the parts with
    the integer values, summed in f32; those sums (two steps a block for
    per-32 kinds) times their column's scale, added over the blocks; the
    mins as (block sums of x') @ mins."""
    *lead, K = x.shape
    vals, affine = qvalues(qt)
    vals = vals.float()
    N = vals.shape[1]
    xf = x.reshape(-1, K).float()
    if row_scale is not None:
        xf = xf * row_scale.float()
    one_part = x.dtype == torch.bfloat16 and row_scale is None
    parts = (xf,) if one_part else split3_bf16(xf)
    R = xf.shape[0]
    sums = sum(torch.einsum("rjk,jkn->rjn", p.reshape(R, K // 16, 16),
                            vals.reshape(K // 16, 16, N)) for p in parts)
    block = K // qt.scales.shape[0]
    if block == 32:
        sums = sums.reshape(R, K // 32, 2, N).sum(dim=2)
    out = (sums * unpack_scales_f16(qt.scales)[None]).sum(dim=1)
    if affine:
        xs = xf.reshape(R, K // block, block).sum(dim=-1)
        out = out + xs @ unpack_scales_f16(qt.mins)
    return out.reshape(*lead, N).to(out_dtype or x.dtype)


def k_split(rows: int, K: int, N: int, sm_count: int):
    """(ksplit, k-blocks per split) for the kernel grid, from shapes only
    (a captured graph replays it): split K until the grid holds about
    ``_TARGET_CTAS_PER_SM`` CTAs on each of the card's ``sm_count`` SMs,
    keeping >= ``_MIN_BLOCKS_PER_SPLIT`` 32-row blocks a split."""
    tiles = math.ceil(N / _COLS_PER_BLOCK) * math.ceil(rows / row_tile(rows))
    nkb = K // 32
    ks = max(1, min(nkb // _MIN_BLOCKS_PER_SPLIT,
                    math.ceil(_TARGET_CTAS_PER_SM * sm_count / tiles)))
    kbps = math.ceil(nkb / ks)
    return math.ceil(nkb / kbps), kbps


def row_tile(rows: int) -> int:
    """Rows a CTA takes (csrc/qmatmul.cu): one m16 tile up to 16 rows,
    else 64; the row count is tiled rounding up."""
    return 16 if rows <= 16 else 64


# one int32 per output tile of a K-split launch, a buffer per device,
# zero-filled at the first call: each launch leaves them at 0 (the last
# split of a tile resets its counter), so launches on one stream and CUDA
# graph replays share them. k_split splits K only while the grid has fewer
# than _TARGET_CTAS_PER_SM * SMs tiles, far fewer than TILE_COUNTERS
TILE_COUNTERS = 1 << 16
_tile_counters = {}


def _counters(device) -> torch.Tensor:
    counters = _tile_counters.get(device)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("qmatmul makes its tile counters at its first call: "
                               "call it once before a graph capture")
        counters = torch.zeros(TILE_COUNTERS, dtype=torch.int32, device=device)
        _tile_counters[device] = counters
    return counters


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
    if x2.data_ptr() % 16:                 # the kernel copies x in 16-byte chunks
        x2 = x2.clone()
    rows = x2.shape[0]
    out = torch.empty((rows, N), dtype=out_dtype, device=x.device)
    ks, kbps = k_split(rows, K, N, _sm_count(x.device))
    counters = _counters(x.device)
    partial = None
    if ks > 1:
        partial = torch.empty((ks, rows, N), dtype=torch.float32, device=x.device)
    qh = qt.mins if pack == 2 else None
    mins = None if pack == 2 else qt.mins
    vec = N % 16 == 0 and all(t is None or t.data_ptr() % 16 == 0
                              for t in (qt.q, qh, qt.scales, mins))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = build.lib().tlt_qmatmul(
        x2.data_ptr(), int(x2.dtype == torch.bfloat16), ptr(row_scale), qt.q.data_ptr(),
        ptr(qh), qt.scales.data_ptr(), ptr(mins), plane, pack, voff, block,
        out.data_ptr(), int(out_dtype == torch.bfloat16), ptr(partial), counters.data_ptr(),
        rows, K, N, ks, kbps, int(vec), build.stream_ptr(x.device))
    build.check(code, "qmatmul")
    qmatmul.launches += 1
    return out.reshape(*lead, N)


qmatmul.launches = 0
