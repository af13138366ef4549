"""The SwiGLU FFN megakernel (K7): the wrapper of ``csrc/ffn.cu`` and its
plain PyTorch twin.

Replaces ``tpu_llm/quant/pallas_ffn.py::ffn_fused_pallas``: for at most 8
bf16 rows and q4_0 / q8_0 weights, ``h13 = x @ w13``,
``g = bf16(silu(h13[:, :F]) * h13[:, F:])`` (the gate in f32) and
``out = g @ w2``, accumulated in f32 and returned in x's dtype, in one
launch. The numerics are the Pallas kernel's bf16 ones: each scale is
rounded to bf16 and each dequantized weight ``v * s`` is rounded to bf16
before the f32 multiply-add.

Opt-in, as in the JAX package: ``models/llama.py`` takes this path when
``TPU_LLM_FFN_MEGAKERNEL`` is set and ``ffn_ok`` holds. ``ffn_fused``
takes the plain twin for CPU tensors and launches the kernel for CUDA
tensors, or raises; ``ffn_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from tpu_llm_torch.kernels import build
from tpu_llm_torch.quant.qtensor import QTensor, unpack_q4

_KINDS = {"q4_0": 0, "q8_0": 1}
_COLS_PER_BLOCK = 128    # csrc/ffn.cu kCols
_WARPS = 8
MAX_ROWS = 8


def ffn_ok(w13, w2) -> bool:
    """The megakernel's semantic gates on the weights (``ffn_tiles_ok``
    without the TPU's VMEM tile shapes): both QTensors of one kind in
    {q4_0, q8_0}, 2-D, with f32 or bf16 scale planes."""
    if not isinstance(w13, QTensor) or not isinstance(w2, QTensor):
        return False
    if w13.kind != w2.kind or w13.kind not in _KINDS:
        return False
    if any(t.scales.dtype not in (torch.float32, torch.bfloat16) for t in (w13, w2)):
        return False
    return w13.q.ndim == 2 and w2.q.ndim == 2


def _dequant_bf16(qt: QTensor) -> torch.Tensor:
    """round_bf16(v * round_bf16(scale)), the Pallas kernel's weight."""
    vals = unpack_q4(qt.q) if qt.kind == "q4_0" else qt.q
    s = torch.repeat_interleave(qt.scales.bfloat16(), 32, dim=0)
    return vals.bfloat16() * s


def ffn_fused_plain(x: torch.Tensor, w13: QTensor, w2: QTensor) -> torch.Tensor:
    *lead, E = x.shape
    F = w13.shape[1] // 2
    h = x.reshape(-1, E).bfloat16().float() @ _dequant_bf16(w13).float()
    a, b = h[:, :F], h[:, F:]
    g = (a * torch.sigmoid(a) * b).bfloat16()
    out = g.float() @ _dequant_bf16(w2).float()
    return out.reshape(*lead, w2.shape[1]).to(x.dtype)


def _split(cols: int, nkb: int, grid: int):
    """(ksplit, 32-row blocks a split): about one tile a CTA, >= 8 blocks
    a split (one a warp) where K allows."""
    ks = max(1, min(max(1, nkb // _WARPS), math.ceil(grid / cols)))
    kbps = math.ceil(nkb / ks)
    return math.ceil(nkb / kbps), kbps


_barriers = {}
_grids = {}


def _grid(lib, kind: int, rows: int) -> int:
    """CTAs of the cooperative launch (occupancy x SMs), asked once."""
    if (kind, rows) not in _grids:
        _grids[kind, rows] = lib.tlt_ffn_grid(kind, rows)
    return _grids[kind, rows]


def _barrier(device) -> torch.Tensor:
    """Two zeroed words a device for the kernel's grid barrier; the kernel
    leaves them ready for the next launch."""
    if device not in _barriers:
        _barriers[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return _barriers[device]


def ffn_fused(x: torch.Tensor, w13: QTensor, w2: QTensor) -> torch.Tensor:
    """silu-gated FFN of x (..., E) bf16 with w13 (E, 2F), w2 (F, E)."""
    if x.device.type == "cpu" and w13.device.type == "cpu" and w2.device.type == "cpu":
        return ffn_fused_plain(x, w13, w2)
    if x.device.type != "cuda" or not x.device == w13.device == w2.device:
        raise ValueError(f"x on {x.device}, weights on {w13.device} / {w2.device}")
    if x.dtype != torch.bfloat16 or not ffn_ok(w13, w2):
        raise ValueError("ffn_fused kernel takes bf16 x and q4_0 / q8_0 weights of one "
                         "kind with f32 / bf16 scales")
    *lead, E = x.shape
    rows = math.prod(lead)
    E1, F2 = w13.shape
    F = F2 // 2
    if rows > MAX_ROWS or E1 != E or tuple(w2.shape) != (F, E) or E % 32 or F % 32 \
            or F2 != 2 * F:
        raise ValueError(f"ffn_fused: x (..., {E}) with {rows} rows, w13 {tuple(w13.shape)}, "
                         f"w2 {tuple(w2.shape)}: at most {MAX_ROWS} rows, E and F multiples "
                         f"of 32")
    for t in (w13, w2):
        s_align = 2 if t.scales.dtype == torch.bfloat16 else 4
        if not (t.q.is_contiguous() and t.scales.is_contiguous() and t.q.data_ptr() % 4 == 0
                and t.scales.data_ptr() % s_align == 0
                and tuple(t.scales.shape) == (t.shape[0] // 32, t.shape[1])):
            raise ValueError("ffn_fused: planes must be contiguous and aligned, "
                             "scales in blocks of 32 rows")
    lib = build.lib()
    kind = _KINDS[w13.kind]
    grid = _grid(lib, kind, rows)
    if grid <= 0:
        raise RuntimeError("ffn_fused: the card takes no cooperative launch of this kernel")
    ks_a, kbps_a = _split(math.ceil(F2 / _COLS_PER_BLOCK), E // 32, grid)
    ks_b, kbps_b = _split(math.ceil(E / _COLS_PER_BLOCK), F // 32, grid)
    x2 = x.reshape(rows, E).contiguous()
    dev = x.device
    part_a = torch.empty((ks_a, rows, F2), dtype=torch.float32, device=dev)
    g = torch.empty((rows, F), dtype=torch.bfloat16, device=dev)
    part_b = torch.empty((ks_b, rows, E), dtype=torch.float32, device=dev)
    out = torch.empty((rows, E), dtype=torch.bfloat16, device=dev)
    code = lib.tlt_ffn(
        x2.data_ptr(), w13.q.data_ptr(), w13.scales.data_ptr(),
        int(w13.scales.dtype == torch.bfloat16), w2.q.data_ptr(), w2.scales.data_ptr(),
        int(w2.scales.dtype == torch.bfloat16), kind, part_a.data_ptr(), g.data_ptr(),
        part_b.data_ptr(), out.data_ptr(), _barrier(dev).data_ptr(), rows, E, F,
        ks_a, kbps_a, ks_b, kbps_b, grid, build.stream_ptr(dev))
    build.check(code, "ffn_fused")
    ffn_fused.launches += 1
    return out.reshape(*lead, E)


ffn_fused.launches = 0
