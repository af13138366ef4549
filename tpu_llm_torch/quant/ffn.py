"""The SwiGLU FFN megakernel (K7): the wrapper of ``csrc/ffn.cu`` and its
plain PyTorch twin.

Replaces ``tpu_llm/quant/pallas_ffn.py::ffn_fused_pallas``: for at most 8
bf16 rows and q4_0 / q8_0 weights, ``h13 = x @ w13``,
``g = bf16(silu(h13[:, :F]) * h13[:, F:])`` (the gate in f32) and
``out = g @ w2``, accumulated in f32 and returned in x's dtype, in one
launch. The numerics are the Pallas kernel's bf16 ones: each scale is
rounded to bf16 and each dequantized weight ``v * s`` is rounded to bf16
before the f32 multiply-add. On the card the products run on K1's
tensor-core tile, the K splits of ``ffn_plan`` merged in the launch;
``ffn_fused_split_plain`` repeats that order of sums in plain PyTorch.

Opt-in, as in the JAX package: ``models/llama.py`` takes this path when
``TPU_LLM_FFN_MEGAKERNEL`` is set and ``ffn_ok`` holds. ``ffn_fused``
takes the plain twin for CPU tensors and launches the kernel for CUDA
tensors, or raises; ``ffn_fused.launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_llm_torch.kernels import build
from tpu_llm_torch.quant.qtensor import QTensor, unpack_q4

_KINDS = {"q4_0": 0, "q8_0": 1}
_PLANE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # csrc/qmm_tile.cuh Plane
COLS = 128               # columns a CTA (csrc/qmm_tile.cuh kCols)
GATE_COLS = COLS // 2    # gate (and up) columns of a w13 tile (csrc/ffn.cu kGate)
MIN_BLOCKS_PER_SPLIT = 4
MAX_ROWS = 8


def ffn_ok(w13, w2) -> bool:
    """The megakernel's semantic gates on the weights (``ffn_tiles_ok``
    without the TPU's VMEM tile shapes): both QTensors of one kind in
    {q4_0, q8_0}, 2-D, with f32 or bf16 scale planes."""
    if not isinstance(w13, QTensor) or not isinstance(w2, QTensor):
        return False
    if w13.kind != w2.kind or w13.kind not in _KINDS:
        return False
    if any(t.scales.dtype not in _PLANE_CODE for t in (w13, w2)):
        return False
    return w13.q.ndim == 2 and w2.q.ndim == 2


def _dequant_bf16(qt: QTensor) -> torch.Tensor:
    """round_bf16(v * round_bf16(scale)), the Pallas kernel's weight."""
    vals = unpack_q4(qt.q) if qt.kind == "q4_0" else qt.q
    s = torch.repeat_interleave(qt.scales.bfloat16(), 32, dim=0)
    return vals.bfloat16() * s


def _gate(h13: torch.Tensor, F: int) -> torch.Tensor:
    """g = bf16(silu(gate) * up), the gate in f32."""
    a, b = h13[:, :F], h13[:, F:]
    return (a * torch.sigmoid(a) * b).bfloat16()


def ffn_fused_plain(x: torch.Tensor, w13: QTensor, w2: QTensor) -> torch.Tensor:
    *lead, E = x.shape
    F = w13.shape[1] // 2
    h = x.reshape(-1, E).bfloat16().float() @ _dequant_bf16(w13).float()
    out = _gate(h, F).float() @ _dequant_bf16(w2).float()
    return out.reshape(*lead, w2.shape[1]).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    """The kernel's work, from shapes only (a captured graph replays it).
    Phase A: ``tiles_a`` tiles of GATE_COLS gate columns f and the up
    columns F + f (csrc/ffn.cu GateUpCols) x ``ks_a`` K splits of
    ``kbps_a`` 32-row blocks of E; phase B: ``tiles_b`` tiles of COLS columns of E x ``ks_b``
    splits of ``kbps_b`` blocks of F; ``grid`` CTAs, at most the co-resident
    ones, each looping over items ``blockIdx.x + i * grid``."""
    grid: int
    tiles_a: int
    ks_a: int
    kbps_a: int
    tiles_b: int
    ks_b: int
    kbps_b: int


def _split(tiles: int, nkb: int, ctas: int):
    """(ksplit, 32-row blocks a split): about one item a CTA, at least
    MIN_BLOCKS_PER_SPLIT blocks a split where K allows, no empty split."""
    ks = max(1, min(nkb // MIN_BLOCKS_PER_SPLIT, ctas // tiles))
    kbps = math.ceil(nkb / ks)
    return math.ceil(nkb / kbps), kbps


def ffn_plan(E: int, F: int, coresident: int) -> FfnPlan:
    """The plan of one launch over w13 (E, 2F) and w2 (F, E) on a card that
    holds ``coresident`` CTAs of the kernel at once."""
    tiles_a, tiles_b = math.ceil(F / GATE_COLS), math.ceil(E / COLS)
    ks_a, kbps_a = _split(tiles_a, E // 32, coresident)
    ks_b, kbps_b = _split(tiles_b, F // 32, coresident)
    grid = min(coresident, max(tiles_a * ks_a, tiles_b * ks_b))
    return FfnPlan(grid, tiles_a, ks_a, kbps_a, tiles_b, ks_b, kbps_b)


def ffn_fused_split_plain(x: torch.Tensor, w13: QTensor, w2: QTensor,
                          coresident: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (for the tests): the
    Pallas weights (``_dequant_bf16``); each K split of phase A in the
    ``ffn_plan`` of a card with ``coresident`` CTAs an f32 partial of x @
    w13 over its blocks, the partials summed in split order, the gate on
    the merged sums; phase B the same over g and w2."""
    *lead, E = x.shape
    F = w13.shape[1] // 2
    plan = ffn_plan(E, F, coresident)

    def split_sum(a, w, kbps):
        out = None
        for k0 in range(0, a.shape[1], 32 * kbps):
            part = a[:, k0:k0 + 32 * kbps] @ w[k0:k0 + 32 * kbps]
            out = part if out is None else out + part
        return out

    xf = x.reshape(-1, E).bfloat16().float()
    g = _gate(split_sum(xf, _dequant_bf16(w13).float(), plan.kbps_a), F)
    out = split_sum(g.float(), _dequant_bf16(w2).float(), plan.kbps_b)
    return out.reshape(*lead, E).to(x.dtype)


# per device, the kernel's int32 counters (the grid barrier's 2 words, then
# one a w13 tile and one a w2 tile), zero-filled when made and left zero by
# every launch; the newest, largest buffer last, the older ones kept for
# the graphs that captured them
_counters = {}
_coresident = {}


def _kernel_counters(device, n: int) -> torch.Tensor:
    bufs = _counters.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ffn_fused makes its counters at the first call of a shape: "
                               "call it once at that shape before a graph capture")
        bufs.append(torch.zeros(n, dtype=torch.int32, device=device))
    return bufs[-1]


def _coresident_ctas(lib, kind: int) -> int:
    """CTAs of the cooperative launch that fit at once (SMs x occupancy),
    asked once a kind."""
    if kind not in _coresident:
        _coresident[kind] = lib.tlt_ffn_grid(kind)
    return _coresident[kind]


def ffn_fused(x: torch.Tensor, w13: QTensor, w2: QTensor) -> torch.Tensor:
    """silu-gated FFN of x (..., E) bf16 with w13 (E, 2F), w2 (F, E). On the
    card its counters are made at the first call: make that call outside a
    graph capture, and launches on one device on one stream at a time."""
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
        if not (t.q.is_contiguous() and t.scales.is_contiguous()
                and t.q.data_ptr() % 16 == 0 and t.scales.data_ptr() % 16 == 0
                and tuple(t.scales.shape) == (t.shape[0] // 32, t.shape[1])):
            raise ValueError("ffn_fused: planes must be contiguous, on 16-byte "
                             "boundaries, scales in blocks of 32 rows")
    lib = build.lib()
    kind = _KINDS[w13.kind]
    ctas = _coresident_ctas(lib, kind)
    if ctas <= 0:
        raise RuntimeError("ffn_fused: the card takes no cooperative launch of this kernel")
    plan = ffn_plan(E, F, ctas)
    counters = _kernel_counters(x.device, 2 + plan.tiles_a + plan.tiles_b)
    x2 = x.reshape(rows, E).contiguous()
    if x2.data_ptr() % 16:                 # the kernel copies x in 16-byte chunks
        x2 = x2.clone()
    dev = x.device
    part_a = torch.empty((plan.ks_a, rows, plan.tiles_a * COLS), dtype=torch.float32,
                         device=dev)
    g = torch.empty((rows, F), dtype=torch.bfloat16, device=dev)
    part_b = torch.empty((plan.ks_b, rows, E), dtype=torch.float32, device=dev)
    out = torch.empty((rows, E), dtype=torch.bfloat16, device=dev)
    code = lib.tlt_ffn(
        x2.data_ptr(), w13.q.data_ptr(), w13.scales.data_ptr(),
        _PLANE_CODE[w13.scales.dtype], w2.q.data_ptr(), w2.scales.data_ptr(),
        _PLANE_CODE[w2.scales.dtype], kind, part_a.data_ptr(), g.data_ptr(),
        part_b.data_ptr(), out.data_ptr(), counters.data_ptr(), rows, E, F,
        plan.ks_a, plan.kbps_a, plan.ks_b, plan.kbps_b, plan.grid, build.stream_ptr(dev))
    build.check(code, "ffn_fused")
    ffn_fused.launches += 1
    return out.reshape(*lead, E)


ffn_fused.launches = 0
