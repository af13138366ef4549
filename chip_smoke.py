#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_llm_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and the CUDA
toolkit (nvcc); without a card, or outside a checkout, it exits non-zero
and prints no result. It imports nothing of JAX or of the JAX package.

Phases, one JSON line each:
1. device — the card (nvidia-smi name and power limit), CUDA version, and
   the build of every kernel from tpu_llm_torch/csrc (one nvcc a source,
   all started together).
2. kernels — each hand-written kernel against its plain PyTorch twin on
   the card at the main path's shapes (TinyLlama-1.1B widths): error
   against a stated tolerance (f32 inputs: 1e-3 * max|plain|; bf16:
   2e-2 * max|plain|) and the number of outputs that differ from the
   twin's at all (n_diff of n_out), kernel / plain / library times (CUDA
   events, L2 flushed before every launch, median), and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type, whichever is larger).
   The paged decode kernels (K5, K6) run at serving shapes (batch 8, 32/4
   heads, 1024-row tables, shuffled blocks, positions 15-1023) and at
   batch 1 (one live request at position 1000), and again with every
   block past pos // BS and block 0 poisoned (NaN): the output must not
   change; each case reports its split count and the kernels one call
   launches (the profiler's count; more than one fails). K2 (split over
   the sequence) and K4 (tensor cores) run at the shapes the
   `llm` CLI gives them (bf16 q over its f32
   2048-row cache: K2 at positions 15, 1000, 2047; K4 at T 512, offset
   0), and again at the shapes serving gives them (bf16 q over bf16
   planes: K2 at batch 8 with positions 15-1023, K4 over one slot's
   1024-row view at offset 256 and 0); the kernels line reports the
   serving case and, as `cli_case`, the CLI's; K4 also runs f32 q (the
   CLI's --dtype f32, three bf16 parts on the tensor cores) over the CLI's
   f32 cache and over a bf16 one (--cache-dtype bf16), T 512, beside f32
   SDPA, reported as `f32_q_case` and `f32_q_bf16_cache_case`. K1 runs for q4_0 and
   q8_0 (f32 planes) at every projection and for every other kind (q4_1,
   q5_0, q5_1, q2_k, q2_kp, q3_k, q3_kp, q6_k, q6_kp; f32 and bf16 planes;
   random planes in each kind's range) at w13 and wcls, 1 and 8 rows (with
   row_scale at w13, 8 rows); the default K-quant layouts (q4_1 and q6_k
   with bf16 planes: what Q4_K and Q6_K load as) at all five shapes. K1's
   library time is torch._weight_int4pack_mm (q4_0, and q4_1 through its
   zero point; at every row count, the 512-row prefill case included: the
   kernels line reports it as `prefill_case`, and the 5-row verify window
   as `verify_window_case`). K1 on the --scan program's q4_0i4 (to_int4 of q4_0 at
   every projection, of q4_1 / q3_kp / q2_kp at w13; f32, bf16 and
   f16-bit int16 planes; 1 and 8 rows), and at the 5 rows of a k = 4
   verify window (q4_0 and its q4_0i4, every projection). K3 again on
   bench.py's bf16 (1, 1024, 256) cache at positions 16, 340 and 655. K7
   (the FFN megakernel, on K1's tensor-core tile) runs for q4_0 and q8_0
   at 1 and 8 rows, timed beside the unfused path it replaces.
3. cli — the port's `llm` CLI on tiny GGUFs written here with the port's
   own writer (f32 and Q4_0 with --dtype f32 and native; Q4_K and Q6_K
   native; Q4_K native --fold-norms; Q4_0 native with
   TPU_LLM_FFN_MEGAKERNEL set), on the card and on the CPU: the greedy
   text must be identical, and the card runs must launch K1 (and K7).
   Phase scan_cli: --scan (the captured CUDA graph), --spec 3, --scan
   --spec 3 and --spec 3 --draft on a tiny Q4_0 file with the bigram bias,
   and --scan on a tiny Q8_0 file with TPU_LLM_FFN_MEGAKERNEL set (K7
   replayed inside the graph), card against CPU.
4. serve_cli — the port's `llm-serve` on the tiny f32 GGUF and, native,
   the tiny Q4_K and Q6_K ones: dense, --paged and --paged --cache-dtype
   int8, on the card and on the CPU: the same completions.
5. full width — a TinyLlama-1.1B-shaped Q4_0 model (22 layers, ~0.65 GB
   packed) from seeded random weights built on the card, entered at
   Engine.generate: a 16-token prompt + 128 greedy tokens, a 512-token
   prompt (flash prefill), the first-step logits of the kernel path held
   against the plain path, and 128 steps of decode_step(defer_kv=True).
6. serve full width — the same model served by PagedEngine (bf16 pools,
   block 16; int8 pools, block 32) and the dense BatchEngine (bf16 cache):
   batch 8, max_seq 1024, 16 requests (8 sharing a 256-token prefix with
   32-200-token tails, 8 distinct prompts of 64-512 tokens), 128 greedy
   tokens each; throughput, TTFT, prefix hits, blocks in use, launches and
   the device-busy share of 16 profiled engine steps, with the device ms
   and launches a step of K5 / K6 (`paged_decode`) and of every attention
   kernel (`attention`); one batched decode step's logits held against
   the plain path.
7. megakernel — the phase-5 model with TPU_LLM_FFN_MEGAKERNEL set:
   Engine.generate (16 + 128), one decode step's launches (22 ffn_fused),
   a decode step's logits and the dense BatchEngine's batch-8 decode
   logits held against the plain path, 48 decode steps timed with the
   switch off, on, on, off, and 16 profiled decode steps with the switch
   on and off (device ms a step, K7's and K1's share of it).
7b. f32 full width — TinyLlama-1.1B width and depth with dense f32
   weights from seed 9 (what `llm --dtype f32 --cache-dtype f32` loads),
   TF32 off: a 512-token prompt through Engine.generate (TTFT; K4 takes
   the prefill, 22 launches), the prefill profiled (K4's device ms), and
   the first-token logits held against the plain path at 1e-3 *
   max|logit| (the bf16 paths' logits: 2e-2).
8. scan full width — the phase-5 model: the step loop and
   Engine.generate(use_scan=True) (16 + 128 greedy, f32 cache) give equal
   tokens; bench.py's program (decode_step(defer_kv=True), bf16 cache of
   1024 rows, prompt_len 16) over unpack_params_int4 with pack_scales
   none / f16 / bf16, captured 8 steps a graph and slope-timed at 128 and
   640 steps, one step's logits held against the plain path, and
   profiled over 16 steps at positions 336-351; the device
   busy share over 16 replayed steps (profiled, and the profiled device
   time over the same replays' unprofiled wall time) beside 16 steps of
   the step loop; speculation with k = 4 on a repetitive prompt (host
   and device loops, equal to the plain stream: tokens per verify forward,
   host reads per forward); the --timings buckets over the q4_0 and the
   int4-plane weights. A replay adds the
   launches its graph recorded to each kernel's count.
9. kquant full width — TinyLlama-1.1B width and depth in each K-quant's
   default layout (Q4_K as q4_1, Q6_K as q6_k, Q5_K as q5_1, Q3_K as
   q3_kp, Q2_K as q2_kp; bf16 planes), random planes built on the card:
   Engine.generate (16 + 128, bf16 activations), one decode step's
   launches, and the first-step logits (f32 activations) held against the
   plain path.
Each main-path run starts with every launch count at 0 and reads the
counts after; a kernel of the path that never launched fails the run.

The last lines: the card's name and power limit, the kernels JSON, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}   # f32 outside the tensor cores; bf16 dense
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


T0 = time.perf_counter()


def emit(phase: str, **kw):
    """One JSON line; ``t_s`` is the time since the script started."""
    print(json.dumps({"phase": phase, **kw, "t_s": round(time.perf_counter() - T0, 2)}),
          flush=True)


# -- timing and bounds -------------------------------------------------------

class Timer:
    """Median kernel time over launches, each after an L2 flush (the
    decode path streams > 0.6 GB a step, so its kernels find L2 cold) and
    a GPU spin that hides the host's enqueue time from the event pair."""

    def __init__(self, torch, iters: int = 15):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(self.iters)]
        for a, b in ev:
            self.flush.zero_()
            # keep the card busy while the host enqueues fn, so the start
            # event does not fire before the kernel is queued
            torch.cuda._sleep(1_000_000)
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# value range of each QTensor kind (before its scale), and the nibble range
# of the packed kinds (q6_kp: the low nibble; its qh plane adds 2 bits)
KIND_VALUES = {"q4_0": (-8, 7), "q4_1": (0, 15), "q2_kp": (0, 3), "q3_kp": (-4, 3),
               "q6_kp": (-32, 31), "q8_0": (-127, 127), "q5_0": (-16, 15), "q5_1": (0, 31),
               "q2_k": (0, 3), "q3_k": (-4, 3), "q6_k": (-32, 31)}
NIBBLE_MAX = {"q4_0": 15, "q4_1": 15, "q2_kp": 3, "q3_kp": 7, "q6_kp": 15}
AFFINE = ("q4_1", "q5_1", "q2_k", "q2_kp")
NEW_KINDS = ("q4_1", "q5_0", "q5_1", "q2_k", "q2_kp", "q3_k", "q3_kp", "q6_k", "q6_kp")
# what GGUF Q4_K and Q6_K load as by default (bf16 folded planes)
DEFAULT_KQ = ("q4_1", "q6_k")
BLOCK16 = ("q2_k", "q2_kp", "q3_k", "q3_kp", "q6_k", "q6_kp")
INT4_PLANES = ("f32", "bf16", "int16")
# bench.py's program: cache rows, prompt length, the two slope-timed runs
BENCH_MAX_SEQ, BENCH_PROMPT, BENCH_STEPS = 1024, 16, (128, 640)
SPEC_K = 4             # draft tokens a verify window at full width


def random_qtensor(torch, g, kind: str, K: int, N: int, planes: str = "f32",
                   device: str = "cuda"):
    """A (K, N) QTensor of ``kind`` with random planes drawn on ``device``
    from ``g``: values uniform over the kind's range, per-block scales
    (f32 or bf16 ``planes``) giving weights of std ~0.025 (what Q4_0 with
    scales in [0.001, 0.01] gives), affine mins centring the values."""
    from tpu_llm_torch.quant.qtensor import QTensor

    def ints(lo, hi, shape):
        return torch.randint(lo, hi + 1, shape, generator=g, device=device, dtype=torch.int32)

    lo, hi = KIND_VALUES[kind]
    if kind in NIBBLE_MAX:
        m = NIBBLE_MAX[kind]
        q = (ints(0, m, (K // 2, N)) | (ints(0, m, (K // 2, N)) << 4)).to(torch.uint8)
    else:
        q = ints(lo, hi, (K, N)).to(torch.int8)
    block = 16 if kind in BLOCK16 else 32
    std_v = (hi - lo + 1) / 12 ** 0.5
    s = (torch.rand((K // block, N), generator=g, device=device) * 1.8 + 0.2) * (0.025 / std_v)
    mins = None
    if kind in AFFINE:
        mins = -0.5 * (lo + hi) * s
    elif kind == "q6_kp":
        mins = ints(0, 255, (K // 4, N)).to(torch.uint8)        # the qh plane
    if planes == "bf16":
        s = s.bfloat16()
        mins = mins.bfloat16() if kind in AFFINE else mins
    return QTensor(q, s, kind, mins)


def int4_weight(torch, g, src: str, K: int, N: int, planes: str):
    """A random ``src`` weight through to_int4 (the --scan program's q4_0i4),
    its planes f32, bf16 or f16 bits in int16."""
    from tpu_llm_torch.quant.qtensor import pack_scales_bf16, pack_scales_f16, to_int4

    w = to_int4(random_qtensor(torch, g, src, K, N, "f32"))
    return {"f32": w, "bf16": pack_scales_bf16(w), "int16": pack_scales_f16(w)}[planes]


# -- phase 2: kernels against their plain twins ---------------------------------

def check_kernels(torch, timer):
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.quant.qmatmul import qmatmul, qmatmul_plain
    from tpu_llm_torch.quant.qtensor import QTensor

    F = torch.nn.functional
    dev = "cuda"
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    cases = {"qmatmul": [], "flash_decode_attention": [], "flash_decode_fused": [],
             "flash_gqa_attention": [], "ffn_fused": []}

    n_diff = {}

    def compare(name, got, want, bf16: bool, **info):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {info}: non-finite output")
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        tol = (2e-2 if bf16 else 1e-3) * ref
        if not err <= tol:
            fail(f"{name} {info}: max abs err {err} > tolerance {tol}")
        # outputs that differ from the twin's at all (in bf16: rounding flips)
        n_diff[name] = dict(n_diff=int((got != want).sum().item()), n_out=got.numel())
        return err, tol

    def record(name, info, err, tol, ms, plain_ms, lib_ms, bmoved, ops, kind):
        b_ms, b_by = bound(bmoved, ops, kind)
        row = dict(info, **n_diff[name], max_abs_err=err, tol=tol, kernel_ms=ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        cases[name].append(row)
        emit("kernel", name=name, **row)

    # K1: every projection of a TinyLlama layer and the classifier, decode
    # rows 1 and 8, plus prefill rows 512 on w13
    shapes = {"wqkv": (2048, 2560), "wo": (2048, 2048), "w13": (2048, 11264),
              "w2": (5632, 2048), "wcls": (2048, 32000)}
    # (q4_0 / q8_0 with f32 planes; then every other kind at w13 and wcls
    # with f32 and bf16 planes, and the two default K-quant layouts — what
    # Q4_K and Q6_K load as — over all five shapes; row_scale on w13 at 8 rows)
    runs = [(n, kn, "f32", r) for kn in ("q4_0", "q8_0") for n in shapes for r in (1, 8)]
    runs += [("w13", kn, "f32", 512) for kn in ("q4_0", "q8_0")]
    runs += [(n, kn, pl, r) for kn in NEW_KINDS for pl in ("f32", "bf16")
             for n in ("w13", "wcls") for r in (1, 8)]
    runs += [(n, kn, "bf16", r) for kn in DEFAULT_KQ for n in ("wqkv", "wo", "w2")
             for r in (1, 8)]
    # the --scan program's int4-plane weights (to_int4): from q4_0 at every
    # projection, from q4_1 (mins) and q3_kp / q2_kp (blocks of 16) at w13;
    # f32, bf16 and f16-bit (int16) planes
    runs += [(n, "q4_0i4<q4_0", pl, r) for pl in INT4_PLANES for n in shapes for r in (1, 8)]
    runs += [("w13", f"q4_0i4<{src}", pl, r) for src in ("q4_1", "q3_kp", "q2_kp")
             for pl in INT4_PLANES for r in (1, 8)]
    # the k = 4 verify window of speculation (5 rows): host loop on q4_0,
    # device loop on its q4_0i4 conversion with f32 planes
    runs += [(n, kn, "f32", SPEC_K + 1) for kn in ("q4_0", "q4_0i4<q4_0") for n in shapes]
    for wname, kind, planes, rows in runs:
        K, N = shapes[wname]
        if kind.startswith("q4_0i4<"):
            w = int4_weight(torch, g, kind.split("<")[1], K, N, planes)
        else:
            w = random_qtensor(torch, g, kind, K, N, planes)
        x = torch.randn((rows, K), generator=g, device=dev).bfloat16()
        rs = None
        if kind not in ("q4_0", "q8_0") and wname == "w13" and rows == 8:
            rs = 1 + 0.2 * torch.randn(K, generator=g, device=dev)
        out_dtype = torch.float32 if wname == "wcls" else torch.bfloat16
        got = qmatmul(x, w, out_dtype=out_dtype, row_scale=rs)
        want = qmatmul_plain(x, w, out_dtype=out_dtype, row_scale=rs)
        info = dict(weight=wname, kind=kind, planes=planes, rows=rows, K=K, N=N, x="bf16",
                    out=str(out_dtype).replace("torch.", ""), row_scale=rs is not None)
        err, tol = compare("qmatmul", got, want, True, **info)
        ms = timer.ms(lambda: qmatmul(x, w, out_dtype=out_dtype, row_scale=rs))
        plain_ms = timer.ms(lambda: qmatmul_plain(x, w, out_dtype=out_dtype, row_scale=rs))
        lib_ms = None
        if (kind in ("q4_0", "q4_1") or w.kind == "q4_0i4" and K // w.scales.shape[0] == 32) \
                and rs is None:
            lib_ms = int4pack_ms(torch, timer, x, w, want, info)
        record("qmatmul", info, err, tol, ms, plain_ms, lib_ms,
               w.nbytes + nbytes(x) + rows * N * got.element_size()
               + (0 if rs is None else nbytes(rs)),
               2.0 * rows * K * N, "bf16")
        del w
    check_ffn_kernel(torch, timer, g, compare, record)

    # K2 / K3: TinyLlama decode attention, batch 1, S = 2048, bf16 q,
    # f32 cache (the CLI's default cache dtype)
    B, H, Hkv, D, S = 1, 32, 4, 64, 2048
    kc = torch.randn((B, S, Hkv * D), generator=g, device=dev)
    vc = torch.randn((B, S, Hkv * D), generator=g, device=dev)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
    k_cur = torch.randn((B, 1, Hkv * D), generator=g, device=dev).bfloat16()
    v_cur = torch.randn((B, 1, Hkv * D), generator=g, device=dev).bfloat16()
    it = kc.element_size()

    def sdpa(kc, vc, n_keys):
        # one library call over the same cache rows (GQA, no mask needed:
        # every row < n_keys is visible to the one query)
        S = kc.shape[1]
        k4 = kc.view(B, S, Hkv, D)[:, :n_keys].transpose(1, 2)
        v4 = vc.view(B, S, Hkv, D)[:, :n_keys].transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q.to(kc.dtype).transpose(1, 2), k4, v4, enable_gqa=True)

    def check_fused(kc, vc, pos, cache):
        S, it = kc.shape[1], kc.element_size()
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, pos=pos, q="bf16", cache=cache)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got, _, _ = FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)
        want, _, _ = FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)
        err, tol = compare("flash_decode_fused", got, want, True, **info)
        for new, old, cur in ((k1, kc, k_cur), (v1, vc, v_cur)):
            if not torch.equal(new[:, pos], cur[:, 0].to(kc.dtype)):
                fail(f"flash_decode_fused {info}: row pos is not this step's k/v")
            rest = torch.ones(S, dtype=torch.bool, device=dev)
            rest[pos] = False
            if not torch.equal(new[:, rest], old[:, rest]):
                fail(f"flash_decode_fused {info}: a row other than pos changed")
        record("flash_decode_fused", info, err, tol,
               timer.ms(lambda: FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)),
               timer.ms(lambda: FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)),
               timer.ms(sdpa(kc, vc, pos + 1)),
               nbytes(q) * 2 + 2 * B * pos * Hkv * D * it + nbytes(k_cur, v_cur)
               + 2 * Hkv * D * it,
               4.0 * B * H * (pos + 1) * D, "f32")

    for pos in (15, 1000, 2047):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, pos=pos, q="bf16", cache="f32")
        got = FA.flash_decode_attention(q, kc, vc, p)
        err, tol = compare("flash_decode_attention", got,
                           FA.flash_decode_attention_plain(q, kc, vc, p), True, **info)
        record("flash_decode_attention", info, err, tol,
               timer.ms(lambda: FA.flash_decode_attention(q, kc, vc, p)),
               timer.ms(lambda: FA.flash_decode_attention_plain(q, kc, vc, p)),
               timer.ms(sdpa(kc, vc, pos + 1)),
               nbytes(q) * 2 + 2 * B * (pos + 1) * Hkv * D * it,
               4.0 * B * H * (pos + 1) * D, "f32")
        check_fused(kc, vc, pos, "f32")
    # K3 as bench.py's program runs it: a bf16 (1, 1024, 256) cache, the
    # positions 16-655 of its 640-step run
    kb = torch.randn((B, BENCH_MAX_SEQ, Hkv * D), generator=g, device=dev).bfloat16()
    vb = torch.randn((B, BENCH_MAX_SEQ, Hkv * D), generator=g, device=dev).bfloat16()
    for pos in (BENCH_PROMPT, 340, BENCH_PROMPT + BENCH_STEPS[1] - 1):
        check_fused(kb, vb, pos, "bf16")

    # K4: a 512-token prompt against a 2048-row cache, offset 0
    T = 512
    qp = torch.randn((B, T, H, D), generator=g, device=dev).bfloat16()
    k4 = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    v4 = torch.randn((B, S, Hkv, D), generator=g, device=dev)
    info = dict(B=B, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=0, q="bf16", cache="f32")
    got = FA.flash_gqa_attention(qp, k4, v4, 0)
    err, tol = compare("flash_gqa_attention", got,
                       FA.flash_gqa_attention_plain(qp, k4, v4, 0), True, **info)
    qf = qp.float().transpose(1, 2)
    kt, vt = k4[:, :T].transpose(1, 2), v4[:, :T].transpose(1, 2)
    record("flash_gqa_attention", info, err, tol,
           timer.ms(lambda: FA.flash_gqa_attention(qp, k4, v4, 0)),
           timer.ms(lambda: FA.flash_gqa_attention_plain(qp, k4, v4, 0)),
           timer.ms(lambda: F.scaled_dot_product_attention(
               qf, kt, vt, is_causal=True, enable_gqa=True)),
           nbytes(qp) * 2 + 2 * B * T * Hkv * D * it,
           4.0 * B * H * D * T * (T + 1) / 2, "f32")
    # f32 q (the `llm` CLI's --dtype f32) over the same f32 cache, f32 SDPA
    # beside it
    qf32 = qp.float()
    info = dict(B=B, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=0, q="f32", cache="f32")
    got = FA.flash_gqa_attention(qf32, k4, v4, 0)
    err, tol = compare("flash_gqa_attention", got,
                       FA.flash_gqa_attention_plain(qf32, k4, v4, 0), False, **info)
    record("flash_gqa_attention", info, err, tol,
           timer.ms(lambda: FA.flash_gqa_attention(qf32, k4, v4, 0)),
           timer.ms(lambda: FA.flash_gqa_attention_plain(qf32, k4, v4, 0)),
           timer.ms(lambda: F.scaled_dot_product_attention(
               qf, kt, vt, is_causal=True, enable_gqa=True)),
           nbytes(qf32) * 2 + 2 * B * T * Hkv * D * it,
           4.0 * B * H * D * T * (T + 1) / 2, "f32")
    # f32 q over a bf16 cache of the same shape (--dtype f32 --cache-dtype
    # bf16): f32 SDPA over the same rows widened to f32 beside it
    kb4, vb4 = k4.bfloat16(), v4.bfloat16()
    info = dict(B=B, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=0, q="f32", cache="bf16")
    got = FA.flash_gqa_attention(qf32, kb4, vb4, 0)
    err, tol = compare("flash_gqa_attention", got,
                       FA.flash_gqa_attention_plain(qf32, kb4, vb4, 0), False, **info)
    kbt, vbt = (c[:, :T].float().transpose(1, 2) for c in (kb4, vb4))
    record("flash_gqa_attention", info, err, tol,
           timer.ms(lambda: FA.flash_gqa_attention(qf32, kb4, vb4, 0)),
           timer.ms(lambda: FA.flash_gqa_attention_plain(qf32, kb4, vb4, 0)),
           timer.ms(lambda: F.scaled_dot_product_attention(
               qf, kbt, vbt, is_causal=True, enable_gqa=True)),
           nbytes(qf32) * 2 + 2 * B * T * Hkv * D * kb4.element_size(),
           4.0 * B * H * D * T * (T + 1) / 2, "f32")
    check_serving_shapes(torch, timer, g, compare, record)
    check_paged_kernels(torch, timer, g, compare, record, cases)
    return cases


def check_serving_shapes(torch, timer, g, compare, record):
    """K2 and K4 at the shapes serving gives them, bf16 q over bf16 cache
    planes: K2 as the dense BatchEngine's decode (batch 8, a (8, 1024,
    256) cache, ragged positions PAGED_POS); K4 as PagedEngine's prefill
    over the gathered (1, 1024, 4, 64) view of one slot (a 256-token tail
    after a 256-token prefix hit at offset 256, and a 512-token prompt at
    offset 0)."""
    from tpu_llm_torch.ops import flash_attention as FA

    F = torch.nn.functional
    dev, bf = "cuda", torch.bfloat16
    H, Hkv, D, S = 32, 4, 64, 1024
    it = 2

    B = len(PAGED_POS)
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device=dev)
    kc, vc = (torch.randn((B, S, Hkv * D), generator=g, device=dev).to(bf)
              for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, positions=PAGED_POS, q="bf16", cache="bf16")
    got = FA.flash_decode_attention(q, kc, vc, pos)
    err, tol = compare("flash_decode_attention", got,
                       FA.flash_decode_attention_plain(q, kc, vc, pos), True, **info)
    k4, v4 = (c.view(B, S, Hkv, D).transpose(1, 2) for c in (kc, vc))
    mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
    rows_read = sum(p + 1 for p in PAGED_POS)
    record("flash_decode_attention", dict(info, library="sdpa, mask s <= pos"), err, tol,
           timer.ms(lambda: FA.flash_decode_attention(q, kc, vc, pos)),
           timer.ms(lambda: FA.flash_decode_attention_plain(q, kc, vc, pos)),
           timer.ms(lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), k4, v4, attn_mask=mask, enable_gqa=True)),
           nbytes(q) * 2 + 2 * rows_read * Hkv * D * it + nbytes(pos),
           4.0 * H * D * rows_read, "bf16")

    kp, vp = (torch.randn((1, S, Hkv, D), generator=g, device=dev).to(bf)
              for _ in range(2))
    for T, off in ((256, 256), (512, 0)):
        qp = torch.randn((1, T, H, D), generator=g, device=dev).to(bf)
        info = dict(B=1, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=off, q="bf16", cache="bf16")
        got = FA.flash_gqa_attention(qp, kp, vp, off)
        err, tol = compare("flash_gqa_attention", got,
                           FA.flash_gqa_attention_plain(qp, kp, vp, off), True, **info)
        n_keys = off + T
        kt, vt = (c[:, :n_keys].transpose(1, 2) for c in (kp, vp))
        causal = (torch.arange(n_keys, device=dev)[None, :]
                  <= off + torch.arange(T, device=dev)[:, None])
        qt = qp.transpose(1, 2)
        record("flash_gqa_attention", dict(info, library="sdpa, mask s <= offset + t"),
               err, tol,
               timer.ms(lambda: FA.flash_gqa_attention(qp, kp, vp, off)),
               timer.ms(lambda: FA.flash_gqa_attention_plain(qp, kp, vp, off)),
               timer.ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=causal, enable_gqa=True)),
               nbytes(qp) * 2 + 2 * n_keys * Hkv * D * it,
               4.0 * H * D * (T * off + T * (T + 1) / 2), "bf16")


def enqueue_us(torch, fn, n: int = 20) -> float:
    """Host microseconds to enqueue one ``fn()`` while the card is busy (a
    GPU spin first): the host cost of a launch, and whether it waits for
    the card (a launch that blocks shows the spin's ~10 ms here)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / n * 1e6


def check_ffn_kernel(torch, timer, g, compare, record):
    """K7 at TinyLlama width (E 2048, F 5632), q4_0 and q8_0 with f32
    planes, 1 and 8 rows: against its twin, and timed beside the unfused
    path it replaces (K1 on w13, silu * up, K1 on w2, as models/llama.py
    runs it), on the card and in host enqueue time. No single PyTorch call
    computes it: library_ms is null."""
    from tpu_llm_torch.ops.activations import silu
    from tpu_llm_torch.quant.ffn import ffn_fused, ffn_fused_plain
    from tpu_llm_torch.quant.qmatmul import qmatmul

    E, F = 2048, 5632
    for kind in ("q4_0", "q8_0"):
        w13 = random_qtensor(torch, g, kind, E, 2 * F)
        w2 = random_qtensor(torch, g, kind, F, E)
        for rows in (1, 8):
            x = torch.randn((rows, E), generator=g, device="cuda").bfloat16()

            def unfused():
                h13 = qmatmul(x, w13)
                return qmatmul(silu(h13[..., :F]) * h13[..., F:], w2)

            got = ffn_fused(x, w13, w2)
            info = dict(kind=kind, rows=rows, E=E, F=F, x="bf16", planes="f32")
            err, tol = compare("ffn_fused", got, ffn_fused_plain(x, w13, w2), True, **info)
            compare("ffn_fused_vs_unfused", unfused(), got, True, **info)
            info["unfused_ms"] = timer.ms(unfused)
            info["enqueue_us"] = enqueue_us(torch, lambda: ffn_fused(x, w13, w2))
            info["unfused_enqueue_us"] = enqueue_us(torch, unfused)
            record("ffn_fused", info, err, tol, timer.ms(lambda: ffn_fused(x, w13, w2)),
                   timer.ms(lambda: ffn_fused_plain(x, w13, w2)), None,
                   w13.nbytes + w2.nbytes + 2 * nbytes(x), 2.0 * rows * 3 * E * F, "bf16")


def int4pack_ms(torch, timer, x, w, want, info):
    """torch._weight_int4pack_mm on the same q4_0 / q4_1 / per-32 q4_0i4
    weight (repacked once, outside the timed region). The op computes
    (n - 8) * s + z with bf16 scales and zeros: q4_0's (n - 8) * d is that
    with z = 0, q4_1's n * s + m with z = m + 8 * s, q4_0i4's (n - 8) * s
    + m with z = m; its error against the twin is emitted beside the time.
    None, with the reason emitted, when the installed torch lacks the op on
    the card or its result is outside the bf16 tolerance of the twin."""
    from tpu_llm_torch.quant.qtensor import unpack_scales_f16

    K2, N = w.q.shape
    q = w.q.reshape(K2 // 16, 16, N).int()
    vals = torch.cat([q & 15, q >> 4], dim=1).reshape(2 * K2, N).t()   # (N, K) 0..15
    try:
        packed = torch._convert_weight_to_int4pack(
            ((vals[:, ::2] << 4) | vals[:, 1::2]).to(torch.uint8).contiguous(), 8)
        s = unpack_scales_f16(w.scales)
        zeros = (torch.zeros_like(s) if w.mins is None
                 else unpack_scales_f16(w.mins) + (0 if w.kind == "q4_0i4" else 8 * s))
        sz = torch.stack([s.bfloat16(), zeros.bfloat16()], dim=-1).contiguous()
        fn = lambda: torch._weight_int4pack_mm(x, packed, 32, sz)  # noqa: E731
        err = (fn().float() - want.float()).abs().max().item()
        if not err <= 2e-2 * want.float().abs().max().item():     # the bf16 tolerance
            raise RuntimeError(f"disagrees with the plain twin: max abs err {err}")
    except (AttributeError, RuntimeError, NotImplementedError) as e:
        emit("library_int4pack", **info, available=False, reason=str(e)[:200])
        return None
    ms = timer.ms(fn)
    emit("library_int4pack", **info, available=True, ms=ms, max_abs_err_vs_plain=err)
    return ms


PAGED_POS = [15, 100, 257, 511, 700, 900, 1000, 1023]
PAGED_BATCH1_POS = [1000]      # one live request


def check_paged_kernels(torch, timer, g, compare, record, cases):
    """K5 (bf16 and f32 pools, block 16) and K6 (int8 pools, block 32)
    against their plain twins at serving shapes: batch 8, 32/4 heads,
    head_dim 64, max_seq 1024, shuffled tables, positions PAGED_POS; and
    batch 1, one live request at position 1000. Then block 0 and every
    block past pos // BS poisoned: the same output. Each case reports its
    split count and the kernels the profiler sees a call launch (one: the
    split decode body merges in the same launch). Library:
    F.scaled_dot_product_attention over the rows gathered (and, for int8,
    dequantized) beforehand, masked to s <= pos; the gather is not timed."""
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.ops.kv_cache import dequantize_kv
    from tpu_llm_torch.ops.paged_kv import (PagedKV, paged_gather, scale_pool_width,
                                            scale_rows_per_block)

    F = torch.nn.functional
    dev = "cuda"
    H, Hkv, D, max_seq = 32, 4, 64, 1024
    cases["paged_flash_decode_attention"] = []
    cases["paged_flash_decode_q"] = []
    for (name, pool, BS), positions in itertools.product(
            (("paged_flash_decode_attention", "bf16", 16),
             ("paged_flash_decode_attention", "f32", 16),
             ("paged_flash_decode_q", "int8", 32)), (PAGED_POS, PAGED_BATCH1_POS)):
        B = len(positions)
        MB = max_seq // BS
        N = 1 + B * MB
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        table = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(BS)) + 1)
        table = table.reshape(B, MB).to(device=dev, dtype=torch.int32)
        if pool == "int8":
            kp, vp = (torch.randint(-127, 128, (N, BS, Hkv * D), generator=g, device=dev,
                                    dtype=torch.int32).to(torch.int8) for _ in range(2))
            shape = (N * scale_rows_per_block(Hkv), scale_pool_width(BS))
            ks, vs = (torch.rand(shape, generator=g, device=dev) * 0.09 + 0.01
                      for _ in range(2))
            scales = (ks, vs)
        else:
            dt = torch.bfloat16 if pool == "bf16" else torch.float32
            kp, vp = (torch.randn((N, BS, Hkv * D), generator=g, device=dev).to(dt)
                      for _ in range(2))
            scales = ()
        q = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
        if pool == "f32":
            q = q.float()
        kernel = getattr(FA, name)
        plain = getattr(FA, name + "_plain")
        args = (q, kp, vp, *scales, table, pos)
        n_split = FA.decode_splits(B, Hkv, MB * BS)[1]
        info = dict(B=B, H=H, Hkv=Hkv, D=D, BS=BS, MB=MB, pool=pool,
                    q=str(q.dtype).replace("torch.", ""), positions=positions,
                    n_split=n_split)
        got = kernel(*args)
        err, tol = compare(name, got, plain(*args), pool != "f32", **info)
        per_call = launches_per_call(torch, lambda: kernel(*args))
        if per_call != "not measured" and per_call != 1:
            fail(f"{name} {info}: one call launched {per_call} kernels, not 1")

        # poison block 0 and every block no row reads (past pos // BS)
        live = set()
        for b in range(B):
            live.update(table[b, :positions[b] // BS + 1].tolist())
        dead = torch.tensor([i for i in range(N) if i not in live], device=dev)
        nan = float("nan")
        if pool == "int8":
            hp = shape[0] // N
            rows = (dead[:, None] * hp + torch.arange(hp, device=dev)).reshape(-1)
            poisoned = (q, kp.index_fill(0, dead, -128), vp.index_fill(0, dead, -128),
                        ks.index_fill(0, rows, nan), vs.index_fill(0, rows, nan), table, pos)
        else:
            poisoned = (q, kp.index_fill(0, dead, nan), vp.index_fill(0, dead, nan),
                        table, pos)
        again = kernel(*poisoned)
        if not (bool(torch.isfinite(again).all()) and torch.equal(again, got)):
            fail(f"{name} {info}: poisoned unread blocks changed the output")

        kv = PagedKV(kp, vp, table, pos + 1, *scales)
        kg, vg = paged_gather(kv, n_kv_heads=Hkv)
        S = MB * BS
        if pool == "int8":
            kg, vg = (dequantize_kv(a, torch.bfloat16, head_dim=D) for a in (kg, vg))
        k4, v4 = (a.reshape(B, S, Hkv, D).transpose(1, 2).contiguous() for a in (kg, vg))
        qs = q.transpose(1, 2).to(k4.dtype)
        mask = (torch.arange(S, device=dev)[None, :] <= pos[:, None].long())[:, None, None, :]
        rows_read = sum(p + 1 for p in positions)
        it = kp.element_size()
        moved = (nbytes(q) * 2 + 2 * rows_read * Hkv * D * it
                 + sum(4 * (p // BS + 1) for p in positions)             # table entries
                 + (2 * rows_read * Hkv * 4 if pool == "int8" else 0))   # scales
        record(name, dict(info, launches_per_call=per_call,
                          library="sdpa over pre-gathered rows (gather not timed)"),
               err, tol, timer.ms(lambda: kernel(*args)), timer.ms(lambda: plain(*args)),
               timer.ms(lambda: F.scaled_dot_product_attention(
                   qs, k4, v4, attn_mask=mask, enable_gqa=True)),
               moved, 4.0 * H * D * rows_read, "f32")


def launches_per_call(torch, fn, calls: int = 4, tries: int = 3):
    """Kernels on the card a call of ``fn`` launches (torch.profiler, mean
    over ``calls``), or "not measured" where the profiler's device trace
    comes back empty ``tries`` times (it now and then does)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            return n / calls
    return "not measured"


# -- phase 3: the CLI on a tiny GGUF ---------------------------------------------

# Greedy text compared between card and CPU must not sit on a near-tie:
# bf16 activations turn the kernels' other summation order into one-ulp
# differences (~1e-3 of max|logit|). A plain random tiny model has a few
# greedy steps in a hundred whose top-2 logits lie closer than that. The
# K-quant files therefore carry a bigram bias (a 10x embedding, and 0.3x
# the embedding of a permuted token added to each classifier row); with
# seed 1, every greedy step of the CLI (plain and --fold-norms) and of the
# three serving modes, on the CPU, has its top-2 logits at least 0.06 of
# max|logit| apart, and the Q4_K and Q6_K files still give different text.
KQ_TINY_SEED = 1


def write_tiny_gguf(path: str, quant: bool, seed: int = 0, ttype: str = None):
    """The recipe of tests/make_tiny_gguf.py::build (same RNG sequence):
    2 layers, dim 64, 4 heads / 2 kv heads, ffn 96, a 32-token toy vocab.
    ``ttype`` (a ggml type name, e.g. "Q4_K") stores every projection and
    the classifier in that type at dim and ffn 256 (K-quant rows are 256)."""
    import numpy as np

    from tpu_llm_torch.io import gguf as gg

    rng = np.random.default_rng(seed)
    dim, hidden, L, H, KVH, V = 64, 96, 2, 4, 2, 32
    if ttype is not None:
        dim = hidden = 256
    kv = dim // H * KVH
    s = lambda *sh: (rng.standard_normal(sh) * 0.08).astype(np.float32)  # noqa: E731
    tokens = ["<unk>", "<s>", "</s>", "▁", "a", "b", "c", "▁ab", "ab", "bc",
              "▁abc"] + [f"tok{i}" for i in range(V - 11)]
    scores = np.asarray([0, 0, 0, 0, 0, 0, 0, 5.0, 4.0, 3.0, 6.0] + [0.0] * (V - 11),
                        np.float32)
    meta = {
        "general.architecture": "llama",
        "llama.block_count": L,
        "llama.embedding_length": dim,
        "llama.feed_forward_length": hidden,
        "llama.attention.head_count": H,
        "llama.attention.head_count_kv": KVH,
        "llama.context_length": 128,
        "llama.rope.freq_base": 10000.0,
        "llama.attention.layer_norm_rms_epsilon": 1e-5,
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": scores,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }
    wt = (lambda a: (a, gg.GGML_Q4_0)) if quant else (lambda a: a)
    if ttype is not None:
        wt = lambda a: (a, getattr(gg, f"GGML_{ttype}"))  # noqa: E731
    tensors = {
        "token_embd.weight": s(V, dim),
        "output_norm.weight": 1.0 + 0.1 * s(dim),
        "output.weight": wt(s(V, dim)),
    }
    for i in range(L):
        tensors[f"blk.{i}.attn_norm.weight"] = 1.0 + 0.1 * s(dim)
        tensors[f"blk.{i}.ffn_norm.weight"] = 1.0 + 0.1 * s(dim)
        tensors[f"blk.{i}.attn_q.weight"] = wt(s(dim, dim))
        tensors[f"blk.{i}.attn_k.weight"] = wt(s(kv, dim))
        tensors[f"blk.{i}.attn_v.weight"] = wt(s(kv, dim))
        tensors[f"blk.{i}.attn_output.weight"] = wt(s(dim, dim))
        tensors[f"blk.{i}.ffn_gate.weight"] = wt(s(hidden, dim))
        tensors[f"blk.{i}.ffn_up.weight"] = wt(s(hidden, dim))
        tensors[f"blk.{i}.ffn_down.weight"] = wt(s(dim, hidden))
    if ttype is not None:               # the bigram bias (see KQ_TINY_SEED)
        emb = tensors["token_embd.weight"] * 10.0
        perm = np.random.default_rng(1000 + seed).permutation(V)
        tensors["token_embd.weight"] = emb
        tensors["output.weight"] = wt(tensors["output.weight"][0] + 0.3 * emb[np.argsort(perm)])
    gg.write_gguf(path, meta, tensors)


def run_cli(argv) -> bytes:
    from tpu_llm_torch.runtime import cli

    buf = io.BytesIO()
    text = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    text.flush()
    if rc != 0:
        fail(f"cli {argv} exited {rc}")
    return buf.getvalue()


@contextlib.contextmanager
def switch(name: str):
    """Set one of the JAX package's layout / path switches for a block."""
    os.environ[name] = "1"
    try:
        yield
    finally:
        os.environ.pop(name, None)


def cli_card_vs_cpu(path: str, dtype: str, extra=(), must=()):
    """The greedy first line of the CLI on the card and on the CPU: equal,
    and each kernel in ``must`` launched by the card run."""
    args = ["-m", path, "-p", "abc", "-n", "12", "--dtype", dtype, *extra]
    reset_counts()
    card = run_cli(args + ["--device", "cuda"]).split(b"\n")[0]
    counts = read_counts()
    cpu = run_cli(args + ["--device", "cpu"]).split(b"\n")[0]
    row = dict(model=os.path.basename(path), dtype=dtype, flags=list(extra),
               switches=[k for k in ("TPU_LLM_FFN_MEGAKERNEL", "TPU_LLM_NORM_FOLD")
                         if os.environ.get(k)],
               cuda=card.decode(errors="replace"), cpu=cpu.decode(errors="replace"),
               equal=card == cpu, launches={k: v for k, v in counts.items() if v})
    emit("cli", **row)
    if card != cpu or not card.startswith(b"abc") or len(card) <= 3:
        fail(f"cli greedy output differs between card and CPU: {row}")
    for k in must:
        if counts[k] <= 0:
            fail(f"cli run {row['model']} {extra}: kernel {k} was never launched")
    return row


def check_cli(tmp: str):
    results = []
    for quant in (False, True):
        path = os.path.join(tmp, f"tiny_{'q4_0' if quant else 'f32'}.gguf")
        write_tiny_gguf(path, quant)
        for dtype in ("f32", "native"):
            results.append(cli_card_vs_cpu(path, dtype))
    # K-quant files (native: the packed planes through K1), --fold-norms
    # (requantized planes), and the FFN megakernel over native Q4_0
    for ttype in ("Q4_K", "Q6_K"):
        path = os.path.join(tmp, f"tiny_{ttype}.gguf")
        write_tiny_gguf(path, False, seed=KQ_TINY_SEED, ttype=ttype)
        results.append(cli_card_vs_cpu(path, "native", must=("qmatmul",)))
    results.append(cli_card_vs_cpu(os.path.join(tmp, "tiny_Q4_K.gguf"), "native",
                                   ["--fold-norms"], must=("qmatmul",)))
    with switch("TPU_LLM_FFN_MEGAKERNEL"):
        results.append(cli_card_vs_cpu(os.path.join(tmp, "tiny_q4_0.gguf"), "native",
                                       must=("qmatmul", "ffn_fused")))
    return results


def check_scan_cli(tmp: str):
    """llm --scan, --spec 3, --scan --spec 3 and --spec 3 --draft on the
    card against the CPU, on a tiny Q4_0 file with the bigram bias (native:
    the graph loop over q4_0i4 through K1); --scan over a tiny Q8_0 file
    with TPU_LLM_FFN_MEGAKERNEL set (K7 inside the captured graph)."""
    results = []
    q4 = os.path.join(tmp, "tiny_scan_Q4_0.gguf")
    write_tiny_gguf(q4, False, seed=KQ_TINY_SEED, ttype="Q4_0")
    for extra, must in ((["--scan"], ("qmatmul", "flash_decode_attention")),
                        (["--spec", "3"], ("qmatmul",)),
                        (["--scan", "--spec", "3"], ("qmatmul",)),
                        (["--spec", "3", "--draft", q4], ("qmatmul",))):
        results.append(cli_card_vs_cpu(q4, "native", extra, must))
    q8 = os.path.join(tmp, "tiny_scan_Q8_0.gguf")
    write_tiny_gguf(q8, False, seed=KQ_TINY_SEED, ttype="Q8_0")
    with switch("TPU_LLM_FFN_MEGAKERNEL"):
        results.append(cli_card_vs_cpu(q8, "native", ["--scan"], must=("qmatmul", "ffn_fused")))
    return results


# -- phase 4: llm-serve on the tiny GGUF -------------------------------------------

SERVE_MODES = {"dense": [], "paged": ["--paged", "--block-size", "4"],
               "paged_int8": ["--paged", "--cache-dtype", "int8"]}


def run_serve_cli(argv):
    """The port's serve CLI in-process: (per-request rows, summary)."""
    from tpu_llm_torch.runtime import serve_cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = serve_cli.main(argv)
    if rc != 0:
        fail(f"serve_cli {argv} exited {rc}: {err.getvalue()[-500:]}")
    rows = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    summary = json.loads([ln for ln in err.getvalue().splitlines() if ln.startswith("{")][-1])
    return rows, summary


def check_serve_cli(tmp: str):
    path = os.path.join(tmp, "tiny_serve_f32.gguf")
    write_tiny_gguf(path, quant=False)
    files = [(path, "f32")]
    for ttype in ("Q4_K", "Q6_K"):       # native: the K-quant planes through K1
        files.append((os.path.join(tmp, f"tiny_serve_{ttype}.gguf"), "native"))
        write_tiny_gguf(files[-1][0], False, seed=KQ_TINY_SEED, ttype=ttype)
    for path, dtype in files:
        base = ["-m", path, "-p", "abc", "-p", "ab", "-p", "abc abc ab", "-p", "abc abc b",
                "-n", "6", "--batch", "2", "--dtype", dtype]
        for mode, flags in SERVE_MODES.items():
            reset_counts()
            card, card_sum = run_serve_cli(base + flags + ["--device", "cuda"])
            launched = read_counts()["qmatmul"]
            cpu, _ = run_serve_cli(base + flags + ["--device", "cpu"])
            comp = [(r["completion"], r["n_tokens"]) for r in card]
            row = dict(model=os.path.basename(path), dtype=dtype, mode=mode, cuda=comp,
                       cpu=[(r["completion"], r["n_tokens"]) for r in cpu],
                       qmatmul_launches=launched, summary=card_sum)
            emit("serve_cli", **row)
            if row["cuda"] != row["cpu"] or len(comp) != 4 or any(n != 6 for _, n in comp):
                fail(f"serve_cli completions differ between card and CPU: {row}")
            if dtype == "native" and launched <= 0:
                fail(f"serve_cli {row['model']} {mode}: qmatmul was never launched")


# -- phase 5: full width ---------------------------------------------------------

def synth_tinyllama(torch, cfg, seed: int, kind: str = "q4_0", planes: str = "f32"):
    """TinyLlama-shaped packed weights of ``kind`` built on the card from a
    seeded generator (random_qtensor; fused wqkv / w13 layout, per-layer
    list)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    E, Fh, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim

    def qt(K, N):
        return random_qtensor(torch, g, kind, K, N, planes)

    ones = lambda: torch.ones(E, device="cuda")  # noqa: E731
    layers = [{"attn_norm": ones(), "ffn_norm": ones(), "wqkv": qt(E, E + 2 * KV),
               "wo": qt(E, E), "w13": qt(E, 2 * Fh), "w2": qt(Fh, E)}
              for _ in range(cfg.n_layers)]
    emb = (torch.randn((V, E), generator=g, device="cuda") * 0.02).bfloat16()
    return {"tok_emb": emb, "final_norm": ones(), "wcls": qt(E, V), "layers": layers}


def first_logits_fn(torch, params, cfg, ids, max_seq: int):
    """The logits of the prompt's last position (prefill through K1)."""
    from tpu_llm_torch.models import llama as M

    def fn():
        c = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        x, _ = M.forward(params, cfg, ids, c, 0)
        return M.lm_head(params, cfg, x[:, -1:])[0, 0]
    return fn


def decode_logits_fn(torch, params, cfg, ids, max_seq: int):
    """The logits of one decode step after the prompt (one row: the path
    the FFN megakernel takes)."""
    from tpu_llm_torch.models import llama as M

    def fn():
        c = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        _, c = M.forward(params, cfg, ids, c, 0)
        tok = torch.tensor([5], device="cuda")
        return M.decode_step(params, cfg, tok, c, ids.shape[1])[0][0]
    return fn


def profile_busy(torch, run, steps: int, groups=None):
    """torch.profiler around ``run()`` (``steps`` steps, ending
    synchronized): device busy time (sum of kernel times on the one
    stream) over wall time, and the kernels that take the most of it. The
    profiler slows the host, so the busy share is a lower bound on the
    unprofiled one. ``groups``: label -> name fragments; each label gets
    the device ms and the launches a step of the kernels whose names hold
    one of its fragments."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # a CPU op's device time repeats its kernels' time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        return dict(device_busy_share="not measured", steps=steps)
    out = dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
               device_ms_per_step=busy_us / steps / 1e3,
               device_busy_share=busy_us / wall_us,
               top=[dict(kernel=k[:80], ms_per_step=us / steps / 1e3,
                         calls_per_step=c / steps) for us, k, c in rows[:10]])
    for label, frags in (groups or {}).items():
        hit = [(us, c) for us, k, c in rows if any(f in k for f in frags)]
        out[label] = dict(ms_per_step=sum(us for us, _ in hit) / steps / 1e3,
                          launches_per_step=sum(c for _, c in hit) / steps)
    return out


def profile_decode(torch, params, cfg, max_seq: int, steps: int, groups=None):
    """The device busy share over ``steps`` decode steps of the CLI path
    (K2, positions 16..); ``groups`` as in profile_busy."""
    from tpu_llm_torch.models import llama as M

    cache = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
    tok = torch.tensor([1], device="cuda")
    with torch.inference_mode():
        for pos in range(16):                       # fill 16 rows, warm up
            logits, cache = M.decode_step(params, cfg, tok, cache, pos)
        torch.cuda.synchronize()

        def run():
            nonlocal tok, cache
            for pos in range(16, 16 + steps):
                logits, cache = M.decode_step(params, cfg, tok, cache, pos)
                tok = torch.argmax(logits, dim=-1)

        return profile_busy(torch, run, steps, groups)


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls to their plain twins (on the card)."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.ops import paged_kv
    from tpu_llm_torch.quant import ffn, linear, qmatmul

    swaps = [(M, n) for n in ("flash_decode_attention", "flash_decode_fused",
                              "flash_gqa_attention")]
    swaps += [(paged_kv, n) for n in ("paged_flash_decode_attention", "paged_flash_decode_q",
                                      "flash_gqa_attention")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in swaps]
    saved_q, saved_f = linear.qmatmul, M.ffn_fused
    try:
        linear.qmatmul = qmatmul.qmatmul_plain
        M.ffn_fused = ffn.ffn_fused_plain
        for mod, n in swaps:
            setattr(mod, n, getattr(FA, n + "_plain"))
        yield
    finally:
        linear.qmatmul, M.ffn_fused = saved_q, saved_f
        for mod, n, f in saved:
            setattr(mod, n, f)


def counters():
    """The kernel wrappers and their launch counts; a CUDA graph's replay
    adds the launches it makes (runtime/graphs.py)."""
    from tpu_llm_torch.runtime.graphs import counted_kernels

    return counted_kernels()


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts():
    return {n: f.launches for n, f in counters().items()}


def drive_run(torch, name, fn, must, runs, total):
    """One main-path run: counts set to 0 just before, read just after; a
    kernel of ``must`` that never launched fails the smoke."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    for k in must:
        if counts[k] <= 0:
            fail(f"main path {name}: kernel {k} was never launched ({counts})")
    for k, v in counts.items():
        total[k] += v
    runs[name] = counts
    return out, counts


def logits_vs_plain(torch, label, kern_fn, rel_tol=2e-2):
    """``kern_fn()`` on the kernel path and under plain_path(): top-1 equal
    and max error <= rel_tol * max|logit| (2e-2 for the bf16 paths)."""
    with torch.inference_mode():
        kern = kern_fn()
        with plain_path():
            plain = kern_fn()
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        fail(f"{label}: logits are not finite")
    err = (kern - plain).abs().max().item()
    tol = rel_tol * plain.abs().max().item()
    top2 = torch.topk(plain, 2).values
    row = dict(run=label, top1_kernel=int(kern.argmax()), top1_plain=int(plain.argmax()),
               max_abs_err=err, tol=tol, max_abs_logit=plain.abs().max().item(),
               top2_gap=(top2[0] - top2[1]).item())
    emit("logits_vs_plain", **row)
    if row["top1_kernel"] != row["top1_plain"] or not err <= tol:
        fail(f"{label}: logits differ from the plain path: {row}")
    return row


def full_width(torch):
    import numpy as np

    from tpu_llm_torch.config import tinyllama_1_1b
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    # random weights need no column permutation: the neox form is what
    # fold_rope_interleave makes of an interleaved checkpoint
    cfg = dataclasses.replace(tinyllama_1_1b(), rope_variant="neox")
    t0 = time.perf_counter()
    params = synth_tinyllama(torch, cfg, seed=7)
    torch.cuda.synchronize()
    packed = sum(w.nbytes for lp in params["layers"] for k, w in lp.items()
                 if k.startswith("w")) + params["wcls"].nbytes
    emit("full_width_weights", layers=cfg.n_layers, dim=cfg.dim, hidden=cfg.hidden_dim,
         vocab=cfg.vocab_size, packed_bytes=packed, build_s=time.perf_counter() - t0)

    max_seq = 2048
    engine = Engine(params, ModelAdapter.llama(cfg, torch.float32, bos_id=1, device="cuda"),
                    max_seq=max_seq, device="cuda")
    rng = np.random.default_rng(3)
    prompt16 = [int(t) for t in rng.integers(3, cfg.vocab_size, 15)]   # + BOS = 16
    prompt512 = [int(t) for t in rng.integers(3, cfg.vocab_size, 511)]  # + BOS = 512
    engine.generate(prompt16, n_new=8)       # warm-up: allocator, cuBLAS handles
    runs, total = {}, {n: 0 for n in counters()}

    def drive(name, fn, must):
        return drive_run(torch, name, fn, must, runs, total)

    # (a) the CLI path: 16-token prompt, 128 greedy tokens
    res, counts = drive("generate_16_128",
                        lambda: engine.generate(prompt16, n_new=128),
                        ("qmatmul", "flash_decode_attention"))
    gen = res.tokens[len(prompt16):]
    if len(gen) != 128 or not all(0 <= t < cfg.vocab_size for t in gen):
        fail(f"generate: {len(gen)} tokens, some out of range")
    emit("generate", prompt_tokens=16, new_tokens=128, decode_tok_s=res.tokens_per_s,
         ttft_ms=res.ttft_s * 1e3, decode_s=res.decode_s, launches=counts,
         first_tokens=gen[:8])

    # launches of one decode step
    cache = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
    _, per_step = drive("one_decode_step",
                        lambda: M.decode_step(params, cfg, torch.tensor([1], device="cuda"),
                                              cache, 0), ("qmatmul", "flash_decode_attention"))

    # device busy share over decode steps of the CLI path (profiler on)
    prof = profile_decode(torch, params, cfg, max_seq, steps=16)
    emit("decode_profile", **prof)

    # (b) a 512-token prompt: prefill through the flash prefill kernel
    res512, counts = drive("generate_512_16",
                           lambda: engine.generate(prompt512, n_new=16),
                           ("qmatmul", "flash_gqa_attention", "flash_decode_attention"))
    emit("generate", prompt_tokens=512, new_tokens=16, decode_tok_s=res512.tokens_per_s,
         ttft_ms=res512.ttft_s * 1e3, launches=counts)

    # first-step logits: kernel path against the plain path, both on the card
    ids = torch.tensor([[1] + prompt16], device="cuda")

    logits_vs_plain(torch, "full_width_q4_0_first_step", first_logits_fn(
        torch, params, cfg, ids, max_seq))

    # (c) the bench path: decode_step(defer_kv=True), 128 steps
    def defer_loop():
        c = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        tok = torch.tensor([1], device="cuda")
        with torch.inference_mode():
            M.decode_step(params, cfg, tok, c, 0, defer_kv=True)   # warm
            torch.cuda.synchronize()
            t = time.perf_counter()
            for pos in range(1, 129):
                logits, c = M.decode_step(params, cfg, tok, c, pos, defer_kv=True)
                tok = torch.argmax(logits, dim=-1)
            torch.cuda.synchronize()
            return time.perf_counter() - t, logits

    (secs, logits), counts = drive("decode_defer_kv_128", defer_loop,
                                   ("qmatmul", "flash_decode_fused"))
    if not bool(torch.isfinite(logits).all()):
        fail("defer_kv decode logits are not finite")
    emit("decode_defer_kv", steps=128, tok_s=128 / secs, launches=counts)
    return dict(runs=runs, total=total, per_step=per_step,
                device_busy_share=prof["device_busy_share"],
                decode_tok_s=res.tokens_per_s, ttft_ms_16=res.ttft_s * 1e3,
                ttft_ms_512=res512.ttft_s * 1e3, defer_tok_s=128 / secs,
                packed_bytes=packed), params, cfg


# -- phase 6: serving at full width ------------------------------------------------

SERVE_NEW = 128


def serve_requests(cfg, seed: int = 11):
    """8 prompts sharing a 256-token prefix with 32-200-token tails,
    interleaved with 8 distinct prompts of 64-512 tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tok = lambda n: [int(t) for t in rng.integers(3, cfg.vocab_size, n)]  # noqa: E731
    prefix = tok(256)
    shared = [prefix + tok(int(n)) for n in rng.integers(32, 201, 8)]
    distinct = [tok(int(n)) for n in rng.integers(64, 513, 8)]
    return [p for pair in zip(shared, distinct) for p in pair]


def serve_engines(torch, params, cfg, max_seq: int):
    from tpu_llm_torch.runtime.batching import BatchEngine
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.paged_engine import PagedEngine

    def paged(cache_dtype, bs):
        return lambda: PagedEngine(params, cfg, batch=8, block_size=bs, max_seq=max_seq,
                                   n_blocks=1 + 8 * (max_seq // bs), cache_dtype=cache_dtype,
                                   device="cuda")

    return {
        "paged_bf16_bs16": (paged(torch.bfloat16, 16),
                            ("qmatmul", "paged_flash_decode_attention")),
        "paged_int8_bs32": (paged("int8", 32), ("qmatmul", "paged_flash_decode_q")),
        "dense_bf16": (lambda: BatchEngine(
            params, ModelAdapter.llama(cfg, torch.bfloat16, bos_id=1, device="cuda"),
            batch=8, max_seq=max_seq), ("qmatmul", "flash_decode_attention")),
    }


def decode_logits_vs_plain(torch, eng, params, cfg, requests, label):
    """One batched decode step's logits, kernel path against plain_path(),
    from an engine with 8 admitted requests two steps in (per-row
    positions: K5 / K6 through the block table, or K2 over the dense
    cache)."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.batching import Request, to_device
    from tpu_llm_torch.runtime.paged_engine import PagedEngine

    eng.reset()
    for p in requests[:8]:
        eng.submit(Request(prompt=p, max_new=SERVE_NEW))
    eng.step()
    eng.step()
    eng._collect()
    live = [(i, s.req) for i, s in enumerate(eng.slots) if not s.free]
    eng._pre_dispatch(live)
    offsets = to_device([s.pos for s in eng.slots], torch.int32, eng.device)
    tok = eng._token_dev.clone()

    def logits():
        with torch.no_grad():
            if isinstance(eng, PagedEngine):
                hidden = eng._forward(tok[:, None], eng.state["table"],
                                      eng.state["lengths"], offsets)
            else:
                hidden, _ = M.forward(params, cfg, tok[:, None], eng.state, offsets)
            return M.lm_head(params, cfg, hidden)[:, 0, :]

    kern = logits()
    with plain_path():
        plain = logits()
    err = (kern - plain).abs().max().item()
    tol = 2e-2 * plain.abs().max().item()
    row = dict(engine=label, rows=kern.shape[0], top1_kernel=kern.argmax(-1).tolist(),
               top1_plain=plain.argmax(-1).tolist(), max_abs_err=err, tol=tol)
    emit("serve_logits_vs_plain", **row)
    if not (bool(torch.isfinite(kern).all()) and row["top1_kernel"] == row["top1_plain"]
            and err <= tol):
        fail(f"batched decode logits differ from the plain path: {row}")


# the kernels serve_full_width reports apart in a profiled step: K5 / K6
# (the split decode body over paged rows), and every attention kernel
SERVE_KERNEL_GROUPS = {"paged_decode": ("PagedRows",),
                       "attention": ("flash_decode_split_kernel", "flash_prefill")}


def serve_full_width(torch, params, cfg):
    from tpu_llm_torch.runtime.batching import Request

    max_seq = 1024
    requests = serve_requests(cfg)
    runs, total = {}, {n: 0 for n in counters()}
    for label, (make, must) in serve_engines(torch, params, cfg, max_seq).items():
        eng = make()
        eng.submit(Request(prompt=requests[1][:64], max_new=8))   # warm-up
        eng.run()
        eng.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        reset_counts()
        first = {}
        t0 = time.perf_counter()

        def mark(i):
            return lambda _tok: first.setdefault(i, time.perf_counter() - t0)

        reqs = [eng.submit(Request(prompt=p, max_new=SERVE_NEW, stream=mark(i)))
                for i, p in enumerate(requests)]
        steps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k in must:
            if counts[k] <= 0:
                fail(f"serving run {label}: kernel {k} was never launched ({counts})")
        for r in reqs:
            if len(r.tokens) != SERVE_NEW or not all(0 <= t < cfg.vocab_size for t in r.tokens):
                fail(f"serving run {label}: request {r.rid} gave {len(r.tokens)} tokens")
        for k, v in counts.items():
            total[k] += v
        gen = sum(len(r.tokens) for r in reqs)
        ttfts = sorted(first.values())
        pc = getattr(eng, "prefix", None)
        row = dict(engine=label, requests=len(reqs), generated_tokens=gen, wall_s=wall,
                   tokens_per_s=gen / wall, ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3,
                   engine_steps=steps, launches=counts,
                   prefix_hit_rate=(pc.hits / pc.queries) if pc and pc.queries else None,
                   hbm_blocks_in_use=getattr(eng, "hbm_blocks_in_use", None),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

        # 16 profiled decode steps with 8 live slots, and their launches
        eng.reset()
        for p in requests[:8]:
            eng.submit(Request(prompt=p, max_new=SERVE_NEW))
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        reset_counts()
        prof = profile_busy(torch, lambda: [eng.step() for _ in range(16)], 16,
                            groups=SERVE_KERNEL_GROUPS)
        row["launches_per_step"] = {k: v / 16 for k, v in read_counts().items()}
        row["profile"] = prof
        emit("serve_full_width", **row)
        runs[label] = row
        decode_logits_vs_plain(torch, eng, params, cfg, requests, label)
        del eng
        torch.cuda.empty_cache()
    return dict(runs=runs, total=total)


# -- phase 7: K-quant layouts at full width ------------------------------------------

# (GGUF type, the device kind it loads as by default, plane dtype)
KQUANT_LAYOUTS = [("Q4_K", "q4_1", "bf16"), ("Q6_K", "q6_k", "bf16"),
                  ("Q5_K", "q5_1", "bf16"), ("Q3_K", "q3_kp", "bf16"),
                  ("Q2_K", "q2_kp", "bf16")]


def kquant_full_width(torch):
    """TinyLlama-1.1B width and depth with weights synthesized on the card
    in each K-quant's default layout: Engine.generate with a 16-token
    prompt and 128 greedy tokens, the launches of one decode step, and the
    first-step logits held against the plain path."""
    import numpy as np

    from tpu_llm_torch.config import tinyllama_1_1b
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    cfg = dataclasses.replace(tinyllama_1_1b(), rope_variant="neox")
    max_seq = 256
    prompt16 = [int(t) for t in np.random.default_rng(3).integers(3, cfg.vocab_size, 15)]
    runs, total, rows = {}, {n: 0 for n in counters()}, []
    for i, (ttype, kind, planes) in enumerate(KQUANT_LAYOUTS):
        params = synth_tinyllama(torch, cfg, seed=20 + i, kind=kind, planes=planes)
        packed = sum(w.nbytes for lp in params["layers"] for k, w in lp.items()
                     if k.startswith("w")) + params["wcls"].nbytes
        engine = Engine(params, ModelAdapter.llama(cfg, torch.float32, bos_id=1,
                                                   device="cuda"),
                        max_seq=max_seq, device="cuda")
        engine.generate(prompt16, n_new=8)                     # warm-up
        res, counts = drive_run(torch, f"kquant_{ttype}_generate_16_128",
                                lambda: engine.generate(prompt16, n_new=128),
                                ("qmatmul", "flash_decode_attention"), runs, total)
        gen = res.tokens[len(prompt16):]
        if len(gen) != 128 or not all(0 <= t < cfg.vocab_size for t in gen):
            fail(f"kquant {ttype}: {len(gen)} tokens, some out of range")
        cache = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        _, per_step = drive_run(torch, f"kquant_{ttype}_one_decode_step",
                                lambda: M.decode_step(params, cfg,
                                                      torch.tensor([1], device="cuda"),
                                                      cache, 0),
                                ("qmatmul",), runs, total)
        # the logits check runs f32 activations: through 22 layers of random
        # weights, bf16 rounding amplifies mere summation-order differences
        # (a CPU run that only reorders the same sums moves the Q4_K
        # model's bf16 logits by 4% of max|logit|, its f32 ones by 1e-5)
        ids = torch.tensor([[1] + prompt16], device="cuda")
        f32_params = dict(params, tok_emb=params["tok_emb"].float())
        lv = logits_vs_plain(torch, f"kquant_{ttype}_first_step_f32",
                             first_logits_fn(torch, f32_params, cfg, ids, max_seq))
        row = dict(layout=ttype, kind=kind, planes=planes, packed_bytes=packed,
                   decode_tok_s=res.tokens_per_s, ttft_ms=res.ttft_s * 1e3,
                   launches=counts, per_step=per_step, first_tokens=gen[:8],
                   logits_err=lv["max_abs_err"], logits_tol=lv["tol"])
        emit("kquant_full_width", **row)
        rows.append(row)
        del engine, params
        torch.cuda.empty_cache()
    return dict(runs=runs, total=total, rows=rows)


# -- phase 9: the graph decode loop at full width -----------------------------------

BENCH_CHUNK = 8        # decode steps in one captured graph of the bench program


def graph_profile(torch, captured, steps: int, reset):
    """torch.profiler over ``steps`` replays of a captured one-step graph,
    then the same replays timed without the profiler (whose own host cost
    lowers the profiled busy share): the profiled device time a step over
    that wall time is the unprofiled busy share. ``reset()`` rewinds the
    graph's position before each run."""
    reset()
    prof = profile_busy(torch, lambda: [captured() for _ in range(steps)], steps)
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        captured()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) / steps * 1e3
    prof["unprofiled_wall_ms_per_step"] = wall_ms
    if "device_ms_per_step" in prof:
        prof["device_busy_share_unprofiled"] = prof["device_ms_per_step"] / wall_ms
    return prof


def bench_step_logits_fn(torch, p4, cfg, ids):
    """One step of bench.py's program after the prompt ``ids``: the prompt
    prefilled into a bf16 cache of BENCH_MAX_SEQ rows, then
    decode_step(defer_kv=True) at its length (K3 on the bf16 cache, K1 on
    the int4-plane weights)."""
    from tpu_llm_torch.models import llama as M

    def fn():
        c = M.init_cache(cfg, 1, BENCH_MAX_SEQ, torch.bfloat16, "cuda")
        _, c = M.forward(p4, cfg, ids, c, 0)
        tok = torch.tensor([5], device="cuda")
        pos = torch.full((1,), ids.shape[1], dtype=torch.int32, device="cuda")
        return M.decode_step(p4, cfg, tok, c, pos, defer_kv=True)[0][0]
    return fn


def bench_program(torch, params, cfg, pack, ids, runs, total):
    """bench.py's program: decode_step(defer_kv=True) over
    unpack_params_int4(params, pack_scales=pack), a bf16 cache of
    BENCH_MAX_SEQ rows, prompt_len BENCH_PROMPT, greedy feedback on the
    device; BENCH_CHUNK steps captured in one graph and replayed,
    slope-timed at BENCH_STEPS. One step after the prompt ``ids`` is held
    against the plain path first."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.quant.convert_params import unpack_params_int4
    from tpu_llm_torch.runtime.graphs import CapturedStep
    from tpu_llm_torch.runtime.timing import slope_time_s

    p4 = unpack_params_int4(params, pack_scales=pack)
    label = f"scan_bench_defer_kv_{pack or 'none'}"
    lv = logits_vs_plain(torch, f"{label}_step", bench_step_logits_fn(torch, p4, cfg, ids))
    cache = M.init_cache(cfg, 1, BENCH_MAX_SEQ, torch.bfloat16, "cuda")
    tok = torch.ones(1, dtype=torch.long, device="cuda")
    pos = torch.full((1,), BENCH_PROMPT, dtype=torch.int32, device="cuda")
    logits = torch.zeros((1, cfg.vocab_size), device="cuda")

    def step():
        for _ in range(BENCH_CHUNK):
            out, _ = M.decode_step(p4, cfg, tok, cache, pos, defer_kv=True)
            logits.copy_(out)
            tok.copy_(torch.argmax(out, dim=-1))
            pos.add_(1)

    with torch.inference_mode():
        cap = CapturedStep(step, "cuda", warmup=1)

        def make(n):
            def run():
                pos.fill_(BENCH_PROMPT)
                tok.fill_(1)
                for _ in range(n // BENCH_CHUNK):
                    cap()
                tok.item()
            return run

        sec, counts = drive_run(torch, label, lambda: slope_time_s(make, *BENCH_STEPS),
                                ("qmatmul", "flash_decode_fused"), runs, total)

        def rewind():            # positions 336-351: the middle of the 640-step run
            pos.fill_(336)
            tok.fill_(1)

        prof = graph_profile(torch, cap, 2, rewind)          # per replay of BENCH_CHUNK steps
    if not bool(torch.isfinite(logits).all()):
        fail(f"{label}: logits are not finite")
    scale_bytes = sum(w.scales.numel() * w.scales.element_size()
                      for lp in p4["layers"] for k, w in lp.items() if k.startswith("w"))
    return dict(pack_scales=pack or "none", ms_per_step=sec * 1e3, tok_s=1.0 / sec,
                launches=counts, per_replay=cap.per_replay, steps_per_replay=BENCH_CHUNK,
                layer_scale_bytes=scale_bytes, profile_per_replay=prof,
                step_logits_err=lv["max_abs_err"], step_logits_tol=lv["tol"])


def scan_full_width(torch, params, cfg):
    """The phase-5 model (TinyLlama-1.1B width and depth, Q4_0 from seed 7):
    (a) the step loop and (b) Engine.generate(use_scan=True), a 16-token
    prompt and 128 greedy tokens, f32 cache: equal token lists; (c) the
    bench program with pack_scales none / f16 / bf16; (d) the device busy
    share over 16 replayed steps against 16 steps of the step loop; (e)
    speculation with k = 4 on a repetitive prompt, host and device loops,
    against the plain stream; (f) the --timings buckets."""
    import numpy as np

    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter
    from tpu_llm_torch.runtime.phase_timing import measure_phase_times

    max_seq = 2048
    runs, total = {}, {n: 0 for n in counters()}
    rng = np.random.default_rng(3)
    prompt16 = [int(t) for t in rng.integers(3, cfg.vocab_size, 15)]   # + BOS = 16

    def engine():
        return Engine(params, ModelAdapter.llama(cfg, torch.float32, bos_id=1, device="cuda"),
                      max_seq=max_seq, device="cuda")

    step_eng, graph_eng = engine(), engine()
    step_eng.generate(prompt16, n_new=8)                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    graph_eng.generate(prompt16, n_new=8, use_scan=True)            # warm-up + capture
    torch.cuda.synchronize()
    peak_graph = torch.cuda.max_memory_allocated()
    g = graph_eng._graphs[("decode", 0.0)]
    replays0 = g["captured"].replays
    must = ("qmatmul", "flash_decode_attention")
    res_a, counts_a = drive_run(torch, "scan_step_loop_16_128",
                                lambda: step_eng.generate(prompt16, n_new=128), must, runs, total)
    res_b, counts_b = drive_run(torch, "scan_graph_16_128",
                                lambda: graph_eng.generate(prompt16, n_new=128, use_scan=True),
                                must, runs, total)
    replays = g["captured"].replays - replays0
    if res_a.tokens != res_b.tokens:
        fail(f"scan: graph tokens differ from the step loop: {res_a.tokens[16:40]} vs "
             f"{res_b.tokens[16:40]}")
    # graph_launches also holds the eager prefill's; replay_launches only
    # what the replays ran
    row = dict(step_loop_tok_s=res_a.tokens_per_s, graph_tok_s=res_b.tokens_per_s,
               step_loop_ttft_ms=res_a.ttft_s * 1e3, graph_ttft_ms=res_b.ttft_s * 1e3,
               tokens_equal=True, first_tokens=res_b.tokens[15:23],
               step_loop_launches=counts_a, graph_launches=counts_b,
               per_replay=g["captured"].per_replay, replays=replays,
               replay_launches={k: n * replays for k, n in g["captured"].per_replay.items()},
               peak_mem_gb_with_graph_engine=peak_graph / 1e9)
    emit("scan_generate", **row)

    # (d) device busy: 16 steps of the step loop, 16 replays of the graph
    def rewind():
        g["pos"].fill_(16)
        g["i"].zero_()

    with torch.inference_mode():
        prof_graph = graph_profile(torch, g["captured"], 16, rewind)
    prof_step = profile_decode(torch, params, cfg, max_seq, steps=16)
    emit("scan_profile", step_loop=prof_step, graph=prof_graph)

    # (c) the bench program, three scale-plane forms
    ids = torch.tensor([[1] + prompt16], device="cuda")
    bench = [bench_program(torch, params, cfg, pack, ids, runs, total)
             for pack in (False, "f16", "bf16")]
    for b in bench:
        emit("scan_bench", **b)

    # (e) speculation, k = SPEC_K, on a repetitive prompt (a 8-token pattern x 4)
    pattern = [int(t) for t in rng.integers(3, cfg.vocab_size, 8)]
    rep = pattern * 4
    base, _ = drive_run(torch, "spec_plain_32_128", lambda: step_eng.generate(rep, n_new=128),
                        must, runs, total)
    verify_calls = {"n": 0}
    verify = step_eng._verify

    def counted_verify(*a, **kw):
        verify_calls["n"] += 1
        return verify(*a, **kw)

    step_eng._verify = counted_verify
    host, _ = drive_run(torch, f"spec_host_k{SPEC_K}_32_128",
                        lambda: step_eng.generate(rep, n_new=128, speculative_k=SPEC_K),
                        ("qmatmul",), runs, total)
    del step_eng._verify
    graph_eng.generate(rep, n_new=8, use_scan=True, speculative_k=SPEC_K)   # warm-up + capture
    graph_eng.stats.update(spec_forwards=0, spec_tokens=0, spec_host_syncs=0)
    dev, _ = drive_run(torch, f"spec_device_k{SPEC_K}_32_128",
                       lambda: graph_eng.generate(rep, n_new=128, use_scan=True,
                                                  speculative_k=SPEC_K),
                       ("qmatmul",), runs, total)
    for label, r in (("host", host), ("device", dev)):
        if r.tokens != base.tokens:
            fail(f"spec {label}: tokens differ from the plain greedy stream")
    st = graph_eng.stats
    spec = dict(prompt_tokens=32, new_tokens=128, k=SPEC_K, plain_tok_s=base.tokens_per_s,
                host_tok_s=host.tokens_per_s, host_verify_forwards=verify_calls["n"],
                host_tokens_per_forward=127 / max(verify_calls["n"], 1),
                device_tok_s=dev.tokens_per_s, device_forwards=st["spec_forwards"],
                device_tokens_per_forward=st["spec_tokens"] / max(st["spec_forwards"], 1),
                device_host_syncs_per_forward=st["spec_host_syncs"] / max(st["spec_forwards"], 1),
                tokens_equal=True)
    emit("scan_spec", **spec)

    # (f) the --timings buckets at the CLI's defaults, position 144, over
    # the loaded q4_0 weights and over the graph loop's int4-plane weights
    timings = measure_phase_times(params, cfg, pos=144, max_seq=1024)
    timings_int4 = measure_phase_times(params, cfg, pos=144, max_seq=1024, int4=True)
    for t in (timings, timings_int4):
        if not all(math.isfinite(v) for v in t.values()):
            fail(f"--timings buckets are not finite: {t}")
    emit("scan_timings", ms_per_token=timings, sum_ms=sum(timings.values()),
         ms_per_token_int4=timings_int4, sum_ms_int4=sum(timings_int4.values()))
    del step_eng, graph_eng
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, row=row, bench=bench, spec=spec, timings=timings,
                timings_int4=timings_int4,
                busy_graph=prof_graph.get("device_busy_share"),
                busy_step=prof_step.get("device_busy_share"))


# -- phase 8: the FFN megakernel on the main path -------------------------------------

def megakernel_full_width(torch, params, cfg):
    """The full-width Q4_0 model with TPU_LLM_FFN_MEGAKERNEL set: generate
    (16 + 128; decode steps take K7, the 16-token prefill stays unfused),
    the launches of one decode step, a decode step's logits against the
    plain path, and the dense BatchEngine at batch 8 (8 requests, 32 new
    tokens) with its batched decode logits against the plain path."""
    import numpy as np

    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    max_seq = 1024
    runs, total = {}, {n: 0 for n in counters()}
    prompt16 = [int(t) for t in np.random.default_rng(3).integers(3, cfg.vocab_size, 15)]
    with switch("TPU_LLM_FFN_MEGAKERNEL"):
        engine = Engine(params, ModelAdapter.llama(cfg, torch.float32, bos_id=1,
                                                   device="cuda"),
                        max_seq=max_seq, device="cuda")
        engine.generate(prompt16, n_new=8)                     # warm-up
        res, counts = drive_run(torch, "megakernel_generate_16_128",
                                lambda: engine.generate(prompt16, n_new=128),
                                ("qmatmul", "ffn_fused", "flash_decode_attention"),
                                runs, total)
        cache = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        _, per_step = drive_run(torch, "megakernel_one_decode_step",
                                lambda: M.decode_step(params, cfg,
                                                      torch.tensor([1], device="cuda"),
                                                      cache, 0),
                                ("qmatmul", "ffn_fused"), runs, total)
        if per_step["ffn_fused"] != cfg.n_layers:
            fail(f"megakernel decode step: {per_step}")
        ids = torch.tensor([[1] + prompt16], device="cuda")
        lv = logits_vs_plain(torch, "megakernel_decode_step",
                             decode_logits_fn(torch, params, cfg, ids, max_seq))
        eng = BatchEngine(params, ModelAdapter.llama(cfg, torch.bfloat16, bos_id=1,
                                                     device="cuda"),
                          batch=8, max_seq=max_seq)
        requests = serve_requests(cfg)
        eng.submit(Request(prompt=requests[1][:64], max_new=8))   # warm-up
        eng.run()
        eng.reset()

        def serve():
            reqs = [eng.submit(Request(prompt=p, max_new=32)) for p in requests[:8]]
            t0 = time.perf_counter()
            steps = eng.run()
            torch.cuda.synchronize()
            return reqs, steps, time.perf_counter() - t0

        # end to end, switch off and on in turns over the same steps
        def decode_ms(n: int = 48) -> float:
            c = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
            tok = torch.tensor([1], device="cuda")
            with torch.inference_mode():
                M.decode_step(params, cfg, tok, c, 0)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for pos in range(1, n + 1):
                    logits, c = M.decode_step(params, cfg, tok, c, pos)
                    tok = torch.argmax(logits, dim=-1)
                torch.cuda.synchronize()
            return (time.perf_counter() - t) / n * 1e3

        ab = {"on": [], "off": []}
        for on in (False, True, True, False):
            if on:
                ab["on"].append(decode_ms())
            else:
                del os.environ["TPU_LLM_FFN_MEGAKERNEL"]
                ab["off"].append(decode_ms())
                os.environ["TPU_LLM_FFN_MEGAKERNEL"] = "1"
        # the device side of a decode step, switch on and off: K7 and K1
        groups = {"ffn_fused": ("ffn_tc_kernel",), "qmatmul": ("qmm_tc_kernel",)}
        prof = {"on": profile_decode(torch, params, cfg, max_seq, 16, groups)}
        del os.environ["TPU_LLM_FFN_MEGAKERNEL"]
        prof["off"] = profile_decode(torch, params, cfg, max_seq, 16, groups)
        os.environ["TPU_LLM_FFN_MEGAKERNEL"] = "1"
        (reqs, steps, wall), bcounts = drive_run(
            torch, "megakernel_dense_batch8", serve,
            ("qmatmul", "ffn_fused", "flash_decode_attention"), runs, total)
        if any(len(r.tokens) != 32 for r in reqs):
            fail("megakernel dense batch-8: a request gave too few tokens")
        decode_logits_vs_plain(torch, eng, params, cfg, requests, "dense_bf16_megakernel")
    row = dict(decode_tok_s=res.tokens_per_s, ttft_ms=res.ttft_s * 1e3, launches=counts,
               per_step=per_step, logits_err=lv["max_abs_err"], logits_tol=lv["tol"],
               batch8_tokens_per_s=sum(len(r.tokens) for r in reqs) / wall,
               batch8_engine_steps=steps, batch8_launches=bcounts,
               decode_ms_per_step_switch_off=ab["off"], decode_ms_per_step_switch_on=ab["on"],
               decode_tok_s_switch_off=[1e3 / m for m in ab["off"]],
               decode_tok_s_switch_on=[1e3 / m for m in ab["on"]],
               **{f"device_ms_per_step_switch_{k}": v.get("device_ms_per_step")
                  for k, v in prof.items()},
               **{f"{n}_per_step_switch_{k}": v.get(n) for k, v in prof.items()
                  for n in groups})
    emit("megakernel_full_width", **row)
    del eng, engine
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, row=row)


# -- phase 7b: f32 activations at full width (the `llm` CLI's default) --------------

def synth_dense_f32(torch, cfg, seed: int):
    """TinyLlama-shaped dense f32 weights built on the card from a seeded
    generator (std 0.02; fused wqkv / w13, per-layer list): what `llm
    --dtype f32` loads from an f32 GGUF."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    E, Fh, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim

    def w(K, N):
        return torch.randn((K, N), generator=g, device="cuda") * 0.02

    ones = lambda: torch.ones(E, device="cuda")  # noqa: E731
    layers = [{"attn_norm": ones(), "ffn_norm": ones(), "wqkv": w(E, E + 2 * KV),
               "wo": w(E, E), "w13": w(E, 2 * Fh), "w2": w(Fh, E)}
              for _ in range(cfg.n_layers)]
    return {"tok_emb": w(V, E), "final_norm": ones(), "wcls": w(E, V), "layers": layers}


def f32_full_width(torch):
    """TinyLlama-1.1B width and depth, dense f32 weights, f32 activations
    and cache (`llm`'s defaults --dtype f32 --cache-dtype f32), TF32 off:
    a 512-token prompt through Engine.generate, whose prefill takes K4 with
    f32 q over the f32 2048-row cache (its scores pass 64 MB), one launch a
    layer; the prefill profiled for K4's device ms; the first-token logits
    against the plain path."""
    import numpy as np

    from tpu_llm_torch.config import tinyllama_1_1b
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(tinyllama_1_1b(), rope_variant="neox")
    params = synth_dense_f32(torch, cfg, seed=9)
    max_seq = 2048
    engine = Engine(params, ModelAdapter.llama(cfg, torch.float32, bos_id=1, device="cuda"),
                    max_seq=max_seq, device="cuda")
    prompt512 = [int(t) for t in np.random.default_rng(13).integers(3, cfg.vocab_size, 511)]
    engine.generate(prompt512, n_new=2)          # warm-up: allocator, cuBLAS handles
    runs, total = {}, {n: 0 for n in counters()}
    res, counts = drive_run(torch, "f32_generate_512_16",
                            lambda: engine.generate(prompt512, n_new=16),
                            ("flash_gqa_attention", "flash_decode_attention"), runs, total)
    if counts["flash_gqa_attention"] != cfg.n_layers:
        fail(f"f32 512-token prefill: {counts['flash_gqa_attention']} K4 launches, "
             f"not one a layer ({cfg.n_layers})")
    ids = torch.tensor([[1] + prompt512], device="cuda")

    def prefill():
        c = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        with torch.inference_mode():
            M.forward(params, cfg, ids, c, 0)

    prof = profile_busy(torch, prefill, 1, {"flash_gqa_attention": ("flash_prefill",)})
    lv = logits_vs_plain(torch, "f32_full_width_512_first_token",
                         first_logits_fn(torch, params, cfg, ids, max_seq), rel_tol=1e-3)
    k4 = prof.get("flash_gqa_attention", {})
    row = dict(prompt_tokens=512, new_tokens=16, ttft_ms=res.ttft_s * 1e3,
               decode_tok_s=res.tokens_per_s, launches=counts,
               allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               k4_device_ms=k4.get("ms_per_step"), k4_launches_profiled=k4.get("launches_per_step"),
               prefill_device_ms=prof.get("device_ms_per_step"),
               logits_err=lv["max_abs_err"], logits_tol=lv["tol"],
               logits_top2_gap=lv["top2_gap"])
    emit("f32_full_width", **row)
    del engine, params
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, row=row)


# -- main --------------------------------------------------------------------------

# the case the `llm` CLI runs (bf16 q over its f32 cache), reported beside
# the serving pick as `cli_case`
CLI_CASES = {"flash_decode_attention": dict(cache="f32", pos=1000),
             "flash_gqa_attention": dict(T=512, cache="f32", q="bf16")}
# further cases reported beside the pick: K4 with f32 q, K1 at prefill rows
EXTRA_CASES = {"flash_gqa_attention": {"f32_q_case": dict(T=512, cache="f32", q="f32"),
                                       "f32_q_bf16_cache_case": dict(T=512, cache="bf16",
                                                                     q="f32")},
               "qmatmul": {"prefill_case": dict(weight="w13", kind="q4_0", rows=512),
                           "verify_window_case": dict(weight="w13", kind="q4_0", rows=5)},
               "paged_flash_decode_attention": {"batch1_case": dict(pool="bf16", B=1)},
               "paged_flash_decode_q": {"batch1_case": dict(pool="int8", B=1)}}

# what the paged cases report of their launch: splits, kernels a call
SPLIT_KEYS = ("n_split", "launches_per_call")

KERNELS = [
    ("qmatmul", "tpu_llm_torch/csrc/qmatmul.cu", "tpu_llm/quant/pallas_matmul.py:59",
     dict(weight="w13", kind="q4_0", rows=1)),
    ("flash_decode_attention", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:121", dict(cache="bf16")),
    ("flash_decode_fused", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:801", dict(pos=1000)),
    ("flash_gqa_attention", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:51", dict(T=512, cache="bf16", q="bf16")),
    ("paged_flash_decode_attention", "tpu_llm_torch/csrc/paged_attention.cu",
     "tpu_llm/ops/flash_attention.py:264", dict(pool="bf16", B=8)),
    ("paged_flash_decode_q", "tpu_llm_torch/csrc/paged_attention.cu",
     "tpu_llm/ops/flash_attention.py:439", dict(pool="int8", B=8)),
    ("ffn_fused", "tpu_llm_torch/csrc/ffn.cu", "tpu_llm/quant/pallas_ffn.py:49",
     dict(kind="q4_0", rows=1)),
]


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    if not os.path.isdir(os.path.join(ROOT, "tpu_llm_torch", "csrc")):
        fail(f"{ROOT} is not a checkout of the repository (no tpu_llm_torch/csrc)")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    from tpu_llm_torch.kernels import build

    t0 = time.perf_counter()
    build.lib()
    emit("device", nvidia_smi=smi_line, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         built_here=build.build_seconds is not None)

    timer = Timer(torch)
    cases = check_kernels(torch, timer)
    with tempfile.TemporaryDirectory() as tmp:
        check_cli(tmp)
        check_scan_cli(tmp)
        check_serve_cli(tmp)
    fw, params, cfg = full_width(torch)
    emit("full_width", **{k: v for k, v in fw.items() if k != "runs"})
    sc = scan_full_width(torch, params, cfg)
    emit("scan_full_width", **{k: v for k, v in sc.items() if k != "runs"})
    sv = serve_full_width(torch, params, cfg)
    mk = megakernel_full_width(torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    f32 = f32_full_width(torch)
    kq = kquant_full_width(torch)
    phases = (fw, sc, sv, mk, f32, kq)
    total = {k: sum(ph["total"][k] for ph in phases) for k in fw["total"]}

    def case(name, pick):
        return next(c for c in cases[name] if all(c.get(k) == v for k, v in pick.items()))

    out = []
    for name, source, replaces, pick in KERNELS:
        rep = case(name, pick)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total[name],
            "max_abs_err": rep["max_abs_err"],
            "max_abs_err_all_cases": max(c["max_abs_err"] for c in cases[name]),
            "n_diff": rep["n_diff"], "n_out": rep["n_out"],
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "case": pick,
        })
        if name in sc["row"]["replay_launches"]:   # the part of `launches` graph replays made
            out[-1]["graph_replay_launches"] = sc["row"]["replay_launches"][name]
        if name == "qmatmul":     # every kind at w13, one row: ms / bound / error
            out[-1]["w13_1row"] = {
                f"{c['kind']}/{c['planes']}": [c["kernel_ms"], c["bound_ms"], c["max_abs_err"]]
                for c in cases[name] if c["weight"] == "w13" and c["rows"] == 1}
        if name == "ffn_fused":
            out[-1]["unfused_ms"] = rep["unfused_ms"]
        out[-1].update({k: rep[k] for k in SPLIT_KEYS if k in rep})
        extra = dict(EXTRA_CASES.get(name, {}))
        if name in CLI_CASES:
            extra["cli_case"] = CLI_CASES[name]
        for key, pick_x in extra.items():
            c = case(name, pick_x)
            out[-1][key] = dict(
                {k: c[k] for k in ("max_abs_err", "n_diff", "n_out", "plain_ms", "library_ms",
                                   "bound_ms", "bound_by", *SPLIT_KEYS) if k in c},
                ms=c["kernel_ms"], case=pick_x)
    print(smi_line)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
