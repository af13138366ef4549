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
   at 1 and 8 rows, timed beside the unfused path it replaces. llm-bench's
   new shapes: K1 at Llama-2 7B's five projections, one row, on int4
   planes (the kernels line's `*_7b_case`), and at TinyLlama's w13 with
   the 40 rows of a k = 4 verify window at batch 8
   (`verify_window_b8_case`); K2 at D 128 with 32 kv heads and one q head
   a kv head, bf16 over a bf16 1024-row cache at position 1000
   (`llama2_7b_case`); K5 over bf16 pools of 64-row blocks
   (`bs64_case`). The other llama-family shapes (check_family_shapes): K1
   through a Mixtral-8x7B expert slice picked by a device index (w1e and
   w2e, `mixtral_w*e_slice_case`, the slice's copy timed beside it) and at
   Qwen2-7B's wqkv with f32 and bf16 rows (`qwen2_wqkv*_case`); K2, K3,
   K4 and K5 at phi-2's head width 80 (`phi2_d80_case`, f32 q); K2 at
   Qwen2-7B's 28/4 heads (`qwen2_g7_case`).
3. cli — the port's `llm` CLI on tiny GGUFs written here with the port's
   own writer (f32 and Q4_0 with --dtype f32 and native; Q4_K and Q6_K
   native; Q4_K native --fold-norms; Q4_0 native with
   TPU_LLM_FFN_MEGAKERNEL set; Q4_0 native over the int8 cache), on the
   card and on the CPU: the greedy text must be identical, and the card
   runs must launch K1 (and K7); then `--profile DIR` on the card, whose
   Chrome trace must hold K1's kernel by name (up to three runs for a
   trace with kernels in it; none fails). Phase cli_filters: `llm` with
   --top-k 40 --top-p 0.9 --min-p 0.05 -t 0.8 --repeat-penalty 1.1 on the
   tiny Q4_0 file, card and CPU: both run, and the tokens the filters keep
   at the first sampled step are the same set on both (the sampled
   streams, one generator a device, are not compared).
   Phase scan_cli: --scan (the captured CUDA graph), --spec 3, --scan
   --spec 3 and --spec 3 --draft on a tiny Q4_0 file with the bigram bias,
   and --scan on a tiny Q8_0 file with TPU_LLM_FFN_MEGAKERNEL set (K7
   replayed inside the graph), card against CPU.
4. serve_cli — the port's `llm-serve` on the tiny f32 GGUF and, native,
   the tiny Q4_K and Q6_K ones: dense, --paged, --paged --cache-dtype
   int8, dense --cache-dtype int8, --spec 3 and --spec 3 --draft (the file
   itself), on the card and on the CPU: the same completions. Phase
   serve_cli_filters: every request with the same sampling filters, card
   and CPU: each prompt's first-step kept set equal.
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
6b. server — `llm-server` (tpu_llm_torch/runtime/server.py) in this
   process on an ephemeral localhost port over the phase-5 weights, with a
   32000-id character vocabulary (one token a character), first on the
   PagedEngine (bf16 pools, block 16), then on the dense BatchEngine (bf16
   cache), batch 8, max_seq 1024: 16 concurrent greedy /v1/completions
   (serve_requests' prompts, 8 sharing a 256-token prefix; 64 tokens
   each) from client threads, equal to a fresh engine driven directly with
   the same requests in the server's order of admission; one streamed
   completion equal to its blocking twin and ending in [DONE]; on the
   paged engine also a zephyr chat completion, logprobs 5 (each chosen
   token's logprob within 4e-2 * max|logit| of the plain path's
   log-softmax, the top-1 alternative the token itself), top_k 1 at
   temperature 1 equal to greedy, repetition_penalty 1.3 equal to a
   plain-path loop that applies the penalty step by step over 16 tokens,
   and /v1/embeddings of a 512-token input (cosine >= 0.999 against the
   plain path). The phase's launches must hold K1, K5 and K4 (paged;
   K4 from the long prefills) and K2 (dense); it prints the client's
   aggregate tokens/s, the server's TTFT p50 and the engine's own tokens/s
   on the same requests, beside the card's name and power limit.
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
   max|logit| (the bf16 paths' logits: 2e-2). Then the same prompt over
   the dense int8 cache (`llm --cache-dtype int8`): the prefill
   dequantizes the planes to bf16 for K4 (22 launches), its first-token
   logits held against the plain path at 2e-2 * max|logit|.
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
9b. families full width — phi-2 2.7B (full depth), Mixtral-8x7B (all 32
   layers, 8 experts top-2), Qwen2-7B (QKV biases, YaRN factor 4 over
   32768) and Gemma-2B (head_dim 256, GeGLU, tied 256000-wide classifier),
   random q4_0 weights in the loaders' layouts drawn on the card: a
   16-token prompt and 64 greedy tokens through Engine.generate, the step
   loop and the captured graph (--scan), every token held against a
   teacher-forced plain-path forward (its argmax, or within 2e-2 *
   max|logit| of it: a near-tie); the first-token logits with f32
   activations against the plain path at 1e-3 * max|logit|; TTFT of a
   512-token prompt; peak memory; each run's launches (gemma: no K2 / K4,
   its head width takes the plain route as in the JAX package; with the
   megakernel switch on, no K7 for gemma, phi-2 or Mixtral). Mixtral also
   decodes at batch 1, 2 and 8, one strategy of the MoE FFN each (gather,
   union, dense masked): tokens/s, K1 launches a step as the strategy
   predicts, logits against the plain path.
10. bench_cli — the port's `llm-bench` in-process on the card, each row
   on a line of its own: bf16 / q8_0 / q4_0 decode and TTFT (32 steps, 3
   TTFT samples); q4_0 with a 512-token prompt over 2048 rows (K4 takes
   the TTFT prefill); q6_k and q4_k; q4_0 over the int8 cache; Llama-2 7B
   q4_0 and bf16 (16 steps); --paged at batch 8 over 64-row blocks beside
   the dense cache; --spec (the BatchEngine host loop, batch 1 and 8,
   plain and k = 4, with tokens per verify forward); phi2, phi2_q4_0 and
   moe_q4_0 (32 steps). Each invocation is a
   main-path run with the kernels it must launch; then one step of the
   7b_q4_0 program (K1 at the 7B projections, K2 at D 128) held against
   the plain path.
Each main-path run starts with every launch count at 0 and reads the
counts after; a kernel of the path that never launched fails the run.

The last lines: the card's name and power limit, the kernels JSON, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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
BENCH_VERIFY_ROWS = 8 * (SPEC_K + 1)     # llm-bench --spec's verify window at batch 8


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
    # Llama-2 7B's projections (llm-bench's 7b rows), read only below
    shapes_7b = {f"{n}_7b": kn for n, kn in (
        ("wqkv", (4096, 12288)), ("wo", (4096, 4096)), ("w13", (4096, 22016)),
        ("w2", (11008, 4096)), ("wcls", (4096, 32000)))}
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
    # Llama-2 7B: every projection at one row (its int4 planes, what
    # llm-bench's 7b_q4_0 row decodes over); and w13 at the 40 rows of
    # llm-bench --spec's verify windows (k = 4 at batch 8, q4_0)
    runs += [(n, "q4_0i4<q4_0", "f32", 1) for n in shapes_7b]
    runs += [("w13", "q4_0", "f32", BENCH_VERIFY_ROWS)]
    shapes.update(shapes_7b)
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
        out_dtype = torch.float32 if wname.startswith("wcls") else torch.bfloat16
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
    # K2 at Llama-2 7B's shapes (llm-bench's 7b rows): D 128, 32 kv heads,
    # one q head a kv head, bf16 q over a bf16 (1, 1024, 4096) cache
    H7, D7, S7, pos7 = 32, 128, 1024, 1000
    k7, v7 = (torch.randn((B, S7, H7 * D7), generator=g, device=dev).bfloat16()
              for _ in range(2))
    q7 = torch.randn((B, 1, H7, D7), generator=g, device=dev).bfloat16()
    p7 = torch.tensor([pos7], dtype=torch.int32, device=dev)
    info = dict(B=B, H=H7, Hkv=H7, D=D7, S=S7, pos=pos7, q="bf16", cache="bf16",
                n_split=FA.decode_splits(B, H7, S7)[1])
    got = FA.flash_decode_attention(q7, k7, v7, p7)
    err, tol = compare("flash_decode_attention", got,
                       FA.flash_decode_attention_plain(q7, k7, v7, p7), True, **info)
    k74, v74 = (c.view(B, S7, H7, D7)[:, :pos7 + 1].transpose(1, 2) for c in (k7, v7))
    record("flash_decode_attention", info, err, tol,
           timer.ms(lambda: FA.flash_decode_attention(q7, k7, v7, p7)),
           timer.ms(lambda: FA.flash_decode_attention_plain(q7, k7, v7, p7)),
           timer.ms(lambda: F.scaled_dot_product_attention(q7.transpose(1, 2), k74, v74)),
           nbytes(q7) * 2 + 2 * B * (pos7 + 1) * H7 * D7 * 2,
           4.0 * B * H7 * (pos7 + 1) * D7, "bf16")
    del k7, v7, k74, v74
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
    check_family_shapes(torch, timer, g, compare, record)
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
             ("paged_flash_decode_attention", "bf16", 64),      # llm-bench --paged
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


def check_family_shapes(torch, timer, g, compare, record):
    """The shapes the other llama-family models give the kernels. K1: one
    row through an expert slice picked by a device index out of stacked
    Mixtral-8x7B planes (w1e 4096x14336, w2e 14336x4096, 8 experts, the
    copy _expert_slice makes timed beside it), and Qwen2-7B's wqkv
    3584x4608 with f32 rows (its f32 biases promote the activations to f32,
    as in the JAX package) and bf16 rows. Head width 80 (phi-2: 32 heads, one
    q head a kv head), f32 q as phi-2's biases leave it: K2 and K3 over the
    `llm` CLI's f32 (1, 2048, 2560) cache at position 1000, K4 with a
    512-token prompt over it, K5 over bf16 pools of 16-row blocks at batch
    8 (positions PAGED_POS). K2 at Qwen2-7B's 28/4 heads (G 7, D 128), f32
    q over an f32 cache. Library: torch._weight_int4pack_mm (bf16 rows)
    and F.scaled_dot_product_attention in q's dtype."""
    from tpu_llm_torch.models.llama import _expert_slice
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.quant.qmatmul import qmatmul, qmatmul_plain
    from tpu_llm_torch.quant.qtensor import qmap

    F = torch.nn.functional
    dev = "cuda"
    e = torch.tensor(5, device=dev)
    for wname, (K, N) in (("mixtral_w1e_slice", (4096, 14336)),
                          ("mixtral_w2e_slice", (14336, 4096)), ("qwen2_wqkv", (3584, 4608))):
        for xdt in ((torch.bfloat16,) if wname.startswith("mixtral")
                    else (torch.float32, torch.bfloat16)):
            info = dict(weight=wname, kind="q4_0", planes="f32", rows=1, K=K, N=N,
                        x=str(xdt).replace("torch.", ""), out=str(xdt).replace("torch.", ""),
                        row_scale=False)
            if wname.startswith("mixtral"):
                stack = qmap(lambda *ps: torch.stack(ps), *[
                    random_qtensor(torch, g, "q4_0", K, N) for _ in range(8)])
                w = _expert_slice(stack, e)
                info.update(experts=8, slice_copy_ms=timer.ms(lambda: _expert_slice(stack, e)),
                            slice_copy_bytes=w.nbytes)
                del stack
            else:
                w = random_qtensor(torch, g, "q4_0", K, N)
            x = torch.randn((1, K), generator=g, device=dev).to(xdt)
            got = qmatmul(x, w)
            want = qmatmul_plain(x, w)
            err, tol = compare("qmatmul", got, want, xdt == torch.bfloat16, **info)
            lib_ms = int4pack_ms(torch, timer, x.bfloat16(), w, want, info)
            record("qmatmul", info, err, tol, timer.ms(lambda: qmatmul(x, w)),
                   timer.ms(lambda: qmatmul_plain(x, w)), lib_ms,
                   w.nbytes + nbytes(x) + N * got.element_size(), 2.0 * K * N, "bf16")
            del w

    # head width 80: phi-2's 32/32 heads over the CLI's f32 cache
    B, H, Hkv, D, S, pos = 1, 32, 32, 80, 2048, 1000
    kc, vc = (torch.randn((B, S, Hkv * D), generator=g, device=dev) for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g, device=dev)
    k_cur, v_cur = (torch.randn((B, 1, Hkv * D), generator=g, device=dev) for _ in range(2))
    p = torch.tensor([pos], dtype=torch.int32, device=dev)
    k4, v4 = (c.view(B, S, Hkv, D)[:, :pos + 1].transpose(1, 2) for c in (kc, vc))
    sdpa = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k4, v4)  # noqa: E731
    info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, pos=pos, q="f32", cache="f32",
                n_split=FA.decode_splits(B, Hkv, S)[1])
    got = FA.flash_decode_attention(q, kc, vc, p)
    err, tol = compare("flash_decode_attention", got,
                       FA.flash_decode_attention_plain(q, kc, vc, p), False, **info)
    record("flash_decode_attention", info, err, tol,
           timer.ms(lambda: FA.flash_decode_attention(q, kc, vc, p)),
           timer.ms(lambda: FA.flash_decode_attention_plain(q, kc, vc, p)), timer.ms(sdpa),
           nbytes(q) * 2 + 2 * B * (pos + 1) * Hkv * D * 4, 4.0 * B * H * (pos + 1) * D, "f32")
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got, _, _ = FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)
    want, _, _ = FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)
    err, tol = compare("flash_decode_fused", got, want, False, **info)
    if not (torch.equal(k1[:, pos], k_cur[:, 0]) and torch.equal(v1[:, pos], v_cur[:, 0])):
        fail(f"flash_decode_fused {info}: row pos is not this step's k/v")
    record("flash_decode_fused", info, err, tol,
           timer.ms(lambda: FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)),
           timer.ms(lambda: FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)),
           timer.ms(sdpa), nbytes(q) * 2 + 2 * B * pos * Hkv * D * 4 + nbytes(k_cur, v_cur)
           + 2 * Hkv * D * 4, 4.0 * B * H * (pos + 1) * D, "f32")
    del k1, v1, k2, v2
    T = 512
    qp = torch.randn((B, T, H, D), generator=g, device=dev)
    kp4, vp4 = (c.view(B, S, Hkv, D) for c in (kc, vc))
    info = dict(B=B, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=0, q="f32", cache="f32")
    got = FA.flash_gqa_attention(qp, kp4, vp4, 0)
    err, tol = compare("flash_gqa_attention", got,
                       FA.flash_gqa_attention_plain(qp, kp4, vp4, 0), False, **info)
    qt = qp.transpose(1, 2)
    kt, vt = kp4[:, :T].transpose(1, 2), vp4[:, :T].transpose(1, 2)
    record("flash_gqa_attention", info, err, tol,
           timer.ms(lambda: FA.flash_gqa_attention(qp, kp4, vp4, 0)),
           timer.ms(lambda: FA.flash_gqa_attention_plain(qp, kp4, vp4, 0)),
           timer.ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)),
           nbytes(qp) * 2 + 2 * B * T * Hkv * D * 4, 4.0 * B * H * D * T * (T + 1) / 2, "f32")
    del kc, vc, kp4, vp4, k4, v4, kt, vt

    # K5 at head width 80: f32 q over bf16 pools (llm-serve's cache dtype)
    BS, MB = 16, 1024 // 16
    Bp = len(PAGED_POS)
    Np = 1 + Bp * MB
    pos8 = torch.tensor(PAGED_POS, dtype=torch.int32, device=dev)
    table = (torch.randperm(Np - 1, generator=torch.Generator().manual_seed(80)) + 1)
    table = table.reshape(Bp, MB).to(device=dev, dtype=torch.int32)
    kpool, vpool = (torch.randn((Np, BS, Hkv * D), generator=g, device=dev).bfloat16()
                    for _ in range(2))
    q8 = torch.randn((Bp, 1, H, D), generator=g, device=dev)
    args = (q8, kpool, vpool, table, pos8)
    info = dict(B=Bp, H=H, Hkv=Hkv, D=D, BS=BS, MB=MB, pool="bf16", q="f32",
                positions=PAGED_POS, n_split=FA.decode_splits(Bp, Hkv, MB * BS)[1])
    got = FA.paged_flash_decode_attention(*args)
    err, tol = compare("paged_flash_decode_attention", got,
                       FA.paged_flash_decode_attention_plain(*args), True, **info)
    rows_read = sum(x + 1 for x in PAGED_POS)
    gk, gv = (pl[table.long()].reshape(Bp, MB * BS, Hkv, D).transpose(1, 2).float()
              for pl in (kpool, vpool))
    mask = (torch.arange(MB * BS, device=dev)[None, :]
            <= pos8[:, None].long())[:, None, None, :]
    qs = q8.transpose(1, 2)
    record("paged_flash_decode_attention",
           dict(info, library="sdpa over pre-gathered rows (gather not timed)"), err, tol,
           timer.ms(lambda: FA.paged_flash_decode_attention(*args)),
           timer.ms(lambda: FA.paged_flash_decode_attention_plain(*args)),
           timer.ms(lambda: F.scaled_dot_product_attention(qs, gk, gv, attn_mask=mask)),
           nbytes(q8) * 2 + 2 * rows_read * Hkv * D * 2
           + sum(4 * (x // BS + 1) for x in PAGED_POS), 4.0 * H * D * rows_read, "f32")
    del kpool, vpool, gk, gv

    # K2 at Qwen2-7B's 28/4 heads (G 7), f32 q over the CLI's f32 cache
    H, Hkv, D = 28, 4, 128
    kc, vc = (torch.randn((B, S, Hkv * D), generator=g, device=dev) for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g, device=dev)
    info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, pos=pos, q="f32", cache="f32",
                n_split=FA.decode_splits(B, Hkv, S)[1])
    got = FA.flash_decode_attention(q, kc, vc, p)
    err, tol = compare("flash_decode_attention", got,
                       FA.flash_decode_attention_plain(q, kc, vc, p), False, **info)
    k4, v4 = (c.view(B, S, Hkv, D)[:, :pos + 1].transpose(1, 2) for c in (kc, vc))
    record("flash_decode_attention", info, err, tol,
           timer.ms(lambda: FA.flash_decode_attention(q, kc, vc, p)),
           timer.ms(lambda: FA.flash_decode_attention_plain(q, kc, vc, p)),
           timer.ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k4, v4,
                                                           enable_gqa=True)),
           nbytes(q) * 2 + 2 * B * (pos + 1) * Hkv * D * 4, 4.0 * B * H * (pos + 1) * D, "f32")


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


# the sampling controls' runs of the cli and serve_cli phases
FILTER_FLAGS = ["--top-k", "40", "--top-p", "0.9", "--min-p", "0.05", "-t", "0.8"]


def kept_sets_step0(torch, path: str, dtype: str, texts, device: str,
                    repeat_penalty: float = 1.0):
    """The tokens FILTER_FLAGS keep at a prompt's first sampled step (the
    filtered distribution's support after the repetition penalty over
    BOS + prompt), one set a prompt, computed on ``device``."""
    import numpy as np

    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.ops.sampling import filtered_probs
    from tpu_llm_torch.runtime.batching import _apply_penalties
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    gguf = GGUFFile(path)
    params, cfg = M.load_gguf(gguf, dtype_policy=dtype, device=device)
    tok = BPETokenizer.from_gguf(gguf)
    out = []
    with torch.inference_mode():
        for text in texts:
            ids = [1] + tok.encode(text)
            cache = M.init_cache(cfg, 1, 64, torch.float32, device)
            x, _ = M.forward(params, cfg, torch.tensor([ids], device=device), cache, 0)
            logits = M.lm_head(params, cfg, x[:, -1:])[:, 0]
            counts = torch.from_numpy(np.bincount(ids, minlength=cfg.vocab_size)[None]).to(device)
            one = lambda v: torch.tensor([v], device=device)  # noqa: E731
            logits = _apply_penalties(logits, counts, one(0.0), one(0.0), one(repeat_penalty))
            probs = filtered_probs(logits, 0.8, 40, 0.9, 0.05)
            out.append(sorted(int(i) for i in torch.nonzero(probs[0] > 0).flatten()))
    return out


def check_cli_filters(torch, path: str):
    """`llm` with the sampling filters and a repetition penalty on the card
    and on the CPU: both run (K1 launched on the card), and both keep the
    same tokens at the first sampled step; the sampled streams (one
    generator on each device) are not compared."""
    args = ["-m", path, "-p", "abc", "-n", "12", "--dtype", "native", *FILTER_FLAGS,
            "--repeat-penalty", "1.1", "--seed", "3"]
    reset_counts()
    card = run_cli(args + ["--device", "cuda"]).split(b"\n")[0]
    counts = read_counts()
    cpu = run_cli(args + ["--device", "cpu"]).split(b"\n")[0]
    kept = {d: kept_sets_step0(torch, path, "native", ["abc"], d, 1.1) for d in ("cuda", "cpu")}
    row = dict(model=os.path.basename(path), flags=args[6:], cuda=card.decode(errors="replace"),
               cpu=cpu.decode(errors="replace"), kept_step0=kept["cuda"],
               kept_equal=kept["cuda"] == kept["cpu"], launches={k: v for k, v in counts.items()
                                                                 if v})
    emit("cli_filters", **row)
    if not (card.startswith(b"abc") and cpu.startswith(b"abc") and len(card) > 3):
        fail(f"llm with the sampling filters printed no stream: {row}")
    if kept["cuda"] != kept["cpu"] or len(kept["cuda"][0]) < 2:
        fail(f"llm's first-step kept set differs between card and CPU: {row} {kept}")
    if counts["qmatmul"] <= 0:
        fail("llm with the sampling filters: qmatmul was never launched")


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
    import torch

    check_cli_filters(torch, os.path.join(tmp, "tiny_q4_0.gguf"))
    # --cache-dtype int8 (the dense QuantKV cache), and --profile DIR: a
    # Chrome trace that holds the card's kernels by name
    results.append(cli_card_vs_cpu(os.path.join(tmp, "tiny_q4_0.gguf"), "native",
                                   ["--cache-dtype", "int8"], must=("qmatmul",)))
    prof = os.path.join(tmp, "profile")
    # the profiler's device trace now and then comes back empty
    # (launches_per_call): up to three runs for one with kernels, which
    # must hold K1's
    for tries in range(1, 4):
        out = run_cli(["-m", os.path.join(tmp, "tiny_q4_0.gguf"), "-p", "abc", "-n", "12",
                       "--dtype", "native", "--profile", prof, "--device", "cuda"])
        with open(os.path.join(prof, "trace.json")) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        if events:
            break
    kernels = {e["name"] for e in events}
    emit("cli_profile", last_line=out.decode().splitlines()[-1], tries=tries,
         kernel_events=len(events), qmm=sorted(k[:60] for k in kernels if "qmm" in k))
    if not kernels:
        fail("llm --profile: the trace held no kernel in 3 runs")
    if not any("qmm" in k for k in kernels):
        fail(f"llm --profile: no qmatmul kernel in the trace ({sorted(kernels)[:20]})")
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
               "paged_int8": ["--paged", "--cache-dtype", "int8"],
               "dense_int8": ["--cache-dtype", "int8"], "spec": ["--spec", "3"],
               # --draft: the served file itself
               "spec_draft": ["--spec", "3", "--draft", None]}


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
            flags = [path if f is None else f for f in flags]
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
    # each request with the sampling filters, card and CPU: the same tokens
    # kept at every prompt's first sampled step (streams not compared)
    import torch

    path, prompts = files[0][0], ["abc", "ab", "abc abc ab", "abc abc b"]
    argv = ["-m", path, *[a for p in prompts for a in ("-p", p)], "-n", "6", "--batch", "2",
            "--dtype", "f32", *FILTER_FLAGS]
    card, _ = run_serve_cli(argv + ["--device", "cuda"])
    cpu, _ = run_serve_cli(argv + ["--device", "cpu"])
    kept = {d: kept_sets_step0(torch, path, "f32", prompts, d) for d in ("cuda", "cpu")}
    row = dict(model=os.path.basename(path), flags=FILTER_FLAGS,
               cuda=[r["completion"] for r in card], cpu=[r["completion"] for r in cpu],
               kept_step0=kept["cuda"], kept_equal=kept["cuda"] == kept["cpu"])
    emit("serve_cli_filters", **row)
    if len(card) != 4 or any(r["n_tokens"] != 6 for r in card + cpu):
        fail(f"serve_cli with the sampling filters: {row}")
    if kept["cuda"] != kept["cpu"] or any(len(k) < 2 for k in kept["cuda"]):
        fail(f"serve_cli's first-step kept sets differ between card and CPU: {row}")


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


# -- phase 6b: llm-server over HTTP at full width ---------------------------------------

SERVER_NEW = 64          # max_tokens of the phase's completions
# the characters the phase's prompts are written in: one token each in
# server_tokenizer's vocabulary
SERVER_CHARS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .,;:!?-"


def server_tokenizer(torch, vocab: int):
    """A BPE vocabulary of ``vocab`` ids for the random model: <unk>, <s>,
    </s>, zephyr's <|user|> / <|assistant|> (control tokens), one token a
    character of SERVER_CHARS (no merges: a prompt of n characters is n
    tokens), and fillers that no text encodes to (they start with \\x01)
    but that decode, so every id the model emits has text."""
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    head = [b"<unk>", b"<s>", b"</s>", b"<|user|>", b"<|assistant|>", b"\n"]
    chars = [c.encode() for c in SERVER_CHARS]
    tokens = head + chars + [b"\x01%05d" % i for i in range(vocab - len(head) - len(chars))]
    types = [2, 3, 3, 3, 3] + [1] * (vocab - 5)
    return BPETokenizer(tokens, [0.0] * vocab, token_types=types)


def server_prompts(cfg):
    """serve_requests' 16 prompts as text: 8 sharing a 256-token prefix
    with 32-200-token tails, 8 distinct of 64-512 tokens."""
    n = len(SERVER_CHARS)
    return ["".join(SERVER_CHARS[t % n] for t in p) for p in serve_requests(cfg)]


def http(port: int, path: str, body=None, timeout: float = 300.0):
    """(status, JSON) of a GET (body None) or POST to the local server."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_stream(port: int, path: str, body, timeout: float = 300.0):
    """(events, last data line) of a stream=true POST."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    events, last = [], None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.strip()
            if line.startswith(b"data: "):
                last = line
                if line != b"data: [DONE]":
                    events.append(json.loads(line[6:]))
    return events, last


def concurrent_completions(port: int, prompts, max_tokens: int):
    """Every prompt as a greedy /v1/completions from a client thread of its
    own, all at once: (responses, client wall seconds)."""
    import threading

    out = [None] * len(prompts)

    def go(i):
        out[i] = http(port, "/v1/completions", {"prompt": prompts[i], "max_tokens": max_tokens})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(r is None or r[0] != 200 for r in out):
        fail(f"server: a concurrent completion failed: {[r and r[0] for r in out]}")
    return [r[1] for r in out], wall


def offline_tokens(torch, make, warm, reqs):
    """The token lists of ``reqs`` ((prompt ids, max_new) in the order the
    server admitted them) through a fresh engine driven directly after the
    server's warm-up request ``warm`` (its blocks stay in a paged engine's
    prefix cache), and the engine's tokens/s over them."""
    from tpu_llm_torch.runtime.batching import Request

    eng = make()
    eng.submit(Request(prompt=warm[0], max_new=warm[1]))
    eng.run()
    subs = [eng.submit(Request(prompt=ids, max_new=n)) for ids, n in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = [r.tokens for r in subs]
    del eng
    torch.cuda.empty_cache()
    return toks, sum(len(t) for t in toks) / wall


class Server:
    """serve() in this process on an ephemeral port, its HTTP loop on a
    thread; ``close`` stops both and fails the smoke if the serving loop
    died or restarted on the way."""

    def __init__(self, engine, tokenizer, embedder=None):
        import threading

        from tpu_llm_torch.runtime.server import serve

        self.httpd, self.loop = serve(engine, tokenizer, "127.0.0.1", 0, max_new_cap=1022,
                                      timeout_s=300.0, model_name="tinyllama-1.1b-random",
                                      embedder=embedder)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self, label: str):
        alive, restarts = self.loop.is_alive(), self.loop.n_restarts
        self.httpd.shutdown()
        self.httpd.server_close()
        self.loop.shutdown()
        self.thread.join(timeout=30)
        if not alive or restarts or self.loop.is_alive() or self.thread.is_alive():
            fail(f"server {label}: serving loop alive={alive} restarts={restarts}, "
                 f"stopped={not self.loop.is_alive()}")


def plain_sequence_logits(torch, params, cfg, ids):
    """(T, V) logits of every position of ``ids`` through the plain path
    (one prefill over a bf16 dense cache)."""
    from tpu_llm_torch.models import llama as M

    with torch.inference_mode(), plain_path():
        cache = M.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")
        x, _ = M.forward(params, cfg, torch.tensor([ids], device="cuda"), cache, 0)
        return M.lm_head(params, cfg, x)[0]


def plain_penalised_greedy(torch, params, cfg, ids, n: int, rp: float):
    """``n`` greedy tokens after ``ids`` with the repetition penalty over
    the text so far applied before every argmax (batching._apply_penalties),
    step by step through the plain path; and the smallest top-2 gap."""
    import numpy as np

    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.batching import _apply_penalties

    one = lambda v: torch.tensor([v], device="cuda")  # noqa: E731
    out, gaps = [], []
    with torch.inference_mode(), plain_path():
        cache = M.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")
        x, cache = M.forward(params, cfg, torch.tensor([ids], device="cuda"), cache, 0)
        logits = M.lm_head(params, cfg, x[:, -1:])[:, 0]
        ctx = list(ids)
        for i in range(n):
            counts = torch.from_numpy(np.bincount(ctx, minlength=cfg.vocab_size)[None]).to("cuda")
            slog = _apply_penalties(logits, counts, one(0.0), one(0.0), one(rp))
            top2 = torch.topk(slog[0], 2).values
            gaps.append((top2[0] - top2[1]).item())
            tok = int(slog[0].argmax())
            out.append(tok)
            ctx.append(tok)
            if i + 1 < n:
                logits, cache = M.decode_step(params, cfg, torch.tensor([tok], device="cuda"),
                                              cache, len(ctx) - 1)
    return out, min(gaps)


def server_full_width(torch, params, cfg, engine_rows):
    """Phase server: llm-server over HTTP in this process at TinyLlama-1.1B
    width (the phase-5 weights), on the paged engine (bf16 pools, block
    16) and then the dense engine (bf16 cache), batch 8, max_seq 1024."""
    from tpu_llm_torch.runtime.batching import BatchEngine
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.paged_engine import PagedEngine
    from tpu_llm_torch.runtime.server import Embedder

    tok = server_tokenizer(torch, cfg.vocab_size)
    prompts = server_prompts(cfg)
    ids = [tok.encode(p) for p in prompts]
    if [len(i) for i in ids] != [len(p) for p in prompts]:
        fail("server: the phase's prompts do not encode one token a character")
    engines = {
        # a pool that never evicts: the prefix cache's hits depend only on
        # the order of admission, which the offline run repeats
        "paged_bf16_bs16": (lambda: PagedEngine(params, cfg, batch=8, block_size=16,
                                                max_seq=1024, n_blocks=1 + 16 * (1024 // 16),
                                                cache_dtype=torch.bfloat16, device="cuda"),
                            ("qmatmul", "paged_flash_decode_attention", "flash_gqa_attention")),
        "dense_bf16": (lambda: BatchEngine(params, ModelAdapter.llama(
            cfg, torch.bfloat16, bos_id=1, device="cuda"), batch=8, max_seq=1024),
            ("qmatmul", "flash_decode_attention")),
    }
    runs, total = {}, {n: 0 for n in counters()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for label, (make, must) in engines.items():
        paged = label.startswith("paged")
        eng = make()
        embedder = Embedder(params, ModelAdapter.llama(cfg, device="cuda"), max_len=512) \
            if paged else None
        srv = Server(eng, tok, embedder)
        http(srv.port, "/v1/completions", {"prompt": prompts[1][:64], "max_tokens": 8})  # warm-up
        row = dict(engine=label, nvidia_smi=smi)
        reset_counts()
        # 16 concurrent greedy completions
        outs, wall = concurrent_completions(srv.port, prompts, SERVER_NEW)
        gen = sum(o["n_tokens"] for o in outs)
        ttfts = sorted(o["ttft_s"] for o in outs)
        # TTFT as the server reports it (ttft_s: from the request's arrival
        # in the serving loop's queue to its first token)
        row.update(requests=len(outs), generated_tokens=gen, client_wall_s=wall,
                   client_tokens_per_s=gen / wall,
                   server_ttft_p50_ms=ttfts[len(ttfts) // 2] * 1e3)
        # one streamed completion against its blocking twin
        events, last = http_stream(srv.port, "/v1/completions",
                                   {"prompt": prompts[3], "max_tokens": 32})
        _, blocking = http(srv.port, "/v1/completions", {"prompt": prompts[3], "max_tokens": 32})
        streamed = [e["token"] for e in events[:-1]]
        row["stream"] = dict(tokens=len(streamed), equal=streamed == blocking["tokens"],
                             done=last == b"data: [DONE]")
        if not (row["stream"]["equal"] and row["stream"]["done"] and len(streamed) == 32):
            fail(f"server {label}: the stream differs from the blocking response: {row}")
        # the order the server admitted the requests in (rid order), for
        # the offline run
        order = sorted(range(len(outs)), key=lambda i: int(outs[i]["id"].split("-")[1]))
        checks = {}
        if paged:
            chat = [{"role": "user", "content": prompts[5][:40]}]
            st, ch = http(srv.port, "/v1/chat/completions",
                          {"messages": chat, "max_tokens": 16, "chat_template": "zephyr"})
            checks["chat"] = dict(status=st, object=ch.get("object"),
                                  finish=ch["choices"][0]["finish_reason"],
                                  n_tokens=ch["n_tokens"])
            if st != 200 or ch["object"] != "chat.completion" or \
                    ch["choices"][0]["message"]["role"] != "assistant":
                fail(f"server: chat completion {checks['chat']}")
            # logprobs against the plain path's log-softmax
            _, lp = http(srv.port, "/v1/completions",
                         {"prompt": prompts[7][:200], "max_tokens": 16, "logprobs": 5})
            ctx = [1] + tok.encode(prompts[7][:200]) + lp["tokens"]
            plain = plain_sequence_logits(torch, params, cfg, ctx[:-1])[-len(lp["tokens"]):]
            want = torch.log_softmax(plain.float(), -1)
            got_lp = lp["choices"][0]["logprobs"]
            errs, tols, top1 = [], [], []
            for j, t in enumerate(lp["tokens"]):
                errs.append(abs(got_lp["token_logprobs"][j] - want[j, t].item()))
                tols.append(4e-2 * plain[j].abs().max().item())
                tops = got_lp["top_logprobs"][j]
                top1.append(max(tops, key=tops.get) == got_lp["tokens"][j]
                            and len(tops) == 5)
            checks["logprobs"] = dict(tokens=len(errs), max_err=max(errs), min_tol=min(tols),
                                      top1_is_token=all(top1))
            if not (all(e <= t for e, t in zip(errs, tols)) and all(top1)):
                fail(f"server: logprobs differ from the plain path: {checks['logprobs']}")
            # top_k 1 at temperature 1 is greedy
            _, k1 = http(srv.port, "/v1/completions",
                         {"prompt": prompts[3], "max_tokens": 32, "temperature": 1.0,
                          "seed": 4, "top_k": 1})
            checks["top_k_1"] = dict(equal_greedy=k1["tokens"] == blocking["tokens"])
            if k1["tokens"] != blocking["tokens"]:
                fail("server: top_k 1 at temperature 1 differs from greedy")
            # the repetition penalty against a plain-path loop
            _, pen = http(srv.port, "/v1/completions",
                          {"prompt": prompts[9][:100], "max_tokens": 16,
                           "repetition_penalty": 1.3})
            want_pen, gap = plain_penalised_greedy(torch, params, cfg,
                                                   [1] + tok.encode(prompts[9][:100]), 16, 1.3)
            checks["repetition_penalty"] = dict(equal=pen["tokens"] == want_pen,
                                                min_top2_gap=gap)
            if pen["tokens"] != want_pen:
                fail(f"server: repetition_penalty 1.3 differs from the plain loop: "
                     f"{pen['tokens']} vs {want_pen} (smallest top-2 gap {gap})")
            # embeddings of a 512-token input against the plain path
            text = "".join(prompts)[:512]
            before = read_counts()
            st, emb = http(srv.port, "/v1/embeddings", {"input": text})
            emb_counts = {k: v - before[k] for k, v in read_counts().items() if v - before[k]}
            vec = torch.tensor(emb["data"][0]["embedding"], device="cuda")
            with torch.inference_mode(), plain_path():
                ref = torch.from_numpy(embedder.embed(tok.encode(text))).cuda()
            cos = float(vec @ ref / (vec.norm() * ref.norm()))
            checks["embeddings"] = dict(status=st, tokens=emb["usage"]["prompt_tokens"],
                                        dim=len(emb["data"][0]["embedding"]), cosine=cos,
                                        launches=emb_counts)
            if st != 200 or not cos >= 0.999 or checks["embeddings"]["tokens"] != 512:
                fail(f"server: embedding differs from the plain path: {checks['embeddings']}")
        counts = read_counts()
        row.update(checks=checks, launches=counts)
        st, stats = http(srv.port, "/stats")
        row["stats"] = stats
        srv.close(label)
        for k in must:
            if counts[k] <= 0:
                fail(f"server {label}: kernel {k} was never launched ({counts})")
        for k, v in counts.items():
            total[k] += v
        del eng, srv
        torch.cuda.empty_cache()
        # the 16 completions against the engine driven directly
        want, eng_tok_s = offline_tokens(torch, make, (tok.encode(prompts[1][:64]), 8),
                                         [(ids[i], SERVER_NEW) for i in order])
        got = [outs[i]["tokens"] for i in order]
        same = [g == w for g, w in zip(got, want)]
        row.update(offline_equal=all(same), offline_engine_tokens_per_s=eng_tok_s,
                   serve_full_width_engine_tokens_per_s=engine_rows.get(label, {}).get(
                       "tokens_per_s"))
        emit("server", **row)
        if not all(same):
            fail(f"server {label}: completions differ from the offline engine run at "
                 f"requests {[i for i, ok in zip(order, same) if not ok]}")
        runs[label] = row
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
    del engine
    int8_cache_prefill(torch, params, cfg, prompt512, ids, max_seq, runs, total)
    del params
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, row=row)


def int8_cache_prefill(torch, params, cfg, prompt512, ids, max_seq, runs, total):
    """`llm --cache-dtype int8`'s long prefill: the same 512-token prompt
    through Engine.generate over the dense int8 cache of 2048 rows, whose
    prefill dequantizes the planes once a layer to bf16 for K4 (bf16 q),
    one launch a layer; the first-token logits over the int8 cache held
    against the plain path (2e-2: bf16 q and planes)."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    engine = Engine(params, ModelAdapter.llama(cfg, "int8", bos_id=1, device="cuda"),
                    max_seq=max_seq, device="cuda")
    engine.generate(prompt512, n_new=2)          # warm-up
    res, counts = drive_run(torch, "int8_cache_generate_512_16",
                            lambda: engine.generate(prompt512, n_new=16),
                            ("flash_gqa_attention",), runs, total)
    if counts["flash_gqa_attention"] != cfg.n_layers:
        fail(f"int8-cache 512-token prefill: {counts['flash_gqa_attention']} K4 launches, "
             f"not one a layer ({cfg.n_layers})")

    def fn():
        c = M.init_cache(cfg, 1, max_seq, "int8", "cuda")
        x, _ = M.forward(params, cfg, ids, c, 0)
        return M.lm_head(params, cfg, x[:, -1:])[0, 0]

    lv = logits_vs_plain(torch, "int8_cache_512_first_token", fn)
    emit("int8_cache_prefill", prompt_tokens=512, new_tokens=16, ttft_ms=res.ttft_s * 1e3,
         decode_tok_s=res.tokens_per_s, launches=counts, logits_err=lv["max_abs_err"],
         logits_tol=lv["tol"], logits_top2_gap=lv["top2_gap"])


# -- phase 9b: the other llama-family architectures at full width ------------------

def family_configs():
    """The four family configurations at their published widths: phi-2
    2.7B (full depth), Mixtral-8x7B, Qwen2-7B (YaRN factor 4 over 32768)
    and Gemma-2B. Mixtral keeps all 32 layers (its q4_0 planes ~28 GB)."""
    from tpu_llm_torch.config import LlamaConfig, phi2_2_7b

    return {
        "phi2_2.7b": phi2_2_7b(),
        "mixtral_8x7b": LlamaConfig(dim=4096, hidden_dim=14336, n_layers=32, n_heads=32,
                                    n_kv_heads=8, vocab_size=32000, seq_len=32768,
                                    rope_theta=1e6, n_experts=8, n_experts_used=2),
        "qwen2_7b": LlamaConfig(dim=3584, hidden_dim=18944, n_layers=28, n_heads=28,
                                n_kv_heads=4, vocab_size=152064, seq_len=131072,
                                rope_theta=1e6, norm_eps=1e-6, rope_variant="neox",
                                use_bias=True, rope_scaling_type="yarn",
                                rope_scaling_factor=4.0, rope_orig_ctx=32768),
        "gemma_2b": LlamaConfig(dim=2048, hidden_dim=16384, n_layers=18, n_heads=8,
                                n_kv_heads=1, vocab_size=256000, seq_len=8192,
                                norm_eps=1e-6, rope_variant="neox", act="gelu",
                                head_dim_=256, emb_scale=2048 ** 0.5,
                                tie_embeddings=True),
    }


def synth_family(torch, cfg, seed: int, kind: str = "q4_0"):
    """Random weights of ``cfg``'s family drawn on the card, in the layouts
    the port's loaders make with --dtype native: packed ``kind`` projections
    (fused wqkv; w13, or phi-2's w3 / w2, or the stacked expert planes w1e /
    w3e / w2e beside an f32 router), f32 norms (LayerNorm with bias for
    phi-2) and f32 biases (phi-2's everywhere, Qwen2's on q / k / v), a
    bf16 embedding, and a packed classifier unless tied. Phi-2's q / k / v
    stay dense f32, as its loader leaves them."""
    from tpu_llm_torch.quant.qtensor import qmap

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    E, Fh, V = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    QKV = cfg.q_dim + 2 * cfg.kv_dim

    def qt(K, N):
        return random_qtensor(torch, g, kind, K, N)

    def vec(n, scale=0.02):
        return torch.randn(n, generator=g, device="cuda") * scale

    ones = lambda: torch.ones(E, device="cuda")  # noqa: E731
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"attn_norm": ones()}
        if cfg.use_layernorm:
            lp["attn_norm_b"] = vec(E)
        if not cfg.parallel_block:
            lp["ffn_norm"] = ones()
        if cfg.parallel_block:      # phi-2: dense f32 q / k / v, biases everywhere
            lp.update(wqkv=torch.randn((E, QKV), generator=g, device="cuda") * 0.02,
                      bqkv=vec(QKV), wo=qt(cfg.q_dim, E), bo=vec(E), w3=qt(E, Fh),
                      b3=vec(Fh), w2=qt(Fh, E), b2=vec(E))
        else:
            lp.update(wqkv=qt(E, QKV), wo=qt(cfg.q_dim, E))
            if cfg.use_bias:
                lp["bqkv"] = vec(QKV)
            if cfg.n_experts:
                stack = lambda K, N: qmap(lambda *ps: torch.stack(ps),  # noqa: E731
                                          *[qt(K, N) for _ in range(cfg.n_experts)])
                lp.update(router=vec((E, cfg.n_experts), 0.05), w1e=stack(E, Fh),
                          w3e=stack(E, Fh), w2e=stack(Fh, E))
            else:
                lp.update(w13=qt(E, 2 * Fh), w2=qt(Fh, E))
        layers.append(lp)
    params = {"tok_emb": (torch.randn((V, E), generator=g, device="cuda") * 0.02).bfloat16(),
              "final_norm": ones(), "layers": layers,
              "wcls": None if cfg.tie_embeddings else qt(E, V)}
    if cfg.use_layernorm:
        params.update(final_norm_b=vec(E), bcls=vec(V))
    return params


def greedy_vs_plain(torch, label, params, cfg, ids, tokens, tie_rel=2e-2):
    """The greedy tokens of the kernel path held against the plain path on
    the card: one teacher-forced plain forward over ``ids`` + ``tokens``;
    each token must be the plain argmax, or lie within ``tie_rel`` *
    max|logit| of the plain max (a near-tie: the bf16 tolerance of
    logits_vs_plain). Returns the counts and the smallest top-1 margin of
    the exact steps."""
    from tpu_llm_torch.models import llama as M

    seq = torch.tensor([ids + tokens[:-1]], device="cuda")
    with torch.inference_mode(), plain_path():
        c = M.init_cache(cfg, 1, seq.shape[1], torch.float32, "cuda")
        x, _ = M.forward(params, cfg, seq, c, 0)
        logits = M.lm_head(params, cfg, x[:, len(ids) - 1:])[0]
    want = torch.tensor(tokens, device="cuda")
    top = logits.max(dim=-1).values
    tol = tie_rel * logits.abs().max(dim=-1).values
    got = logits.gather(1, want[:, None])[:, 0]
    exact = logits.argmax(dim=-1) == want
    ok = bool((exact | (got >= top - tol)).all())
    row = dict(run=label, steps=len(tokens), exact=int(exact.sum()),
               near_tie=int((~exact).sum()), all_within_rule=ok)
    emit("greedy_vs_plain", **row)
    if not ok:
        fail(f"{label}: greedy tokens off the plain path beyond a near-tie: {row}")
    return row


def rows_vs_plain(torch, label, kern_fn, rel_tol=2e-2):
    """(B, V) logits of ``kern_fn()`` on the kernel path and under
    plain_path(): max error <= rel_tol * max|logit|, and each row's top-1
    the plain top-1 or within that tolerance of the plain max (the
    near-tie rule of greedy_vs_plain)."""
    with torch.inference_mode():
        kern = kern_fn()
        with plain_path():
            plain = kern_fn()
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        fail(f"{label}: logits are not finite")
    err = (kern - plain).abs().max().item()
    tol = rel_tol * plain.abs().max().item()
    top_k = kern.argmax(dim=-1)
    exact = top_k == plain.argmax(dim=-1)
    near = plain.gather(1, top_k[:, None])[:, 0] >= plain.max(dim=-1).values - tol
    row = dict(run=label, rows=kern.shape[0], top1_exact=int(exact.sum()),
               top1_near_tie=int((~exact & near).sum()), max_abs_err=err, tol=tol,
               max_abs_logit=plain.abs().max().item())
    emit("logits_vs_plain", **row)
    if not (bool((exact | near).all()) and err <= tol):
        fail(f"{label}: logits differ from the plain path: {row}")
    return row


MOE_BATCHES = (1, 2, 8)     # gather, union (2 x 2 < 8), dense masked (8 x 2 >= 8)


def moe_batches(torch, params, cfg, runs, total):
    """Mixtral decode at batch 1, 2 and 8 (one strategy of _moe_ffn each):
    tokens/s over 32 steps of decode_step over a bf16 cache from position
    16, K1 launches a step (gather 2, union 4, dense 8 experts: 3 a
    selected expert, plus wqkv and wo, a layer; plus the classifier), and
    each batch's decode logits held against the plain path."""
    from tpu_llm_torch.models import llama as M

    rows = []
    for B in MOE_BATCHES:
        cache = M.init_cache(cfg, B, 64, torch.bfloat16, "cuda")
        ids = torch.randint(3, cfg.vocab_size, (B, 16), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(B))
        with torch.inference_mode():
            M.forward(params, cfg, ids, cache, 0)
            tok = ids[:, -1]

            def steps(n, start):
                nonlocal tok
                for pos in range(start, start + n):
                    logits, _ = M.decode_step(params, cfg, tok, cache, pos)
                    tok = torch.argmax(logits, dim=-1)
                torch.cuda.synchronize()

            _, per_step = drive_run(torch, f"mixtral_decode_b{B}_one_step",
                                    lambda: steps(1, 16), ("qmatmul",), runs, total)
            t = time.perf_counter()
            steps(32, 17)
            tok_s = 32 * B / (time.perf_counter() - t)

        def logits(B=B, ids=ids):
            c = M.init_cache(cfg, B, 64, torch.bfloat16, "cuda")
            _, c = M.forward(params, cfg, ids, c, 0)
            return M.decode_step(params, cfg, ids[:, 0], c, 16)[0]

        experts = {1: 2, 2: 4, 8: 8}[B] * 3
        want_k1 = cfg.n_layers * (experts + 2) + 1
        if per_step["qmatmul"] != want_k1:
            fail(f"mixtral batch {B}: {per_step['qmatmul']} K1 launches a step, not "
                 f"{want_k1} (the strategy for {B} rows)")
        lv = rows_vs_plain(torch, f"mixtral_decode_b{B}", logits)
        rows.append(dict(batch=B, strategy={1: "gather", 2: "union", 8: "dense"}[B],
                         decode_tok_s=tok_s, k1_per_step=per_step["qmatmul"],
                         logits_err=lv["max_abs_err"], logits_tol=lv["tol"]))
        del cache
    return rows


def families_full_width(torch):
    """Phi-2 2.7B, Mixtral-8x7B, Qwen2-7B (YaRN) and Gemma-2B at full width
    (family_configs) with random q4_0 weights drawn on the card
    (synth_family), entered at Engine.generate over the `llm` CLI's f32
    cache of 2048 rows: a 16-token prompt and 64 greedy tokens in the step
    loop and in the captured graph (--scan), each token held against the
    plain path (greedy_vs_plain); the first-token logits with f32
    activations against the plain path at 1e-3 * max|logit|; TTFT of a
    512-token prompt; peak memory; the launches of each run. Gemma's head
    width 256 attends on the plain path (no K2 / K4 launch, the JAX
    package's route), and its GeGLU never takes K7 with the megakernel
    switch on. Mixtral also decodes at batch 1, 2 and 8 (moe_batches)."""
    import numpy as np

    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    runs, total, rows = {}, {n: 0 for n in counters()}, []
    rng = np.random.default_rng(17)
    max_seq = 2048
    for i, (name, cfg) in enumerate(family_configs().items()):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = synth_family(torch, cfg, seed=40 + i)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        packed = sum(w.nbytes for lp in params["layers"] for w in lp.values()
                     if hasattr(w, "kind")) + (params["wcls"].nbytes if params["wcls"]
                                                is not None else 0)
        kernel_attn = M.kernel_head_dim(cfg.head_dim)
        must = ("qmatmul", "flash_decode_attention") if kernel_attn else ("qmatmul",)
        engine = Engine(params, ModelAdapter.llama(cfg, torch.float32, bos_id=1, device="cuda"),
                        max_seq=max_seq, device="cuda")
        prompt16 = [int(t) for t in rng.integers(3, cfg.vocab_size, 15)]
        prompt512 = [int(t) for t in rng.integers(3, cfg.vocab_size, 511)]
        engine.generate(prompt16, n_new=4)                       # warm-up
        res, counts = drive_run(torch, f"{name}_generate_16_64",
                                lambda: engine.generate(prompt16, n_new=64), must, runs, total)
        gen = res.tokens[len(prompt16):]
        step_check = greedy_vs_plain(torch, f"{name}_step_loop", params, cfg, [1] + prompt16,
                                     gen)
        engine.generate(prompt16, n_new=4, use_scan=True)        # capture
        scan, scan_counts = drive_run(torch, f"{name}_scan_16_64",
                                      lambda: engine.generate(prompt16, n_new=64,
                                                              use_scan=True), must,
                                      runs, total)
        scan_gen = scan.tokens[len(prompt16):]
        scan_check = greedy_vs_plain(torch, f"{name}_scan", params, cfg, [1] + prompt16,
                                     scan_gen)
        engine.generate(prompt512, n_new=1)                      # warm-up
        long_must = must + (("flash_gqa_attention",) if kernel_attn
                            and 512 * max_seq * cfg.n_heads * 4 > M.FLASH_PREFILL_SCORES_BYTES
                            else ())
        res512, counts512 = drive_run(torch, f"{name}_generate_512_2",
                                      lambda: engine.generate(prompt512, n_new=2), long_must,
                                      runs, total)
        if not kernel_attn and (counts["flash_decode_attention"] or
                                counts512["flash_gqa_attention"]):
            fail(f"{name}: head_dim {cfg.head_dim} launched an attention kernel")
        mk = None
        if cfg.act != "silu" or cfg.n_experts or not cfg.gated_mlp:
            # the megakernel switch on: a non-SiLU-gated model never takes K7
            with switch("TPU_LLM_FFN_MEGAKERNEL"), torch.inference_mode():
                cache = M.init_cache(cfg, 1, 64, torch.bfloat16, "cuda")
                _, mk = drive_run(torch, f"{name}_megakernel_switch_one_step",
                                  lambda: M.decode_step(params, cfg,
                                                        torch.tensor([1], device="cuda"),
                                                        cache, 0), ("qmatmul",), runs, total)
            if mk["ffn_fused"]:
                fail(f"{name}: K7 launched for a {cfg.act} model")
        ids = torch.tensor([[1] + prompt16], device="cuda")
        f32_params = dict(params, tok_emb=params["tok_emb"].float())
        lv = logits_vs_plain(torch, f"{name}_first_token_f32",
                             first_logits_fn(torch, f32_params, cfg, ids, 64), rel_tol=1e-3)
        del f32_params
        batches = moe_batches(torch, params, cfg, runs, total) if cfg.n_experts else None
        row = dict(model=name, layers=cfg.n_layers, dim=cfg.dim, hidden=cfg.hidden_dim,
                   heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim,
                   vocab=cfg.vocab_size, experts=cfg.n_experts,
                   rope_scaling=cfg.rope_scaling, kind="q4_0", packed_bytes=packed,
                   build_s=build_s, decode_tok_s=res.tokens_per_s,
                   scan_decode_tok_s=scan.tokens_per_s, ttft_ms_16=res.ttft_s * 1e3,
                   ttft_ms_512=res512.ttft_s * 1e3,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches_generate=counts, launches_scan=scan_counts,
                   launches_512=counts512, megakernel_switch_launches=mk,
                   attention_route="kernels" if kernel_attn else
                   "plain (head_dim outside the kernels' 16..128; the JAX package's route)",
                   step_loop_vs_plain=step_check, scan_vs_plain=scan_check,
                   scan_equals_step_loop=scan_gen == gen, first_tokens=gen[:8],
                   logits_err=lv["max_abs_err"], logits_tol=lv["tol"],
                   logits_top2_gap=lv["top2_gap"], moe_batches=batches)
        emit("families_full_width", **row)
        rows.append(row)
        # the engine's captured steps close over the engine: a cycle
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
    return dict(runs=runs, total=total, rows=rows)


# -- phase 10: llm-bench on the card ------------------------------------------------

# the port's llm-bench at modest steps, and the kernels each run must launch
BENCH_CLI_RUNS = [
    (["--configs", "bf16,q8_0,q4_0", "--steps", "32", "--ttft-samples", "3"],
     ("qmatmul", "flash_decode_attention")),
    # TTFT at 512 tokens over 2048 rows: the scores pass 64 MB, so K4
    (["--configs", "q4_0", "--prompt-len", "512", "--max-seq", "2048", "--steps", "32"],
     ("qmatmul", "flash_decode_attention", "flash_gqa_attention")),
    (["--configs", "q6_k,q4_k", "--skip-ttft", "--steps", "32"],
     ("qmatmul", "flash_decode_attention")),
    # int8 planes decode on the plain path (as in the JAX package)
    (["--configs", "q4_0", "--cache-dtype", "int8", "--skip-ttft", "--steps", "32"],
     ("qmatmul",)),
    (["--configs", "7b_q4_0,7b_bf16", "--skip-ttft", "--steps", "16"],
     ("qmatmul", "flash_decode_attention")),
    (["--paged", "--batch", "8", "--steps", "32"],
     ("qmatmul", "paged_flash_decode_attention", "flash_decode_attention")),
    (["--spec", "--steps", "32"], ("qmatmul", "flash_decode_attention")),
    # phi-2 2.7B (bf16, q4_0) and the synthetic MoE (q4_0): K2 at D 80
    (["--configs", "phi2,phi2_q4_0,moe_q4_0", "--skip-ttft", "--steps", "32"],
     ("qmatmul", "flash_decode_attention")),
]


def run_bench_cli(argv):
    """The port's llm-bench in-process: its JSON rows."""
    from tpu_llm_torch.runtime import bench_cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_cli.main(argv)
    if rc != 0:
        fail(f"llm-bench {argv} exited {rc}")
    return [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]


def llama2_7b_step_vs_plain(torch):
    """One step of llm-bench's 7b_q4_0 program (a 16-token prompt
    prefilled into a bf16 cache, then decode_step over the int4-plane
    weights at a device position: K1 at the 7B projections, K2 at D 128,
    32 kv heads) held against the plain path."""
    from tpu_llm_torch.config import llama2_7b
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.quant.convert_params import unpack_params_int4
    from tpu_llm_torch.runtime.bench_cli import synth_quant_llama

    cfg = llama2_7b()
    params = synth_quant_llama(cfg, "q4_0", seed=5, device="cuda")
    p4 = unpack_params_int4(params)
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    ids = torch.randint(3, cfg.vocab_size, (1, 16), generator=g, device="cuda")

    def fn():
        c = M.init_cache(cfg, 1, 1024, torch.bfloat16, "cuda")
        _, c = M.forward(params, cfg, ids, c, 0)
        pos = torch.full((1,), ids.shape[1], dtype=torch.int32, device="cuda")
        return M.decode_step(p4, cfg, torch.tensor([5], device="cuda"), c, pos)[0][0]

    return logits_vs_plain(torch, "llama2_7b_q4_0_bench_step", fn)


def bench_cli_full_width(torch):
    """The port's llm-bench rows on the card (BENCH_CLI_RUNS), each run a
    main-path run with its counts; every row finite and positive, the spec
    rows with tokens per verify forward; then one 7B decode step's logits
    against the plain path."""
    runs, total = {}, {n: 0 for n in counters()}
    rows = []
    for argv, must in BENCH_CLI_RUNS:
        t = time.perf_counter()
        got, counts = drive_run(torch, "llm-bench " + " ".join(argv),
                                lambda: run_bench_cli(argv), must, runs, total)
        if not got:
            fail(f"llm-bench {argv} printed no row")
        for r in got:
            if not (isinstance(r["value"], (int, float)) and math.isfinite(r["value"])
                    and r["value"] > 0):
                fail(f"llm-bench {argv}: row {r}")
            if "_engine_spec" in r["metric"] and "tokens_per_verify_forward" not in r:
                fail(f"llm-bench {argv}: spec row without tokens_per_verify_forward: {r}")
            emit("bench_cli", argv=argv, **r)
        emit("bench_cli_run", argv=argv, s=time.perf_counter() - t,
             launches={k: v for k, v in counts.items() if v})
        rows += got
    metrics = {r["metric"] for r in rows}
    for m in ("llama2_7b_q4_0_decode_tokens_per_s_per_chip",
              "llama2_7b_bf16_decode_tokens_per_s_per_chip",
              "tinyllama_1.1b_q4_0_PAGED_decode_tokens_per_s_b8_bs64",
              "tinyllama_1.1b_q4_0_ttft_p50_prompt512",
              "phi2_2.7b_bf16_decode_tokens_per_s_per_chip",
              "phi2_2.7b_q4_0_decode_tokens_per_s_per_chip",
              "synthetic_moe_8e_top2_q4_0_decode_tokens_per_s_per_chip"):
        if m not in metrics:
            fail(f"llm-bench: row {m} missing")
    lv = llama2_7b_step_vs_plain(torch)
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, rows=rows, logits_7b=lv)


# -- main --------------------------------------------------------------------------

# the case the `llm` CLI runs (bf16 q over its f32 cache), reported beside
# the serving pick as `cli_case`
CLI_CASES = {"flash_decode_attention": dict(cache="f32", pos=1000),
             "flash_gqa_attention": dict(T=512, cache="f32", q="bf16")}
# further cases reported beside the pick: K4 with f32 q, K1 at prefill rows
EXTRA_CASES = {"flash_gqa_attention": {"f32_q_case": dict(T=512, cache="f32", q="f32"),
                                       "f32_q_bf16_cache_case": dict(T=512, cache="bf16",
                                                                     q="f32"),
                                       "phi2_d80_case": dict(D=80)},
               "qmatmul": {"prefill_case": dict(weight="w13", kind="q4_0", rows=512),
                           "verify_window_case": dict(weight="w13", kind="q4_0", rows=5),
                           "verify_window_b8_case": dict(weight="w13", kind="q4_0",
                                                         rows=BENCH_VERIFY_ROWS),
                           **{f"{n}_7b_case": dict(weight=f"{n}_7b", rows=1)
                              for n in ("wqkv", "wo", "w13", "w2", "wcls")},
                           "mixtral_w1e_slice_case": dict(weight="mixtral_w1e_slice"),
                           "mixtral_w2e_slice_case": dict(weight="mixtral_w2e_slice"),
                           "qwen2_wqkv_case": dict(weight="qwen2_wqkv", x="float32"),
                           "qwen2_wqkv_bf16_case": dict(weight="qwen2_wqkv",
                                                        x="bfloat16")},
               "flash_decode_attention": {"llama2_7b_case": dict(D=128, Hkv=32),
                                          "phi2_d80_case": dict(D=80),
                                          "qwen2_g7_case": dict(H=28, Hkv=4)},
               "flash_decode_fused": {"phi2_d80_case": dict(D=80)},
               "paged_flash_decode_attention": {"batch1_case": dict(pool="bf16", B=1),
                                                "bs64_case": dict(pool="bf16", BS=64, B=8),
                                                "phi2_d80_case": dict(D=80)},
               "paged_flash_decode_q": {"batch1_case": dict(pool="int8", B=1)}}

# what the paged cases report of their launch: splits, kernels a call
SPLIT_KEYS = ("n_split", "launches_per_call")

KERNELS = [
    ("qmatmul", "tpu_llm_torch/csrc/qmatmul.cu", "tpu_llm/quant/pallas_matmul.py:59",
     dict(weight="w13", kind="q4_0", rows=1)),
    ("flash_decode_attention", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:121", dict(cache="bf16", Hkv=4)),
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
    hs = server_full_width(torch, params, cfg, sv["runs"])
    mk = megakernel_full_width(torch, params, cfg)
    del params
    torch.cuda.empty_cache()
    f32 = f32_full_width(torch)
    kq = kquant_full_width(torch)
    torch.cuda.empty_cache()
    fam = families_full_width(torch)
    bc = bench_cli_full_width(torch)
    phases = (fw, sc, sv, hs, mk, f32, kq, fam, bc)
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
