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
   Qwen2-7B's five projections with f32 and bf16 rows (`qwen2_*_case`,
   the decode body); K2, K3, K4 and K5 at phi-2's head width 80
   (`phi2_d80_case`, f32 q); K2 at Qwen2-7B's 28/4 heads
   (`qwen2_g7_case`). K1's row sweep (`k1_row_sweep` lines, then
   `k1_rows`): both bodies by name at Qwen2-7B's projections, rows 1-3,
   f32 and bf16 x, timed in a replayed graph over weights past L2 and
   alone after an L2 flush, and the largest row count at which the decode
   body is faster everywhere in the graph timing, beside DECODE_ROWS.
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
   moe_q4_0 (32 steps); mamba and mamba_bf16 (32 steps, no ported kernel
   on their path). Each invocation is a
   main-path run with the kernels it must launch; then one step of the
   7b_q4_0 program (K1 at the 7B projections, K2 at D 128) held against
   the plain path.
11. mamba full width — Mamba-130M (768 / 24 layers) and Mamba-790M (1536 /
   48) at their published widths and depths, vocab 50280, seeded random
   weights drawn on the card, written by write_packed and read back by
   load_packed; f32 and bf16 (cast_weights): a 16-token prompt and 64
   greedy tokens on the step loop and on the captured graph (--scan),
   every token held against the sequential path (the step recurrence,
   teacher-forced: its argmax, or within 1e-3 (f32) / 2e-2 (bf16) *
   max|logit| of it); TTFT at 16 and 512 tokens (the parallel scan); the
   first-token logits against the sequential path at 1e-3 (f32) / 2e-2
   (bf16) * max|logit|; the graph step profiled (device ms and kernels a
   step); peak memory; the bytes a token must read and their time at
   3.35 TB/s. 130M f32 also runs BatchEngine at batch 8 over 16 requests.
   No ported kernel is on the Mamba path: its counts stay 0.
12. mamba_cli — `llm-ssm` as a subprocess on the 130M file, with a
   tokenizer.bin made by --convert-tokenizer from a 50280-id byte-level
   tokenizer.json written here: the output contract with and without
   --scan, the same text both ways; `llm-serve -m X.bin` for 4 prompts.
13. checkpoint_tools — TinyLlama widths (dim 2048, ffn 5632, 32 / 4
   heads, vocab 32000) at 4 layers, Q4_0, written here: `llm-load -o -t
   --cache-out`; `llm --ak -s` against `llm --dtype f32` on the GGUF and
   `llm -m X.npz` against `--dtype native` (the same greedy text); a
   2-shard gguf-split (every tensor's bytes and loaded planes equal, the
   same text); `llm-serve --paged -m X.npz`, 4 requests.
14. perplexity — compute_ppl over a 1024-token eval_stream on the phase-13
   model, card against the plain path on the card (rel 1e-3): f32 and
   q4_0 at window 512, f32 at window 1024 (K4 takes the prefill); then
   dtype_table's f32 / q8_0 / q4_0 / q4_k rows at window 512.
15. lora_full_width — `llm --lora` over the phase-13 file with a rank-8
   adapter on all 28 projections and output.weight: the card run's text
   equals the same merge done on CPU tensors (apply_lora, fused, run by
   Engine.generate on the card) and differs from the run without it;
   every greedy token on the plain path's argmax; the merge's seconds.
16. tp_full_width — TinyLlama-1.1B at full width and depth, Q4_0, as a
   .npz cache with a tokenizer.bin; two ranks on the one card (gloo,
   named in the row: a correctness path) launched by
   tpu_llm_torch.parallel.distributed.launch run `llm --tp 2` over a
   1200-token prompt (K1 89 a forward, K4 22 on the prefill, K2 22 a
   decode step: exact counts on each rank, so no step took a plain path),
   its FFN megakernel switch (K7 over the local w13 / w2), `llm-serve --tp
   2` (dense b8, --paged bf16 and int8 pools: 16 requests, 8 sharing a
   prefix), `llm-serve --dp 2` and one `llm-server --tp 2` round of 4
   concurrent completions; every greedy token on the plain path's argmax
   over the run's KV dtype; first-token logits with f32 activations within
   1e-3 * max|logit| of tp 1; `llm` tokens/s at tp 1 and tp 2. Phase
   multiprocess: the same `llm --tp 2` as two processes started here with
   --coordinator / --num-processes / --process-id: exit 0, rank 0's text
   the launched run's, rank 1 silent. The kernels phase adds each kernel
   at a tp 2 rank's local shapes (check_tp_shapes: the `*_tp2_case` and
   `tp2_case` entries of the kernels line), and bench_cli the parallel
   rows (--scaling, --sharded, --serve-tp 2), clamped to the card's one
   device as the JAX package clamps them.
17. seq_pipe_full_width — the phase-16 .npz with f32 activations and
   caches; one launch of four ranks on the card (gloo) runs ring
   attention prefill (seq 4, 2048 tokens), sequence-sharded decode (a
   1020-token prompt prefilled on one rank, its rows scattered, 16 greedy
   steps across the 1024 boundary), Ulysses (degree 4: a 2032-token
   prefill through K4, the reshard, 16 steps through K2), sequence-
   parallel prefill (tp 2 x dp 2, 2 x 1024 tokens), the pipeline (pipe 2
   x dp 2: 2 x 2032 tokens in 2 chunks through K4, 16 steps through K2)
   and PP x TP (pipe 2 x tp 2: an 8-token prompt, 16 steps). Exact kernel
   counts on every rank; first-token logits within 1e-3 * max|logit| of
   the single-rank kernel path with the same top-1; the cache rows each
   rank wrote within 1e-3 * max|k| of that path's elementwise (a near-tie
   row, where the kernel path and its plain twin lie apart by more than a
   quarter of that, within 4x their distance) and within 1e-3 of it a
   layer (Frobenius, relative); every greedy token on the plain path's
   argmax; the row has the seconds, the collectives a step or prefill as
   the mesh counted them, and the peak memory of each rank and case. The
   kernels phase adds K4 and K2 at a rank's shapes on these paths
   (check_seq_pipe_shapes: the `seq_pipe_*_case` entries).
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
             "flash_gqa_attention": [], "ffn_fused": [], "paged_flash_decode_attention": [],
             "paged_flash_decode_q": []}

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
    check_paged_kernels(torch, timer, g, compare, record)
    check_family_shapes(torch, timer, g, compare, record)
    k1_row_sweep(torch, timer, g)
    check_tp_shapes(torch, timer, g, compare, record)
    check_seq_pipe_shapes(torch, timer, g, compare, record)
    return cases


K1_SWEEP_ROWS = range(1, 4)
# distinct copies of each Qwen2-7B projection, > 256 MB a set (past L2)
K1_SWEEP_COPIES = {"wqkv": 28, "wo": 36, "w13": 4, "w2": 7, "wcls": 2}


def graph_call_ms(torch, fn, weights, replays: int = 10) -> float:
    """Mean ms of ``fn(w)`` over ``weights`` (distinct copies, past L2) when
    the calls are captured in one CUDA graph and replayed: the time a
    decode graph sees (back to back, the weights cold, no host)."""
    fns = lambda: [fn(w) for w in weights]  # noqa: E731
    fns()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fns()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (replays * len(weights))


def k1_row_sweep(torch, timer, g):
    """K1's two bodies by name (qmatmul_body) at Qwen2-7B's five projections
    (q4_0, f32 planes), f32 and bf16 x, rows 1-3 (the decode body to its
    2): one `k1_row_sweep` line a case with each body's time as a decode
    graph sees it (graph_call_ms, `*_graph_ms`) and alone after an L2 flush
    (the Timer, `*_ms`), and the bound; then one `k1_rows` line with the
    largest row count at which the decode body is faster at every
    projection and x dtype in the graph timing, beside DECODE_ROWS."""
    from tpu_llm_torch.quant import qmatmul as QM

    wins = {r: True for r in K1_SWEEP_ROWS if r <= QM._DECODE_MAX_ROWS}
    for wname, (K, N) in QWEN2_SHAPES.items():
        ws = [random_qtensor(torch, g, "q4_0", K, N) for _ in range(K1_SWEEP_COPIES[wname])]
        for xdt in (torch.float32, torch.bfloat16):
            for rows in K1_SWEEP_ROWS:
                x = torch.randn((rows, K), generator=g, device="cuda").to(xdt)
                row = dict(weight=f"qwen2_{wname}", x=str(xdt).replace("torch.", ""),
                           rows=rows, K=K, N=N,
                           bound_ms=bound(ws[0].nbytes + nbytes(x) + rows * N * x.element_size(),
                                          2.0 * rows * K * N, "bf16")[0])
                for body, decode in (("tc", False), ("decode", True)):
                    if decode and rows not in wins:
                        continue
                    row[f"{body}_graph_ms"] = graph_call_ms(
                        torch, lambda w: QM.qmatmul_body(x, w, decode), ws)
                    row[f"{body}_ms"] = timer.ms(lambda: QM.qmatmul_body(x, ws[0], decode))
                if rows in wins:
                    wins[rows] &= row["decode_graph_ms"] < row["tc_graph_ms"]
                emit("k1_row_sweep", **row)
        del ws
    faster = [r for r in sorted(wins) if all(wins[q] for q in range(1, r + 1))]
    emit("k1_rows", decode_faster_to=max(faster, default=0), DECODE_ROWS=QM.DECODE_ROWS)


# a TinyLlama rank's projection shards at tp 2 (K, N)
TP2_SHAPES = {"wqkv_tp2": (2048, 1280), "wo_tp2": (1024, 2048), "w13_tp2": (2048, 5632),
              "w2_tp2": (2816, 2048), "wcls_tp2": (2048, 16000)}


def check_tp_shapes(torch, timer, g, compare, record):
    """The local shapes one rank of TinyLlama at tp 2 gives the kernels
    (each case tagged tp=2, its bound from the local bytes): K1 on every
    projection's shard (q4_0, f32 planes, 1 and 8 rows; library
    torch._weight_int4pack_mm), K2 and K4 at serving's shapes over 16 q
    heads and 2 kv heads, K3 over bench.py's bf16 cache with them, K5 / K6
    at batch 8 over the local pools, K7 over the local w13 / w2."""
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.quant.qmatmul import qmatmul, qmatmul_plain

    F = torch.nn.functional
    for wname, (K, N) in TP2_SHAPES.items():
        w = random_qtensor(torch, g, "q4_0", K, N, "f32")
        for rows in (1, 8):
            x = torch.randn((rows, K), generator=g, device="cuda").bfloat16()
            out_dtype = torch.float32 if wname.startswith("wcls") else torch.bfloat16
            got = qmatmul(x, w, out_dtype=out_dtype)
            want = qmatmul_plain(x, w, out_dtype=out_dtype)
            info = dict(weight=wname, kind="q4_0", planes="f32", rows=rows, K=K, N=N,
                        x="bf16", out=str(out_dtype).replace("torch.", ""), row_scale=False,
                        tp=2)
            err, tol = compare("qmatmul", got, want, True, **info)
            record("qmatmul", info, err, tol,
                   timer.ms(lambda: qmatmul(x, w, out_dtype=out_dtype)),
                   timer.ms(lambda: qmatmul_plain(x, w, out_dtype=out_dtype)),
                   int4pack_ms(torch, timer, x, w, want, info),
                   w.nbytes + nbytes(x) + rows * N * got.element_size(),
                   2.0 * rows * K * N, "bf16")
        del w
    check_ffn_kernel(torch, timer, g, compare, record, F=5632 // 2, kinds=("q4_0",), tp=2)
    check_serving_shapes(torch, timer, g, compare, record, heads=(16, 2), tp=2)
    check_paged_kernels(torch, timer, g, compare, record, heads=(16, 2),
                        configs=(PAGED_CONFIGS[0], PAGED_CONFIGS[3]), position_sets=(PAGED_POS,),
                        tp=2)
    # K3 over bench.py's bf16 (1, 1024, Hkv * 64) cache at its last position
    B, H, Hkv, D, S, pos = 1, 16, 2, 64, BENCH_MAX_SEQ, BENCH_PROMPT + BENCH_STEPS[1] - 1
    kc, vc = (torch.randn((B, S, Hkv * D), generator=g, device="cuda").bfloat16()
              for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g, device="cuda").bfloat16()
    kn, vn = (torch.randn((B, 1, Hkv * D), generator=g, device="cuda").bfloat16()
              for _ in range(2))
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, pos=pos, q="bf16", cache="bf16", tp=2)
    k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    got = FA.flash_decode_fused(q, k1, v1, kn, vn, p)[0]
    err, tol = compare("flash_decode_fused", got,
                       FA.flash_decode_fused_plain(q, k2, v2, kn, vn, p)[0], True, **info)
    k4, v4 = (c.view(B, S, Hkv, D)[:, :pos + 1].transpose(1, 2) for c in (kc, vc))
    record("flash_decode_fused", info, err, tol,
           timer.ms(lambda: FA.flash_decode_fused(q, k1, v1, kn, vn, p)),
           timer.ms(lambda: FA.flash_decode_fused_plain(q, k2, v2, kn, vn, p)),
           timer.ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k4, v4,
                                                           enable_gqa=True)),
           nbytes(q) * 2 + 2 * B * pos * Hkv * D * 2 + nbytes(kn, vn) + 2 * Hkv * D * 2,
           4.0 * B * H * (pos + 1) * D, "f32")


def check_seq_pipe_shapes(torch, timer, g, compare, record):
    """K4 and K2 at the shapes a rank of phase seq_pipe_full_width gives
    them (f32 q over f32 caches, 64-wide heads; each case tagged with its
    path as ``seq_pipe``): K4 for the Ulysses prefill (8 q heads over 1 kv
    head, 2032 rows over the gathered 2032-row k / v), the sequence-
    parallel prefill (16 / 2 heads, 1024 rows over the 2048-row cache)
    and the pipeline's two 1016-row chunks (32 / 4 heads, offsets 0 and
    1016, the 2048-row cache); K2 at each of the 16 positions of the
    Ulysses (8 / 1 heads), pipeline (32 / 4) and PP x TP (16 / 2) decode
    runs, recorded at the last with the largest error of the 16."""
    from tpu_llm_torch.ops import flash_attention as FA

    F = torch.nn.functional
    dev, D, it = "cuda", 64, 4
    chunk = SP_LONG // 2
    for path, H, Hkv, T, S, off in (("ulysses_prefill", 8, 1, SP_LONG, SP_LONG, 0),
                                    ("sp_prefill", 16, 2, SP_SP_T, SP_MAX_SEQ, 0),
                                    ("pp_prefill", 32, 4, chunk, SP_MAX_SEQ, 0),
                                    ("pp_prefill", 32, 4, chunk, SP_MAX_SEQ, chunk)):
        q = torch.randn((1, T, H, D), generator=g, device=dev)
        kc, vc = (torch.randn((1, S, Hkv, D), generator=g, device=dev) for _ in range(2))
        if path != "ulysses_prefill":        # the cache planes, as the path holds them
            kc, vc = kc.view(1, S, Hkv * D), vc.view(1, S, Hkv * D)
        info = dict(B=1, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=off, q="f32", cache="f32",
                    seq_pipe=path)
        got = FA.flash_gqa_attention(q, kc, vc, off)
        err, tol = compare("flash_gqa_attention", got,
                           FA.flash_gqa_attention_plain(q, kc, vc, off), False, **info)
        n_keys = off + T
        kt, vt = (c.view(1, S, Hkv, D)[:, :n_keys].transpose(1, 2) for c in (kc, vc))
        causal = (torch.arange(n_keys, device=dev)[None, :]
                  <= off + torch.arange(T, device=dev)[:, None])
        qt = q.transpose(1, 2)
        record("flash_gqa_attention", dict(info, library="sdpa, mask s <= offset + t"),
               err, tol,
               timer.ms(lambda: FA.flash_gqa_attention(q, kc, vc, off)),
               timer.ms(lambda: FA.flash_gqa_attention_plain(q, kc, vc, off)),
               timer.ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, attn_mask=causal, enable_gqa=True)),
               nbytes(q) * 2 + 2 * n_keys * Hkv * D * it,
               4.0 * H * D * (T * off + T * (T + 1) / 2), "f32")
        del q, kc, vc, kt, vt, causal
    for path, H, Hkv, first in (("ulysses_decode", 8, 1, SP_LONG),
                                ("pp_decode", 32, 4, SP_LONG),
                                ("pp_tp_decode", 16, 2, SP_PPTP_PROMPT)):
        kc, vc = (torch.randn((1, SP_MAX_SEQ, Hkv * D), generator=g, device=dev)
                  for _ in range(2))
        q = torch.randn((1, 1, H, D), generator=g, device=dev)
        last = first + SP_NEW - 1
        info = dict(B=1, H=H, Hkv=Hkv, D=D, S=SP_MAX_SEQ, pos=last, positions=[first, last],
                    q="f32", cache="f32", seq_pipe=path)
        errs = []
        for pos in range(first, last + 1):
            p = torch.tensor([pos], dtype=torch.int32, device=dev)
            errs.append(compare("flash_decode_attention", FA.flash_decode_attention(q, kc, vc, p),
                                FA.flash_decode_attention_plain(q, kc, vc, p), False,
                                **dict(info, pos=pos)))
        k4, v4 = (c.view(1, SP_MAX_SEQ, Hkv, D)[:, :last + 1].transpose(1, 2) for c in (kc, vc))
        record("flash_decode_attention", info, max(e for e, _ in errs), min(t for _, t in errs),
               timer.ms(lambda: FA.flash_decode_attention(q, kc, vc, p)),
               timer.ms(lambda: FA.flash_decode_attention_plain(q, kc, vc, p)),
               timer.ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k4, v4,
                                                               enable_gqa=True)),
               nbytes(q) * 2 + 2 * (last + 1) * Hkv * D * it + nbytes(p),
               4.0 * H * (last + 1) * D, "f32")
        del q, kc, vc, k4, v4


def check_serving_shapes(torch, timer, g, compare, record, heads=(32, 4), tp=None):
    """K2 and K4 at the shapes serving gives them, bf16 q over bf16 cache
    planes: K2 as the dense BatchEngine's decode (batch 8, a (8, 1024,
    256) cache, ragged positions PAGED_POS); K4 as PagedEngine's prefill
    over the gathered (1, 1024, 4, 64) view of one slot (a 256-token tail
    after a 256-token prefix hit at offset 256, and a 512-token prompt at
    offset 0). ``heads`` (q, kv): a tp rank's local heads with ``tp``."""
    from tpu_llm_torch.ops import flash_attention as FA

    F = torch.nn.functional
    dev, bf = "cuda", torch.bfloat16
    (H, Hkv), D, S = heads, 64, 1024
    it = 2
    tpi = {"tp": tp} if tp else {}

    B = len(PAGED_POS)
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device=dev)
    kc, vc = (torch.randn((B, S, Hkv * D), generator=g, device=dev).to(bf)
              for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g, device=dev).to(bf)
    info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, positions=PAGED_POS, q="bf16", cache="bf16",
                **tpi)
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
        info = dict(B=1, T=T, H=H, Hkv=Hkv, D=D, S=S, offset=off, q="bf16", cache="bf16",
                    **tpi)
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


def check_ffn_kernel(torch, timer, g, compare, record, F=5632, kinds=("q4_0", "q8_0"),
                     tp=None):
    """K7 at TinyLlama width (E 2048, F 5632; a tp rank's F / tp), q4_0 and
    q8_0 with f32 planes, 1 and 8 rows: against its twin, and timed beside
    the unfused path it replaces (K1 on w13, silu * up, K1 on w2, as
    models/llama.py runs it), on the card and in host enqueue time. No
    single PyTorch call computes it: library_ms is null."""
    from tpu_llm_torch.ops.activations import silu
    from tpu_llm_torch.quant.ffn import ffn_fused, ffn_fused_plain
    from tpu_llm_torch.quant.qmatmul import qmatmul

    E = 2048
    for kind in kinds:
        w13 = random_qtensor(torch, g, kind, E, 2 * F)
        w2 = random_qtensor(torch, g, kind, F, E)
        for rows in (1, 8):
            x = torch.randn((rows, E), generator=g, device="cuda").bfloat16()

            def unfused():
                h13 = qmatmul(x, w13)
                return qmatmul(silu(h13[..., :F]) * h13[..., F:], w2)

            got = ffn_fused(x, w13, w2)
            info = dict(kind=kind, rows=rows, E=E, F=F, x="bf16", planes="f32",
                        **({"tp": tp} if tp else {}))
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


PAGED_CONFIGS = (("paged_flash_decode_attention", "bf16", 16),
                 ("paged_flash_decode_attention", "bf16", 64),      # llm-bench --paged
                 ("paged_flash_decode_attention", "f32", 16),
                 ("paged_flash_decode_q", "int8", 32))


def check_paged_kernels(torch, timer, g, compare, record, heads=(32, 4),
                        configs=PAGED_CONFIGS, position_sets=(PAGED_POS, PAGED_BATCH1_POS),
                        tp=None):
    """K5 (bf16 and f32 pools, block 16) and K6 (int8 pools, block 32)
    against their plain twins at serving shapes: batch 8, 32/4 heads,
    head_dim 64, max_seq 1024, shuffled tables, positions PAGED_POS; and
    batch 1, one live request at position 1000. Then block 0 and every
    block past pos // BS poisoned: the same output. Each case reports its
    split count and the kernels the profiler sees a call launch (one: the
    split decode body merges in the same launch). Library:
    F.scaled_dot_product_attention over the rows gathered (and, for int8,
    dequantized) beforehand, masked to s <= pos; the gather is not timed.
    ``heads`` (q, kv) and ``configs``: a tp rank's local heads with ``tp``."""
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.ops.kv_cache import dequantize_kv
    from tpu_llm_torch.ops.paged_kv import (PagedKV, paged_gather, scale_pool_width,
                                            scale_rows_per_block)

    F = torch.nn.functional
    dev = "cuda"
    (H, Hkv), D, max_seq = heads, 64, 1024
    for (name, pool, BS), positions in itertools.product(configs, position_sets):
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
                    n_split=n_split, **({"tp": tp} if tp else {}))
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


# Qwen2-7B's projections (K, N), each a layer's and the classifier
QWEN2_SHAPES = {"wqkv": (3584, 4608), "wo": (3584, 3584), "w13": (3584, 37888),
                "w2": (18944, 3584), "wcls": (3584, 152064)}


def check_family_shapes(torch, timer, g, compare, record):
    """The shapes the other llama-family models give the kernels. K1: one
    row through an expert slice picked by a device index out of stacked
    Mixtral-8x7B planes (w1e 4096x14336, w2e 14336x4096, 8 experts, the
    copy _expert_slice makes timed beside it), and Qwen2-7B's five
    projections (QWEN2_SHAPES) with f32 rows (its f32 biases promote the
    activations to f32, as in the JAX package) and bf16 rows: K1's decode
    body. Head width 80 (phi-2: 32 heads, one
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
                          ("mixtral_w2e_slice", (14336, 4096)),
                          *((f"qwen2_{n}", kn) for n, kn in QWEN2_SHAPES.items())):
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
               kernels_per_step=sum(c for _, _, c in rows) / steps,
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


def greedy_vs_plain(torch, label, params, cfg, ids, tokens, tie_rel=2e-2, cache="f32",
                    gate=True, keep_cache=False):
    """The greedy tokens of the kernel path held against the plain path on
    the card: one teacher-forced plain forward over ``ids`` + ``tokens``
    over a ``cache`` ("f32", "bf16" or "int8": the run's KV storage) cache;
    each token must be the plain argmax, or lie within ``tie_rel`` *
    max|logit| of the plain max (a near-tie: the bf16 tolerance of
    logits_vs_plain). Returns the counts, and the largest gap below the
    plain max of a step off the argmax, over max|logit|. ``gate=False``
    only reports (a reading against another reference than the run's).
    ``keep_cache`` returns the plain forward's cache beside the row."""
    from tpu_llm_torch.models import llama as M

    seq = torch.tensor([ids + tokens[:-1]], device="cuda")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8"}[cache]
    with torch.inference_mode(), plain_path():
        c = M.init_cache(cfg, 1, seq.shape[1], dt, "cuda")
        x, c = M.forward(params, cfg, seq, c, 0)
        logits = M.lm_head(params, cfg, x[:, len(ids) - 1:])[0]
    want = torch.tensor(tokens, device="cuda")
    top = logits.max(dim=-1).values
    tol = tie_rel * logits.abs().max(dim=-1).values
    got = logits.gather(1, want[:, None])[:, 0]
    exact = logits.argmax(dim=-1) == want
    ok = bool((exact | (got >= top - tol)).all())
    gap = ((top - got) / logits.abs().max(dim=-1).values)[~exact]
    row = dict(run=label, cache=cache, gate=gate, steps=len(tokens), exact=int(exact.sum()),
               near_tie=int((~exact).sum()), all_within_rule=ok,
               worst_gap_rel=float(gap.max()) if gap.numel() else 0.0)
    emit("greedy_vs_plain", **row)
    if gate and not ok:
        fail(f"{label}: greedy tokens off the plain path beyond a near-tie: {row}")
    return (row, c) if keep_cache else row


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
    # Mamba-130M f32 and bf16: no ported kernel on its path
    (["--configs", "mamba,mamba_bf16", "--steps", "32"], ()),
    # the parallel rows, clamped to the card's one device as the JAX
    # package clamps them (dp 1, tp 1, serve-tp 2 -> 1 with its note)
    (["--scaling", "--steps", "8"], ("flash_decode_attention",)),
    (["--sharded", "--steps", "8"], ("qmatmul", "flash_decode_attention")),
    (["--serve-tp", "2", "--steps", "16"], ("flash_decode_attention",)),
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
        for r in [r for r in got if "note" in r]:
            emit("bench_cli", argv=argv, **r)
        got = [r for r in got if "note" not in r]
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
              "synthetic_moe_8e_top2_q4_0_decode_tokens_per_s_per_chip",
              "mamba_130m_f32_decode_tokens_per_s_per_chip",
              "mamba_130m_bf16_decode_tokens_per_s_per_chip",
              "scaling_dp1_decode_tokens_per_s", "tp1_shardmap_q4_0_decode_tokens_per_s",
              "tinyllama_1.1b_bf16_engine_serving_tp1_tokens_per_s_b1"):
        if m not in metrics:
            fail(f"llm-bench: row {m} missing")
    lv = llama2_7b_step_vs_plain(torch)
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, rows=rows, logits_7b=lv)


# -- phase 11: Mamba at full width ---------------------------------------------------

MAMBA_NEW = 64         # greedy tokens a Mamba run
MAMBA_TIE = {"f32": 1e-3, "bf16": 2e-2}   # near-tie and logits rules, x max|logit|


def mamba_configs():
    """Mamba-130M and -790M at the published widths and depths (HF
    state-spaces/mamba-130m, -790m): nothing cut."""
    from tpu_llm_torch.config import mamba_130m, mamba_790m

    return {"mamba_130m": mamba_130m(), "mamba_790m": mamba_790m()}


def write_random_mamba(torch, cfg, path: str, seed: int):
    """Seeded random weights in the JAX package's llm-bench distribution
    (N(0, 0.02), norms around 1, A_log = |.| + 0.1), drawn on the card, in
    the packed file's torch orientation, written by write_packed."""
    from tpu_llm_torch.io.mamba_ckpt import write_packed

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    E, di, ds, dr, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_, cfg.d_conv
    L, V = cfg.n_layers, cfg.vocab_size

    def s(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).cpu().numpy()

    arrays = {"tok_emb": s(V, E), "norm_f": s(E) + 1.0, "wcls": s(V, E), "D": s(L, di),
              "in_proj": s(L, 2 * di, E), "conv_w": s(L, di, dc), "conv_b": s(L, di),
              "x_proj": s(L, dr + 2 * ds, di), "dt_proj": s(L, di, dr), "dt_bias": s(L, di),
              "A_log": abs(s(L, di, ds)) + 0.1, "out_proj": s(L, E, di),
              "norm": s(L, E) + 1.0}
    write_packed(path, arrays, cfg)
    return os.path.getsize(path)


def mamba_sequential_logits(torch, params, cfg, ids):
    """The plain path: teacher-forced one token at a time (the step
    recurrence, ``sequential=True``), every position's logits."""
    from tpu_llm_torch.models import mamba as M

    with torch.inference_mode():
        state = M.init_state(cfg, 1, "cuda")
        h, _ = M.forward(params, cfg, torch.tensor([ids], device="cuda"), state,
                         sequential=True)
        return M.lm_head(params, cfg, h)[0]


def mamba_greedy_vs_sequential(torch, label, params, cfg, prompt, tokens, tie_rel):
    """Each greedy token is the sequential path's argmax at its position,
    or within ``tie_rel`` * max|logit| of its max (a near-tie)."""
    logits = mamba_sequential_logits(torch, params, cfg, prompt + tokens[:-1])
    logits = logits[len(prompt) - 1:]
    want = torch.tensor(tokens, device="cuda")
    top = logits.max(dim=-1).values
    tol = tie_rel * logits.abs().max(dim=-1).values
    got = logits.gather(1, want[:, None])[:, 0]
    exact = logits.argmax(dim=-1) == want
    ok = bool((exact | (got >= top - tol)).all())
    row = dict(run=label, steps=len(tokens), exact=int(exact.sum()),
               near_tie=int((~exact).sum()), tie_rel=tie_rel, all_within_rule=ok)
    emit("greedy_vs_plain", **row)
    if not ok:
        fail(f"{label}: greedy tokens off the sequential path beyond a near-tie: {row}")
    return row


def mamba_first_logits(torch, label, params, cfg, prompt, rel_tol):
    """The first token's logits of the engine's route (the prompt padded to
    its bucket, the parallel scan masked by ``length``) against the
    sequential path's, within ``rel_tol`` * max|logit|."""
    from tpu_llm_torch.models import mamba as M
    from tpu_llm_torch.runtime.engine import _next_bucket

    with torch.inference_mode():
        toks = torch.zeros((1, _next_bucket(len(prompt))), dtype=torch.long, device="cuda")
        toks[0, :len(prompt)] = torch.tensor(prompt, device="cuda")
        h, _ = M.forward(params, cfg, toks, M.init_state(cfg, 1, "cuda"), length=len(prompt))
        kern = M.lm_head(params, cfg, h[:, len(prompt) - 1])[0]
    plain = mamba_sequential_logits(torch, params, cfg, prompt)[-1]
    err = (kern - plain).abs().max().item()
    tol = rel_tol * plain.abs().max().item()
    row = dict(run=label, max_abs_err=err, tol=tol, max_abs_logit=plain.abs().max().item(),
               top1_parallel=int(kern.argmax()), top1_sequential=int(plain.argmax()))
    emit("logits_vs_plain", **row)
    if not (torch.isfinite(kern).all() and err <= tol):
        fail(f"{label}: first-token logits off the sequential path: {row}")
    return row


def mamba_bytes_a_token(params, cfg) -> int:
    """What one decode token must read: every weight once, the f32 state
    read and written."""
    leaves = [params["tok_emb"][:1], params["norm_f"], params["wcls"]]
    leaves += [v for lp in params["layers"] for v in lp.values()]
    state = 2 * 4 * cfg.n_layers * (cfg.d_conv + cfg.d_state) * cfg.d_inner
    return sum(t.numel() * t.element_size() for t in leaves) + state


def mamba_batch(torch, params, cfg, runs, total):
    """BatchEngine, batch 8 over 16 greedy requests of 16-200 prompt tokens
    and MAMBA_NEW tokens each: aggregate tokens/s."""
    import numpy as np

    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import ModelAdapter

    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(3, cfg.vocab_size, n)]
               for n in rng.integers(16, 201, 16)]
    eng = BatchEngine(params, ModelAdapter.mamba(cfg, "cuda"), batch=8, max_seq=512,
                      eos_id=-1)
    eng.submit(Request(prompt=prompts[0], max_new=4))
    eng.run()                                             # warm-up

    def run():
        reqs = [eng.submit(Request(prompt=p, max_new=MAMBA_NEW)) for p in prompts]
        t = time.perf_counter()
        steps = eng.run()
        torch.cuda.synchronize()
        return reqs, steps, time.perf_counter() - t

    (reqs, steps, wall), _ = drive_run(torch, "mamba_130m_batch8_16req",
                                       run, (), runs, total)
    n = sum(len(r.tokens) for r in reqs)
    if n != 16 * MAMBA_NEW:
        fail(f"mamba BatchEngine: {n} tokens of {16 * MAMBA_NEW}")
    return dict(batch=8, requests=16, new_tokens=MAMBA_NEW, engine_steps=steps,
                wall_s=wall, tokens_per_s=n / wall)


def mamba_full_width(torch, tmp: str):
    """Mamba-130M and -790M at full width and depth from seeded random
    weights written by write_packed and read by load_packed, f32 and bf16
    (cast_weights), entered at Engine.generate: a 16-token prompt and
    MAMBA_NEW greedy tokens on the step loop and on the captured graph
    (--scan), each token held against the sequential path; TTFT of 16- and
    512-token prompts (the parallel prefill); the first-token logits
    against the sequential path; peak memory; the bytes a token must read
    and their time at 3.35 TB/s. 130M f32 also runs BatchEngine at batch
    8 over 16 requests. The Mamba path launches none of the ported
    kernels: every count is 0."""
    import numpy as np

    from tpu_llm_torch.models import mamba as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    runs, total, rows, paths = {}, {n: 0 for n in counters()}, [], {}
    rng = np.random.default_rng(29)
    for i, (name, cfg) in enumerate(mamba_configs().items()):
        path = os.path.join(tmp, f"{name}.bin")
        t0 = time.perf_counter()
        size = write_random_mamba(torch, cfg, path, seed=50 + i)
        write_s = time.perf_counter() - t0
        paths[name] = path
        t0 = time.perf_counter()
        params, _ = M.load_packed(path, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if name != "mamba_130m":          # only 130M's file is read again (phase 12)
            os.remove(path)
        prompt16 = [int(t) for t in rng.integers(3, cfg.vocab_size, 16)]
        prompt512 = [int(t) for t in rng.integers(3, cfg.vocab_size, 512)]
        for dtype in ("f32", "bf16"):
            if dtype == "bf16":
                params = M.cast_weights(params)
                gc.collect()
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            label = f"{name}_{dtype}"
            engine = Engine(params, ModelAdapter.mamba(cfg, "cuda"), max_seq=1024,
                            device="cuda")
            gen = lambda **k: engine.generate(prompt16, n_new=MAMBA_NEW,  # noqa: E731
                                              add_bos=False, **k)
            engine.generate(prompt16, n_new=4, add_bos=False)             # warm-up
            res, _ = drive_run(torch, f"{label}_step_loop", gen, (), runs, total)
            toks = res.tokens[len(prompt16):]
            step_check = mamba_greedy_vs_sequential(torch, f"{label}_step_loop", params,
                                                    cfg, prompt16, toks, MAMBA_TIE[dtype])
            engine.generate(prompt16, n_new=4, add_bos=False, use_scan=True)  # capture
            scan, _ = drive_run(torch, f"{label}_scan", lambda: gen(use_scan=True), (),
                                runs, total)
            scan_toks = scan.tokens[len(prompt16):]
            scan_check = mamba_greedy_vs_sequential(torch, f"{label}_scan", params, cfg,
                                                    prompt16, scan_toks, MAMBA_TIE[dtype])
            g = engine._graphs[("decode", 0.0)]
            with torch.inference_mode():        # the graph's buffers are inference tensors
                prof = graph_profile(torch, g["captured"], 16, lambda: g["i"].zero_())
            engine.generate(prompt512, n_new=1, add_bos=False)            # warm-up
            res512, _ = drive_run(torch, f"{label}_prompt512",
                                  lambda: engine.generate(prompt512, n_new=1,
                                                          add_bos=False), (), runs, total)
            lv = mamba_first_logits(torch, f"{label}_first_token", params, cfg, prompt16,
                                    MAMBA_TIE[dtype])
            nbytes_tok = mamba_bytes_a_token(params, cfg)
            row = dict(model=name, dtype=dtype, d_model=cfg.d_model, layers=cfg.n_layers,
                       vocab=cfg.vocab_size, file_bytes=size, write_s=write_s, load_s=load_s,
                       step_decode_tok_s=res.tokens_per_s, scan_decode_tok_s=scan.tokens_per_s,
                       ttft_ms_16=res.ttft_s * 1e3, ttft_ms_512=res512.ttft_s * 1e3,
                       graph_step_profile=prof, bytes_a_token=nbytes_tok,
                       bound_ms_a_token=nbytes_tok / HBM_BYTES_PER_S * 1e3,
                       bound_tok_s=HBM_BYTES_PER_S / nbytes_tok,
                       peak_memory_bytes=torch.cuda.max_memory_allocated(),
                       scan_equals_step_loop=scan_toks == toks, first_tokens=toks[:8],
                       step_loop_vs_plain=step_check, scan_vs_plain=scan_check,
                       logits_err=lv["max_abs_err"], logits_tol=lv["tol"],
                       launches=sum(runs[f"{label}_step_loop"].values()))
            if name == "mamba_130m" and dtype == "f32":
                row["batch8"] = mamba_batch(torch, params, cfg, runs, total)
            emit("mamba_full_width", **row)
            rows.append(row)
            del engine
            gc.collect()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return dict(runs=runs, total=total, rows=rows, paths=paths)


# -- phase 12: llm-ssm and llm-serve -m X.bin -------------------------------------------

def mamba_tokenizer_json(path: str, vocab: int):
    """A GPT-NeoX-style byte-level tokenizer.json of ``vocab`` ids: the 256
    byte characters, two merges, fillers ("x00042": no merge builds them,
    so no text encodes to them, but they decode) and a special token."""
    from tpu_llm_torch.tokenizers.bpe import _GPT2_DECODER

    # code point -> byte: the byte's character, in byte order
    chars = [chr(cp) for cp in sorted(_GPT2_DECODER, key=_GPT2_DECODER.get)]
    v = {c: i for i, c in enumerate(chars)}
    v["Ġt"], v["he"] = len(v), len(v) + 1
    for i in range(len(v), vocab - 1):
        v[f"x{i:05d}"] = i
    with open(path, "w") as f:
        json.dump({"model": {"vocab": v, "merges": ["Ġ t", "h e"]},
                   "added_tokens": [{"id": vocab - 1, "content": "<|endoftext|>",
                                     "special": True}]}, f)


def run_module(argv, timeout=600):
    """``python -m`` one of the port's programs in a subprocess: (rc,
    stdout bytes, stderr text)."""
    res = subprocess.run([sys.executable, "-m", *argv], capture_output=True, cwd=ROOT,
                         timeout=timeout)
    return res.returncode, res.stdout, res.stderr.decode(errors="replace")


def mamba_cli_phase(torch, tmp: str, packed: str):
    """`llm-ssm` as a subprocess on the card, on phase 11's Mamba-130M file
    and a tokenizer.bin made by --convert-tokenizer: the output contract
    (the streamed text, a blank line, Inference time, tokens/second, TTFT)
    with and without --scan, the same text both ways; then `llm-serve -m
    X.bin` for 4 prompts (the dense engine)."""
    from tpu_llm_torch.runtime import mamba_cli

    tj, tok = os.path.join(tmp, "tokenizer.json"), os.path.join(tmp, "tokenizer.bin")
    mamba_tokenizer_json(tj, 50280)
    with contextlib.redirect_stdout(io.StringIO()):
        if mamba_cli.main(["--convert-tokenizer", tj, "-s", tok]) != 0:
            fail("llm-ssm --convert-tokenizer failed")
    texts, rows = {}, []
    for extra in ([], ["--scan"]):
        t = time.perf_counter()
        rc, out, err = run_module(["tpu_llm_torch.runtime.mamba_cli", "-m", packed, "-s", tok,
                                   "-p", "the theory of the thing", "-n", "48", *extra])
        text, _, report = out.partition(b"\n Inference time:")
        lines = report.decode(errors="replace").splitlines()
        ok = (rc == 0 and text.startswith(b"the theory") and len(lines) >= 3
              and "tokens/second (decode)" in lines[1] and lines[2].startswith(" TTFT:"))
        row = dict(flags=extra, rc=rc, s=time.perf_counter() - t,
                   text=text.decode(errors="replace")[:200],
                   report=[ln.strip() for ln in lines[:3]], contract=ok)
        emit("mamba_cli", **row)
        if not ok:
            fail(f"llm-ssm {extra}: {row} {err[-800:]}")
        texts[tuple(extra)] = text
        rows.append(row)
    if texts[()] != texts[("--scan",)]:
        fail("llm-ssm: --scan text differs from the step loop's")
    prompts = ["the theory", "he said the", "a b c", "the the the"]
    t = time.perf_counter()
    rc, out, err = run_module(["tpu_llm_torch.runtime.serve_cli", "-m", packed, "-s", tok,
                               *[a for p in prompts for a in ("-p", p)], "-n", "32",
                               "--batch", "4"])
    reqs = [json.loads(ln) for ln in out.decode().splitlines() if ln.startswith("{")]
    summary = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1]) \
        if rc == 0 else None
    row = dict(run="llm-serve -m X.bin", rc=rc, s=time.perf_counter() - t, requests=len(reqs),
               n_tokens=[r["n_tokens"] for r in reqs], summary=summary)
    emit("mamba_cli", **row)
    if rc != 0 or len(reqs) != 4 or any(r["n_tokens"] != 32 for r in reqs) \
            or summary["engine"] != "dense":
        fail(f"llm-serve -m X.bin: {row} {err[-800:]}")
    rows.append(row)
    return dict(rows=rows, total={n: 0 for n in counters()})


# -- phase 13: the checkpoint tools at TinyLlama width -----------------------------------

TOOLS_LAYERS = 4       # TinyLlama's widths, depth cut from 22 (a 22-layer f32 ak is 4.4 GB)


def write_tools_gguf(torch, path: str, seed: int = 61):
    """TinyLlama-1.1B widths (dim 2048, ffn 5632, 32 / 4 heads, vocab 32000)
    at TOOLS_LAYERS layers: seeded random weights drawn on the card, every
    projection and the classifier stored Q4_0 by the port's writer, norms
    and the embedding f32; server_tokenizer's vocabulary in the metadata."""
    import numpy as np

    from tpu_llm_torch.io import gguf as gg

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dim, hidden, H, KVH, V = 2048, 5632, 32, 4, 32000
    kv = dim // H * KVH

    def s(*shape, scale=0.02):
        return (torch.randn(shape, generator=g, device="cuda") * scale).cpu().numpy()

    tok = server_tokenizer(torch, V)
    meta = {"general.architecture": "llama", "llama.block_count": TOOLS_LAYERS,
            "llama.embedding_length": dim, "llama.feed_forward_length": hidden,
            "llama.attention.head_count": H, "llama.attention.head_count_kv": KVH,
            "llama.context_length": 2048, "llama.rope.freq_base": 10000.0,
            "llama.attention.layer_norm_rms_epsilon": 1e-5,
            "tokenizer.ggml.tokens": [t.decode("latin-1") for t in tok.tokens],
            "tokenizer.ggml.scores": np.zeros(V, np.float32),
            # server_tokenizer's types: unknown, four control tokens, normal
            "tokenizer.ggml.token_type": np.asarray([2, 3, 3, 3, 3] + [1] * (V - 5),
                                                    np.int32),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    q = lambda a: (a, gg.GGML_Q4_0)  # noqa: E731
    tensors = {"token_embd.weight": s(V, dim), "output_norm.weight": 1.0 + s(dim),
               "output.weight": q(s(V, dim, scale=0.05))}
    for i in range(TOOLS_LAYERS):
        tensors.update({f"blk.{i}.attn_norm.weight": 1.0 + s(dim),
                        f"blk.{i}.ffn_norm.weight": 1.0 + s(dim),
                        f"blk.{i}.attn_q.weight": q(s(dim, dim)),
                        f"blk.{i}.attn_k.weight": q(s(kv, dim)),
                        f"blk.{i}.attn_v.weight": q(s(kv, dim)),
                        f"blk.{i}.attn_output.weight": q(s(dim, dim)),
                        f"blk.{i}.ffn_gate.weight": q(s(hidden, dim)),
                        f"blk.{i}.ffn_up.weight": q(s(hidden, dim)),
                        f"blk.{i}.ffn_down.weight": q(s(dim, hidden))})
    gg.write_gguf(path, meta, tensors)


TOOLS_PROMPT = ["-p", "abc def ghi", "-n", "40"]


def tools_cli(torch, name, argv, must, runs, total):
    """One `llm` run on the card as a main-path run: its first line."""
    out, counts = drive_run(torch, name, lambda: run_cli(argv + ["--device", "cuda"]), must,
                            runs, total)
    return out.split(b"\n")[0], counts


def checkpoint_tools(torch, tmp: str):
    """`llm-load -o -t --cache-out` on a TinyLlama-width Q4_0 GGUF
    (write_tools_gguf); `llm --ak -s` (dequantized f32, as `llm --dtype
    f32` on the GGUF) and `llm -m X.npz` (the Q4_0 planes, as `--dtype
    native`) print the GGUF path's greedy text; a 2-shard gguf-split of
    the GGUF: every tensor's bytes and every loaded plane equal, and its
    greedy text the single file's; `llm-serve --paged -m X.npz` completes
    4 requests."""
    from tpu_llm_torch.io import gguf as gg
    from tpu_llm_torch.models.llama import load_gguf
    from tpu_llm_torch.runtime import convert_cli

    runs, total = {}, {n: 0 for n in counters()}
    src = os.path.join(tmp, "tools_q4_0.gguf")
    t = time.perf_counter()
    write_tools_gguf(torch, src)
    write_s = time.perf_counter() - t
    ak, tok, npz = (os.path.join(tmp, n) for n in ("tools.ak", "tools_tok.bin", "tools.npz"))
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if convert_cli.main(["-i", src, "-o", ak, "-t", tok, "--cache-out", npz]) != 0:
            fail("llm-load failed")
    load_s = time.perf_counter() - t
    sizes = {k: os.path.getsize(p) for k, p in (("gguf", src), ("ak", ak), ("npz", npz))}
    attn = ("flash_decode_attention",)
    lines = {}
    lines["gguf_f32"], _ = tools_cli(torch, "llm_gguf_f32", ["-m", src, *TOOLS_PROMPT,
                                                             "--dtype", "f32"], attn, runs, total)
    lines["ak"], _ = tools_cli(torch, "llm_ak", ["-m", ak, "--ak", "-s", tok, *TOOLS_PROMPT],
                               attn, runs, total)
    lines["gguf_native"], _ = tools_cli(torch, "llm_gguf_native",
                                        ["-m", src, *TOOLS_PROMPT, "--dtype", "native"],
                                        ("qmatmul",) + attn, runs, total)
    lines["npz"], _ = tools_cli(torch, "llm_npz", ["-m", npz, "-s", tok, *TOOLS_PROMPT],
                                ("qmatmul",) + attn, runs, total)
    shards = gg.write_gguf_split(gg.GGUFFile(src), os.path.join(tmp, "tools"), 2)
    whole, merged = gg.GGUFFile(src), gg.GGUFFile(shards[0])
    same_bytes = list(whole.tensors) == list(merged.tensors) and all(
        bytes(whole.raw(n)) == bytes(merged.raw(n)) for n in whole.tensors)
    pa, _ = load_gguf(whole, dtype_policy="native")
    pb, _ = load_gguf(merged, dtype_policy="native")
    planes_equal = all(torch.equal(getattr(a[k], p), getattr(b[k], p))
                       for a, b in zip(pa["layers"], pb["layers"]) for k in a
                       for p in (("q", "scales") if hasattr(a[k], "kind") else ()))
    del pa, pb
    lines["split"], _ = tools_cli(torch, "llm_split", ["-m", shards[0], *TOOLS_PROMPT,
                                                       "--dtype", "native"],
                                  ("qmatmul",) + attn, runs, total)
    prompts = ["abc def", "ghi jkl mno", "abc abc abc", "pqr"]
    (reqs, summary), _ = drive_run(
        torch, "llm_serve_paged_npz",
        lambda: run_serve_cli(["-m", npz, "-s", tok, *[a for p in prompts for a in ("-p", p)],
                               "-n", "24", "--batch", "4", "--paged", "--device", "cuda"]),
        ("qmatmul", "paged_flash_decode_attention"), runs, total)
    row = dict(dim=2048, hidden=5632, heads=[32, 4], vocab=32000, layers=TOOLS_LAYERS,
               kind="q4_0", write_gguf_s=write_s, llm_load_s=load_s, file_bytes=sizes,
               shards=[os.path.basename(p) for p in shards], split_bytes_equal=same_bytes,
               split_planes_equal=planes_equal,
               ak_equals_gguf_f32=lines["ak"] == lines["gguf_f32"],
               npz_equals_gguf_native=lines["npz"] == lines["gguf_native"],
               split_equals_gguf_native=lines["split"] == lines["gguf_native"],
               text={k: v.decode(errors="replace")[:80] for k, v in lines.items()},
               serve_paged_npz=dict(n_tokens=[r["n_tokens"] for r in reqs], summary=summary),
               launches={k: {n: v for n, v in c.items() if v} for k, c in runs.items()})
    emit("checkpoint_tools", **row)
    if not (row["ak_equals_gguf_f32"] and row["npz_equals_gguf_native"]
            and row["split_equals_gguf_native"] and same_bytes and planes_equal):
        fail(f"checkpoint tools: outputs differ: {row}")
    if len(reqs) != 4 or any(r["n_tokens"] != 24 for r in reqs):
        fail(f"llm-serve --paged -m X.npz: {row['serve_paged_npz']}")
    return dict(runs=runs, total=total, row=row, gguf=src)


# -- phase 14: perplexity -----------------------------------------------------------------

def perplexity_phase(torch, gguf: str):
    """compute_ppl over a 1024-token eval_stream on the TinyLlama-width
    model of phase 13, on the card against the plain path on the card (rel
    1e-3): f32 (dense) and q4_0 (native: K1) at window 512, and f32 at
    window 1024, where K4 takes the prefill (its scores pass 64 MB); then
    dtype_table's f32 / q8_0 / q4_0 / q4_k rows at window 512."""
    from tpu_llm_torch.models.llama import load_gguf
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.perplexity import compute_ppl, dtype_table, eval_stream

    runs, total, rows = {}, {n: 0 for n in counters()}, []
    ids = eval_stream(1024, vocab=32000, seed=11)
    for policy, window, must in (("f32", 512, ()), ("native", 512, ("qmatmul",)),
                                 ("f32", 1024, ("flash_gqa_attention",))):
        params, cfg = load_gguf(gguf, dtype_policy=policy, device="cuda")
        adapter = ModelAdapter.llama(cfg, device="cuda")
        run = lambda: compute_ppl(params, adapter, ids, window=window,  # noqa: E731
                                  device="cuda")
        run()                                                           # warm-up
        t = time.perf_counter()
        res, counts = drive_run(torch, f"ppl_{policy}_w{window}", run, must, runs, total)
        s = time.perf_counter() - t
        with plain_path():
            plain = run()
        rel = abs(res.ppl - plain.ppl) / plain.ppl
        row = dict(policy=policy, window=window, ppl=res.ppl, plain_ppl=plain.ppl,
                   rel_err=rel, n_tokens=res.n_tokens, s=s,
                   launches={k: v for k, v in counts.items() if v})
        emit("perplexity", **row)
        if not (math.isfinite(res.ppl) and rel <= 1e-3 and res.n_tokens == plain.n_tokens):
            fail(f"perplexity on the card differs from the plain path: {row}")
        rows.append(row)
        del params
        torch.cuda.empty_cache()
    t = time.perf_counter()
    table, _ = drive_run(torch, "dtype_table",
                         lambda: dtype_table(gguf, ids[:512], window=512,
                                             formats=("f32", "q8_0", "q4_0", "q4_k"),
                                             device="cuda"),
                         ("qmatmul",), runs, total)
    emit("perplexity_table", rows=table, s=time.perf_counter() - t)
    if not all(math.isfinite(r["ppl"]) for r in table):
        fail(f"dtype_table: {table}")
    return dict(runs=runs, total=total, rows=rows, table=table)


# -- phase 15: LoRA at TinyLlama width ------------------------------------------------

LORA_RANK = 8


def write_lora_adapter(path: str, n_layers: int, seed: int = 71):
    """A rank-LORA_RANK adapter GGUF (llama.cpp's convert_lora layout) on
    every projection of ``n_layers`` TinyLlama-width layers and on
    output.weight: A, B ~ N(0, 0.02), alpha 16."""
    import numpy as np

    from tpu_llm_torch.io import gguf as gg

    rng = np.random.default_rng(seed)
    dim, hidden, kv, vocab = 2048, 5632, 256, 32000
    shapes = {"attn_q": (dim, dim), "attn_k": (kv, dim), "attn_v": (kv, dim),
              "attn_output": (dim, dim), "ffn_gate": (hidden, dim), "ffn_up": (hidden, dim),
              "ffn_down": (dim, hidden)}
    bases = {f"blk.{i}.{n}.weight": oi for i in range(n_layers) for n, oi in shapes.items()}
    bases["output.weight"] = (vocab, dim)
    tensors = {}
    for base, (out_d, in_d) in bases.items():
        tensors[base + ".lora_a"] = (rng.standard_normal((LORA_RANK, in_d)) * 0.02
                                     ).astype(np.float32)
        tensors[base + ".lora_b"] = (rng.standard_normal((out_d, LORA_RANK)) * 0.02
                                     ).astype(np.float32)
    gg.write_gguf(path, {"general.architecture": "llama", "general.type": "adapter",
                         "adapter.type": "lora", "adapter.lora.alpha": 16.0}, tensors)
    return len(bases)


def to_card(params):
    """A params tree's tensors and QTensors moved to the card."""
    from tpu_llm_torch.quant.qtensor import QTensor, qmap

    def mv(v):
        if v is None:
            return None
        return qmap(lambda p: p.cuda(), v) if isinstance(v, QTensor) else v.cuda()

    return {k: [{n: mv(t) for n, t in lp.items()} for lp in v] if k == "layers" else mv(v)
            for k, v in params.items()}


def lora_full_width(torch, tmp: str, gguf: str):
    """`llm --lora` on the card over phase 13's TinyLlama-width Q4_0 GGUF
    (4 layers) with a rank-8 adapter on every projection and the
    classifier: its text is the text of the same merge done on CPU tensors
    (apply_lora, fused, moved to the card, Engine.generate), differs from
    the run without the adapter, and every greedy token is on the plain
    path's argmax; the merge's seconds on the host."""
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.io.lora import apply_lora
    from tpu_llm_torch.models.llama import _LAYER_TENSORS, load_gguf
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    runs, total = {}, {n: 0 for n in counters()}
    ad = os.path.join(tmp, "lora_r8.gguf")
    n_pairs = write_lora_adapter(ad, TOOLS_LAYERS)
    must = ("qmatmul", "flash_decode_attention")
    t = time.perf_counter()
    card, _ = tools_cli(torch, "llm_lora", ["-m", gguf, "--lora", ad, *TOOLS_PROMPT,
                                            "--dtype", "native"], must, runs, total)
    card_s = time.perf_counter() - t
    base, _ = tools_cli(torch, "llm_no_lora", ["-m", gguf, *TOOLS_PROMPT, "--dtype", "native"],
                        must, runs, total)
    g = GGUFFile(gguf)
    params, cfg = load_gguf(g, dtype_policy="native", fuse=False, device="cpu")
    t = time.perf_counter()
    merged = apply_lora(params, ad)
    merge_s = time.perf_counter() - t
    merged = to_card(dict(merged, layers=fuse_llama_layers(
        merged["layers"], lambda i, k: _LAYER_TENSORS[k].format(i=i))))
    del params
    tok = BPETokenizer.from_gguf(g)
    ids = tok.encode(TOOLS_PROMPT[1])
    n_total = int(TOOLS_PROMPT[3])
    eng = Engine(merged, ModelAdapter.llama(cfg, torch.float32, bos_id=tok.bos_id,
                                            device="cuda"),
                 max_seq=min(cfg.seq_len, max(n_total + 8, 64)), device="cuda")
    res = eng.generate(ids, n_total=n_total, temperature=0.0)
    cpu_line = b"".join(tok.token_bytes(t) for t in res.tokens).split(b"\n")[0]
    gvp = greedy_vs_plain(torch, "lora_full_width", merged, cfg, [tok.bos_id] + ids,
                          res.tokens[len(ids):])
    row = dict(dim=2048, layers=TOOLS_LAYERS, kind="q4_0", lora_rank=LORA_RANK,
               lora_pairs=n_pairs, merge_s=merge_s, llm_lora_s=card_s,
               card_equals_cpu_merge=card == cpu_line, lora_changes_text=card != base,
               text=card.decode(errors="replace")[:80], greedy_vs_plain=gvp,
               launches={k: {n: v for n, v in c.items() if v} for k, c in runs.items()})
    emit("lora_full_width", **row)
    if not (row["card_equals_cpu_merge"] and row["lora_changes_text"]):
        fail(f"llm --lora: {row}")
    del merged, eng
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, row=row)


# -- phase 16: tensor and data parallelism on the card -------------------------------

TP_PROMPT_LEN = 1200   # at 16 local heads the prefill's scores pass 64 MB: K4
TP_NEW = 40            # greedy tokens of the `llm --tp 2` run
TP_SERVE_NEW = 24      # tokens a request of the serving runs
TP_K7_PROMPT = "abc def"   # the `llm --tp 2` run with the FFN megakernel on
TP_SERVE_RUNS = {      # llm-serve flags -> the kernels every rank must launch, the KV storage
    "serve_tp2_dense_b8": (["--batch", "8", "--tp", "2"], ("qmatmul", "flash_decode_attention"),
                           "bf16"),
    "serve_tp2_paged_bf16": (["--batch", "8", "--tp", "2", "--paged"],
                             ("qmatmul", "paged_flash_decode_attention"), "bf16"),
    "serve_tp2_paged_int8": (["--batch", "8", "--tp", "2", "--paged", "--cache-dtype", "int8"],
                             ("qmatmul", "paged_flash_decode_q"), "int8"),
    "serve_dp2_dense_b8": (["--batch", "8", "--dp", "2"], ("qmatmul", "flash_decode_attention"),
                           "bf16"),
}


def tp_long_prompt() -> str:
    n = len(SERVER_CHARS)
    return "".join(SERVER_CHARS[(7 * i + i // n) % n] for i in range(TP_PROMPT_LEN))


def tp_llm_argv(npz: str, tok: str):
    return ["-m", npz, "-s", tok, "-p", tp_long_prompt(), "-n", str(TP_PROMPT_LEN + TP_NEW),
            "--tp", "2", "--device", "cuda"]


def tp_rank(rank: int, npz: str, tok: str, prompts_file: str, server_prompts_: list):
    """One of the two ranks of phase 16 (run by
    tpu_llm_torch.parallel.distributed.launch, gloo on the one card): the
    entry points' runs, this rank's counts set to 0 before and read after
    each, the generated tokens recorded (Engine.generate's result, the
    requests the engines took); then the first-token logits of the TP
    adapter with f32 activations."""
    import threading

    import torch

    from tpu_llm_torch.io.weight_cache import load_weight_cache
    from tpu_llm_torch.parallel.mesh import make_mesh
    from tpu_llm_torch.parallel.serving import make_tp_llama_adapter, shard_llama_params
    from tpu_llm_torch.runtime import batching, cli, engine, serve_cli, server
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    gens, subs = [], []
    gen0, sub0 = engine.Engine.generate, batching.BatchEngine.submit

    def generate(self, *a, **k):
        res = gen0(self, *a, **k)
        gens.append(list(res.tokens))
        return res

    def submit(self, req):
        subs.append(req)
        return sub0(self, req)

    engine.Engine.generate, batching.BatchEngine.submit = generate, submit
    out = {}

    def run(name, fn):
        subs.clear()
        reset_counts()
        t = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        out[name] = dict(value=value, s=time.perf_counter() - t, counts=read_counts(),
                         requests=[(list(r.prompt), list(r.tokens)) for r in subs])

    last = {}

    def quiet(main, argv):
        buf = io.BytesIO()
        text = io.TextIOWrapper(buf, encoding="utf-8", write_through=True)
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
            rc = main(argv)
        last["stdout"] = buf.getvalue()
        return rc

    run("llm_tp2", lambda: quiet(cli.main, tp_llm_argv(npz, tok)))
    out["llm_tp2"].update(tokens=gens[-1], report=cli_report(last["stdout"]))
    with switch("TPU_LLM_FFN_MEGAKERNEL"):
        run("llm_tp2_megakernel", lambda: quiet(cli.main, [
            "-m", npz, "-s", tok, "-p", TP_K7_PROMPT, "-n", "24", "--tp", "2",
            "--device", "cuda"]))
    out["llm_tp2_megakernel"].update(tokens=gens[-1])
    for name, (flags, _, _) in TP_SERVE_RUNS.items():
        run(name, lambda: quiet(serve_cli.main, [
            "-m", npz, "-s", tok, "-f", prompts_file, "-n", str(TP_SERVE_NEW),
            "--device", "cuda", *flags]))

    def http_round():
        """llm-server's pieces as its main() puts them together: the first
        rank serves HTTP and broadcasts each step's plan, the other follows."""
        args = server.build_parser().parse_args(["-m", npz, "-s", tok, "--batch", "4",
                                                 "--tp", "2", "--device", "cuda"])
        mesh = make_mesh(1, 2, device="cuda")
        params, cfg, tokenizer = serve_cli._load(args, "cpu")
        eng = serve_cli.make_engine(args, params, cfg, tokenizer, 1024, mesh.device, mesh)
        emb = server.Embedder(eng.params, make_tp_llama_adapter(cfg, mesh), max_len=512)
        if mesh.index != 0:
            server.follow(eng, mesh, emb)
            return None
        httpd, loop = server.serve(eng, tokenizer, "127.0.0.1", 0, embedder=emb, mesh=mesh,
                                   max_new_cap=1000)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            resps, wall = concurrent_completions(httpd.server_address[1], server_prompts_,
                                                 TP_SERVE_NEW)
        finally:
            httpd.shutdown()
            loop.shutdown()
        return [r["tokens"] for r in resps], wall

    run("server_tp2", http_round)

    # first-token logits at tp 2 with f32 activations (the embedding in f32)
    params, cfg = load_weight_cache(npz, "cpu")
    params["tok_emb"] = params["tok_emb"].float()
    mesh = make_mesh(1, 2, device="cuda")
    sh = shard_llama_params(params, cfg, mesh)
    del params
    adapter = make_tp_llama_adapter(cfg, mesh)
    ids = torch.tensor([[1] + BPETokenizer.from_tokenizer_bin(tok).encode("abc def ghi")],
                       device=mesh.device)
    with torch.inference_mode():
        hidden, _ = adapter.apply(sh, ids, adapter.init_state(1, 64), 0)
        out["first_logits"] = adapter.lm_head(sh, hidden[:, -1:])[0, 0].cpu().numpy()
    out["backend"] = mesh.describe()
    return out


def serve_cli_requests(argv):
    """The port's serve CLI in-process, quiet: the (prompt, tokens) of
    every request its BatchEngine took."""
    from tpu_llm_torch.runtime import batching, serve_cli

    subs, sub0 = [], batching.BatchEngine.submit

    def submit(self, req):
        subs.append(req)
        return sub0(self, req)

    batching.BatchEngine.submit = submit
    try:
        run_serve_cli(argv)
    finally:
        batching.BatchEngine.submit = sub0
    return [(list(r.prompt), list(r.tokens)) for r in subs]


def greedy_summary(v) -> dict:
    """One greedy_vs_plain row, or the sum over a run's requests."""
    v = [v] if isinstance(v, dict) else v
    return dict(runs=len(v), exact=sum(x["exact"] for x in v),
                near_tie=sum(x["near_tie"] for x in v),
                all_within_rule=all(x["all_within_rule"] for x in v),
                worst_gap_rel=max(x["worst_gap_rel"] for x in v))


def cli_report(stdout: bytes) -> dict:
    """The `llm` CLI's report lines: decode tokens/s and TTFT ms."""
    import re

    text = stdout.decode(errors="replace")
    tok = re.search(r"([0-9.]+) tokens/second", text)
    ttft = re.search(r"TTFT:\s+([0-9.]+) ms", text)
    return dict(tokens_per_s=tok and float(tok.group(1)), ttft_ms=ttft and float(ttft.group(1)))


def tp_full_width(torch, tmp: str):
    """TinyLlama-1.1B at full width and depth, Q4_0 (synth_tinyllama), as a
    .npz weight cache with a tokenizer.bin; two ranks on the one card
    (gloo, printed) run `llm --tp 2` (a 1200-token prompt: K1, K4, K2), its
    FFN megakernel switch (K7 with w13 / w2 local), `llm-serve --tp 2`
    (dense b8, --paged bf16 and int8 pools: 16 requests, 8 sharing a
    prefix), `llm-serve --dp 2` and one `llm-server --tp 2` round of 4
    concurrent completions. Each rank's counts show the run's kernels (the
    llm run's exactly: K1 89 a forward, K2 22 a decode step, K4 22 a
    prefill: no step took a plain path); every greedy token (the K7 run's
    too, and the dense b8 run's at tp 1 on the same requests, its
    baseline) is on the plain path's argmax (teacher-forced, unsharded,
    on the card, over the run's KV dtype); the
    first-token logits with f32 activations within 1e-3 * max|logit| of
    tp 1. Then phase `multiprocess`: the same `llm --tp 2` as two
    processes the smoke starts itself with --coordinator / --num-processes
    / --process-id, its text the launched run's."""
    from tpu_llm_torch.config import tinyllama_1_1b
    from tpu_llm_torch.io.weight_cache import save_weight_cache
    from tpu_llm_torch.parallel.distributed import free_port, launch
    from tpu_llm_torch.tokenizers.tokenizer_bin import write_tokenizer_bin

    cfg = tinyllama_1_1b()
    params = synth_tinyllama(torch, cfg, seed=81)
    npz, tok, pf = (os.path.join(tmp, n) for n in ("tp.npz", "tp_tok.bin", "tp_prompts.txt"))
    t = time.perf_counter()
    save_weight_cache(npz, params, cfg)
    stok = server_tokenizer(torch, cfg.vocab_size)
    write_tokenizer_bin(tok, stok.tokens, [0.0] * cfg.vocab_size)
    prompts = server_prompts(cfg)
    with open(pf, "w") as fh:
        fh.write("\n".join(prompts) + "\n")
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    try:
        ranks = launch(tp_rank, 2, npz, tok, pf, prompts[:4], device="cuda", timeout=900)
    except RuntimeError as e:
        fail(f"tp_full_width: {e}")
    launch_s = time.perf_counter() - t
    runs, total = {}, {n: 0 for n in counters()}
    must = {"llm_tp2": ("qmatmul", "flash_gqa_attention", "flash_decode_attention"),
            "llm_tp2_megakernel": ("qmatmul", "ffn_fused", "flash_decode_attention"),
            "server_tp2": ("qmatmul", "flash_decode_attention"),
            **{k: m for k, (_, m, _) in TP_SERVE_RUNS.items()}}
    for name, kernels in must.items():
        for r, res in enumerate(ranks):
            c = res[name]["counts"]
            if name != "server_tp2" and res[name]["value"] != 0:
                fail(f"{name} rank {r} exited {res[name]['value']}")
            for k in kernels:
                if c[k] <= 0:
                    fail(f"main path {name} rank {r}: kernel {k} was never launched ({c})")
            for k, v in c.items():
                total[k] += v
            runs[f"{name}_rank{r}"] = c
    argv1 = tp_llm_argv(npz, tok)
    i = argv1.index("--tp")
    del argv1[i:i + 2]
    tp1_out, _ = drive_run(torch, "llm_tp1", lambda: run_cli(argv1),
                           ("qmatmul", "flash_gqa_attention", "flash_decode_attention"), runs,
                           total)
    # the dense b8 serving run at tp 1 on the same requests: the baseline
    # that the tp 2 run's greedy tokens are read beside
    t = time.perf_counter()
    tp1_reqs, _ = drive_run(torch, "serve_tp1_dense_b8", lambda: serve_cli_requests(
        ["-m", npz, "-s", tok, "-f", pf, "-n", str(TP_SERVE_NEW), "--device", "cuda",
         "--batch", "8"]), ("qmatmul", "flash_decode_attention"), runs, total)
    serve_tp1_s = time.perf_counter() - t
    steps = TP_NEW - 1
    want = dict(qmatmul=89 * (1 + steps), flash_decode_attention=22 * steps,
                flash_gqa_attention=22)
    for r, res in enumerate(ranks):
        c = res["llm_tp2"]["counts"]
        if any(c[k] != v for k, v in want.items()):
            fail(f"llm --tp 2 rank {r}: launches {c}, want {want} (a step off the kernels)")
    r0 = ranks[0]
    ids = [1] + stok.encode(tp_long_prompt())
    gv = {"llm_tp2": greedy_vs_plain(torch, "llm_tp2", params, cfg, ids,
                                     r0["llm_tp2"]["tokens"][len(ids) - 1:])}
    k7_ids = [1] + stok.encode(TP_K7_PROMPT)
    gv["llm_tp2_megakernel"] = greedy_vs_plain(
        torch, "llm_tp2_megakernel", params, cfg, k7_ids,
        r0["llm_tp2_megakernel"]["tokens"][len(k7_ids) - 1:])
    serve_reqs = {"serve_tp1_dense_b8": tp1_reqs,
                  **{name: r0[name]["requests"] for name in TP_SERVE_RUNS}}
    serve_cache = {"serve_tp1_dense_b8": "bf16",
                   **{name: c for name, (_, _, c) in TP_SERVE_RUNS.items()}}
    for name, reqs in serve_reqs.items():
        if len(reqs) != 16 or any(len(t) != TP_SERVE_NEW for _, t in reqs):
            fail(f"{name}: {[len(t) for _, t in reqs]} tokens, want 16 x {TP_SERVE_NEW}")
        gv[name] = [greedy_vs_plain(torch, f"{name}[{i}]", params, cfg, [1] + p, t,
                                    cache=serve_cache[name])
                    for i, (p, t) in enumerate(reqs)]
    # the dense runs at tp 1 and tp 2 also read against an f32-cache plain
    # path (not a gate: their KV is bf16), to tell a reference's rounding
    # from the tp path's
    f32_ref = {name: [greedy_vs_plain(torch, f"{name}[{i}]_f32_ref", params, cfg, [1] + p, t,
                                      gate=False)
                      for i, (p, t) in enumerate(serve_reqs[name])]
               for name in ("serve_tp1_dense_b8", "serve_tp2_dense_b8")}
    http_tokens, http_wall = r0["server_tp2"]["value"]
    gv["server_tp2"] = [greedy_vs_plain(torch, f"server_tp2[{i}]", params, cfg,
                                        [1] + stok.encode(p), t, cache="bf16")
                        for i, (p, t) in enumerate(zip(prompts[:4], http_tokens))]
    # first-token logits: tp 2 against tp 1 (the unsharded kernel path), f32 activations
    ids_s = torch.tensor([[1] + stok.encode("abc def ghi")], device="cuda")
    p32 = dict(params, tok_emb=params["tok_emb"].float())
    with torch.inference_mode():
        tp1 = first_logits_fn(torch, p32, cfg, ids_s, 64)().cpu().numpy()
    import numpy as np

    err = float(np.abs(r0["first_logits"] - tp1).max())
    tol = 1e-3 * float(np.abs(tp1).max())
    row = dict(model="tinyllama_1.1b", kind="q4_0", layers=cfg.n_layers, ranks=2,
               backend=r0["backend"], write_s=write_s, launch_s=launch_s,
               run_s={k: [res[k]["s"] for res in ranks] for k in must},
               first_logits_max_abs_err=err, first_logits_tol=tol,
               top1_tp2=int(r0["first_logits"].argmax()), top1_tp1=int(tp1.argmax()),
               greedy={k: greedy_summary(v) for k, v in gv.items()},
               greedy_f32_ref={k: greedy_summary(v) for k, v in f32_ref.items()},
               server_wall_s=http_wall, llm_tp2=r0["llm_tp2"]["report"],
               llm_tp1=cli_report(tp1_out),
               tokens_per_s={"serve_tp1_dense_b8": 16 * TP_SERVE_NEW / serve_tp1_s,
                             **{k: 16 * TP_SERVE_NEW / ranks[0][k]["s"] for k in TP_SERVE_RUNS}},
               launches={k: {n: v for n, v in c.items() if v} for k, c in runs.items()})
    emit("tp_full_width", **row)
    if not err <= tol or row["top1_tp2"] != row["top1_tp1"]:
        fail(f"tp 2 first-token logits against tp 1: {err} > {tol} or top-1 differs")

    # phase multiprocess: the same llm --tp 2 as two processes started here
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "tpu_llm_torch.runtime.cli",
                               *tp_llm_argv(npz, tok), "--coordinator", f"localhost:{port}",
                               "--num-processes", "2", "--process-id", str(i), "-v"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    mp_s = time.perf_counter() - t
    rcs = [p.returncode for p in procs]
    first = outs[0][0].split(b"\n")[0]
    tp_text = b"".join(stok.token_bytes(t) for t in r0["llm_tp2"]["tokens"][len(ids) - 1:])
    mrow = dict(rcs=rcs, s=mp_s, rank1_stdout_bytes=len(outs[1][0]),
                mesh=[ln for ln in outs[0][1].decode(errors="replace").splitlines()
                      if ln.startswith("mesh:")],
                equals_launched_run=first.endswith(tp_text.split(b"\n")[0]))
    emit("multiprocess", **mrow)
    if rcs != [0, 0] or not mrow["equals_launched_run"] or mrow["rank1_stdout_bytes"]:
        fail(f"multiprocess llm --tp 2: {mrow} {outs[0][1][-2000:]!r} {outs[1][1][-2000:]!r}")
    del params, p32
    torch.cuda.empty_cache()
    return dict(runs=runs, total=total, row=row, multiprocess=mrow, npz=npz)


# -- phase seq_pipe_full_width: sequence and pipeline parallelism ---------------

SP_MAX_SEQ = 2048          # every case's cache rows; every position stays below
SP_NEW = 16                # greedy tokens a decode case
SP_CP_PROMPT = 1020        # CP decode: rank 1 owns rows 512-1023, rank 2 from 1024
SP_LONG = 2032             # the Ulysses and pipeline prompts: + 16 tokens = 2048 rows
SP_SP_T = 1024             # sequence-parallel prefill rows a batch row
SP_PPTP_PROMPT = 8         # PP x TP: prompt tokens fed one a step, then the greedy ones
# a rank's cache rows against the single-rank path's: elementwise within
# 1e-3 * max|k| (or |v|) of the whole single-rank cache, and per layer the
# difference's Frobenius norm within SP_CACHE_REL of the part's. On these
# random weights and 2048-token prompts a few rows sit at a near-tie in
# attention, where f32 rounding picks the outcome (the single-rank kernel
# path lies 25.6 from its plain twin at row 1806 of the Ulysses prompt).
# Such a row is held instead to SP_TIE_SPREAD times the kernel path's own
# distance from its plain twin there (near_tie_gaps, hold_cache_rows): two
# pairs of f32 routes through one near-tie land apart by amounts up to ~3x
# each other on the card
SP_CACHE_REL = 1e-3
SP_TIE_SPREAD = 4
# the kernels every rank of a run must launch
SP_MUST = {"ring_prefill": ("qmatmul",), "cp_decode": ("qmatmul",),
           "ulysses_prefill": ("qmatmul", "flash_gqa_attention"),
           "ulysses_decode": ("qmatmul", "flash_decode_attention"),
           "sp_prefill": ("qmatmul",),
           "pp_prefill": ("qmatmul", "flash_gqa_attention"),
           "pp_decode": ("qmatmul", "flash_decode_attention"),
           "pp_tp_decode": ("qmatmul", "flash_decode_attention")}


def seq_pipe_prompts(vocab: int):
    """The phase's prompts: BOS and seeded random ids."""
    import numpy as np

    rng = np.random.default_rng(92)
    ids = lambda n: [1] + rng.integers(3, vocab, n - 1).tolist()  # noqa: E731
    return dict(ring=ids(SP_MAX_SEQ), cp=ids(SP_CP_PROMPT), ulysses=ids(SP_LONG),
                sp=[ids(SP_SP_T), ids(SP_SP_T)], pp=[ids(SP_LONG), ids(SP_LONG)],
                pp_tp=ids(SP_PPTP_PROMPT))


def seq_pipe_rank(rank: int, npz: str, prompts: dict, device: str = "cuda"):
    """One of the four ranks of phase seq_pipe_full_width (run by
    tpu_llm_torch.parallel.distributed.launch, gloo on the one card): each
    case on a mesh of its own, f32 activations, an f32 cache. Each run
    (the parallel path alone) is timed, its kernel counts set to 0 before
    and read after, its collectives counted by the mesh and its peak
    memory read; then the rank holds what it holds against the
    single-rank kernel path of the same tokens (one forward over the
    prompt and the tokens the run fed): the first-token logits where it
    has them, and its part of the cache. ``device="cpu"`` runs the same
    cases on CPU tensors (a dry run of the code at a small config)."""
    import torch

    from tpu_llm_torch.io.weight_cache import load_weight_cache
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel import pipeline, ring, sequence, ulysses
    from tpu_llm_torch.parallel.mesh import make_mesh
    from tpu_llm_torch.parallel.serving import _tp_local_cfg, shard_llama_params
    from tpu_llm_torch.parallel.tp_decode import init_tp_cache

    params, cfg = load_weight_cache(npz, device)
    params["tok_emb"] = params["tok_emb"].float()
    dev = torch.device(device)
    card = dev.type == "cuda"
    out = {}

    def run(name, mesh, fn, steps=1):
        mesh.counts.clear()
        reset_counts()
        if card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        value = fn()
        if card:
            torch.cuda.synchronize()
        out[name] = dict(s=time.perf_counter() - t, counts=read_counts(), steps=steps,
                         collectives=dict(mesh.counts), index=(mesh.pipe_index,
                                                               mesh.data_index, mesh.model_index),
                         peak_mb=torch.cuda.max_memory_allocated() / 2**20 if card else None)
        return value

    def reference(ids, first: int):
        """The single-rank kernel path over ``ids``: the logits at position
        ``first``, the hidden state and the cache."""
        c = M.init_cache(cfg, 1, SP_MAX_SEQ, torch.float32, dev)
        x, c = M.forward(params, cfg, torch.tensor([ids], device=dev), c, 0)
        return M.lm_head(params, cfg, x[:, first:first + 1])[0, 0], x, c

    def check_logits(name, got, want):
        out[name].update(logits_err=(got - want).abs().max().item(),
                         logits_tol=1e-3 * want.abs().max().item(),
                         top1=int(got.argmax()), top1_ref=int(want.argmax()))

    def check_cache(name, planes, ref, layers, rows, row0=0, cols=slice(None)):
        """The rows ``rows`` (a slice of cache rows: those the case wrote
        on this rank; its planes' row 0 is row ``row0``) and columns
        ``cols`` of this rank's planes against the same part of its
        layers of the single-rank cache: per layer the difference's
        Frobenius norm over that part's (the largest of these), per row
        the largest |difference| over the layers and columns (the parent
        holds each row to ``cache_tol``, 1e-3 * max|k| (or |v|) of the
        whole single-rank cache, or a near-tie row to SP_TIE_SPREAD times
        the kernel path's distance from its plain twin: hold_cache_rows)."""
        mine = (slice(None), slice(rows.start - row0, rows.stop - row0))
        part = (slice(None), rows, cols)
        out[name]["cache_rows"] = [rows.start, rows.stop]
        for kk in ("k", "v"):
            diffs = [(planes[kk][j][mine] - ref[kk][i][part], ref[kk][i][part])
                     for j, i in enumerate(layers)]
            out[name][f"cache_rel_{kk}"] = max((d.norm() / r.norm()).item() for d, r in diffs)
            out[name][f"cache_rows_{kk}"] = torch.stack(
                [d.abs().amax(dim=(0, 2)) for d, _ in diffs]).amax(0).tolist()
            out[name][f"cache_tol_{kk}"] = 1e-3 * max(c.abs().max().item() for c in ref[kk])

    def greedy(name, mesh, step, cache, tok, pos0, n=SP_NEW):
        toks = []

        def loop():
            nonlocal cache
            t = tok
            for i in range(n):
                logits, cache = step(t, cache, pos0 + i)
                t = logits.argmax(dim=-1)
                toks.append(int(t[0]))
            return logits
        run(name, mesh, loop, steps=n)
        out[name]["tokens"] = toks
        return cache

    def heads(start, n):        # columns [start, start + n): kv heads
        return slice(start, start + n)

    with torch.inference_mode():
        # ring attention (CP) prefill, seq 4, T = 2048
        mesh = make_mesh(1, 4, device=device)
        r = mesh.model_index
        ids = torch.tensor([prompts["ring"]], device=dev)
        Tl = SP_MAX_SEQ // 4

        def ring_prefill():
            c = ring.init_cp_cache(cfg, mesh, 1, SP_MAX_SEQ)
            x, c = ring.prefill_context_parallel(params, cfg, ids, c, mesh)
            return c, (M.lm_head(params, cfg, x[:, -1:])[0, 0] if r == 3 else None)
        cache, logits = run("ring_prefill", mesh, ring_prefill)
        want, _, ref = reference(prompts["ring"], SP_MAX_SEQ - 1)
        if r == 3:
            check_logits("ring_prefill", logits, want)
        L = cfg.n_layers
        check_cache("ring_prefill", cache, ref, range(L), slice(r * Tl, (r + 1) * Tl), r * Tl)
        del cache, ref

        # sequence-sharded decode: the prompt prefilled on rank 0, its rows
        # scattered to their owners, 16 greedy steps across the 1024 boundary
        P = SP_CP_PROMPT
        full = torch.zeros((2 * L, 1, SP_MAX_SEQ, cfg.kv_dim), device=dev)
        tok = torch.zeros(1, dtype=torch.long, device=dev)
        if r == 0:
            lg, _, c = reference(prompts["cp"], P - 1)
            full.copy_(torch.stack(c["k"] + c["v"]))
            tok[0] = lg.argmax()
            del c
        mesh.broadcast(full, 0, mesh.model_group)
        mesh.broadcast(tok, 0, mesh.model_group)
        Sl = SP_MAX_SEQ // 4
        shard = full[:, :, r * Sl:(r + 1) * Sl].clone()
        cache = {"k": list(shard[:L].unbind(0)), "v": list(shard[L:].unbind(0))}
        del full, shard
        kept = {kk: [c.clone() for c in cache[kk]] for kk in cache}
        first = {}

        def cp_step(t, c, pos):
            lg, c = ring.decode_step_context_parallel(params, cfg, t, c, pos, mesh)
            first.setdefault("logits", lg[0])
            return lg, c
        cache = greedy("cp_decode", mesh, cp_step, cache, tok, P)
        out["cp_decode"]["tok0"] = int(tok[0])
        fed = [int(tok[0])] + out["cp_decode"]["tokens"][:-1]
        want, _, ref = reference(prompts["cp"] + fed, P)
        check_logits("cp_decode", first["logits"], want)
        # the rows this rank owns of the 16 the steps wrote, held; the
        # others of its shard as the scatter left them, bit for bit
        a, b = max(P, r * Sl), min(P + SP_NEW, (r + 1) * Sl)
        rest = torch.ones(Sl, dtype=torch.bool, device=dev)
        if a < b:
            check_cache("cp_decode", cache, ref, range(L), slice(a, b), r * Sl)
            rest[a - r * Sl:b - r * Sl] = False
        out["cp_decode"]["cache_kept"] = all(torch.equal(c[:, rest], k[:, rest])
                                             for kk in cache for c, k in zip(cache[kk], kept[kk]))
        del cache, ref, kept

        # Ulysses, degree 4: prefill at T = 2032, the reshard, 16 greedy steps
        T = SP_LONG
        ids = torch.tensor([prompts["ulysses"]], device=dev)

        def uly_prefill():
            c = ring.init_cp_cache(cfg, mesh, 1, T)
            x, c = ulysses.prefill_ulysses(params, cfg, ids, c, mesh)
            lg = M.lm_head(params, cfg, x[:, -1:])[0, 0] if r == 3 else None
            t = torch.zeros(1, dtype=torch.long, device=dev)
            if r == 3:
                t[0] = lg.argmax()
            mesh.broadcast(t, 3, mesh.model_group)
            return ulysses.reshard_cache_for_decode(c, SP_MAX_SEQ, mesh), lg, t
        cache, logits, tok = run("ulysses_prefill", mesh, uly_prefill)
        cache = greedy("ulysses_decode", mesh,
                       lambda t, c, pos: ulysses.decode_ulysses(params, cfg, t, c, pos, mesh),
                       cache, tok, T)
        out["ulysses_decode"]["tok0"] = int(tok[0])
        fed = [int(tok[0])] + out["ulysses_decode"]["tokens"][:-1]
        want, _, ref = reference(prompts["ulysses"] + fed, T - 1)
        if r == 3:
            check_logits("ulysses_prefill", logits, want)
        W = cfg.kv_dim // 4
        check_cache("ulysses_decode", cache, ref, range(L), slice(0, SP_MAX_SEQ),
                    cols=heads(r * W, W))
        del cache, ref

        # sequence parallelism at tp 2 x dp 2, batch 2, T = 1024
        mesh = make_mesh(2, 2, device=device)
        d, m = mesh.data_index, mesh.model_index
        sh = shard_llama_params(params, cfg, mesh)
        lcfg = _tp_local_cfg(cfg, 2)
        ids = torch.tensor([prompts["sp"][d]], device=dev)

        def sp_prefill():
            c = init_tp_cache(cfg, mesh, 2, SP_MAX_SEQ, torch.float32)
            x, c = sequence.prefill_sequence_parallel(sh, cfg, ids, c, mesh)
            last = x[:, -1:].contiguous() if m == 1 else torch.empty_like(x[:, -1:])
            last = mesh.broadcast(last, 1, mesh.model_group)
            return x, c, M.lm_head(sh, lcfg, last, gather_fn=mesh.gather_model)[0, 0]
        x, cache, logits = run("sp_prefill", mesh, sp_prefill)
        want, xr, ref = reference(prompts["sp"][d], SP_SP_T - 1)
        check_logits("sp_prefill", logits, want)
        W = cfg.kv_dim // 2
        check_cache("sp_prefill", cache, ref, range(L), slice(0, SP_SP_T), cols=heads(m * W, W))
        # the rank's rows of the sequence are the single-rank prefill's
        Tl = SP_SP_T // 2
        out["sp_prefill"].update(hidden_err=(x - xr[:, m * Tl:(m + 1) * Tl]).abs().max().item(),
                                 hidden_tol=1e-3 * xr.abs().max().item())
        del sh, cache, ref, x, xr

        # pipeline, pipe 2 x dp 2: 2032 tokens in 2 chunks, 16 greedy steps
        mesh = make_mesh(2, 1, pipe=2, device=device)
        d = mesh.data_index
        sp = pipeline.stage_params(params, cfg, mesh)
        ids = torch.tensor([prompts["pp"][d]], device=dev)

        def pp_prefill():
            c = pipeline.init_stage_cache(cfg, mesh, 2, SP_MAX_SEQ)
            x, c = pipeline.prefill_pipelined(sp, cfg, ids, c, mesh, microbatches=2)
            return c, M.lm_head(sp, cfg, x[:, -1:])[0, 0]
        cache, logits = run("pp_prefill", mesh, pp_prefill)
        tok = logits.argmax().reshape(1)
        cache = greedy("pp_decode", mesh,
                       lambda t, c, pos: pipeline.decode_step_pipelined(sp, cfg, t, c, pos,
                                                                        mesh),
                       cache, tok, T)
        out["pp_decode"]["tok0"] = int(tok[0])
        fed = [int(tok[0])] + out["pp_decode"]["tokens"][:-1]
        want, _, ref = reference(prompts["pp"][d] + fed, T - 1)
        check_logits("pp_prefill", logits, want)
        check_cache("pp_decode", cache, ref, pipeline.stage_layers(cfg, mesh),
                    slice(0, SP_LONG + SP_NEW))
        del sp, cache, ref

        # PP x TP, pipe 2 x tp 2: the prompt fed a step at a time, 16 greedy steps
        mesh = make_mesh(1, 2, pipe=2, device=device)
        m = mesh.model_index
        sp = pipeline.stage_params(params, cfg, mesh)
        cache = pipeline.init_stage_cache(cfg, mesh, 1, SP_MAX_SEQ)
        step = lambda t, c, pos: pipeline.decode_step_pp_tp(sp, cfg, t, c, pos, mesh)  # noqa: E731
        pr = prompts["pp_tp"]
        feed = torch.tensor(pr, device=dev)

        def pp_tp_prompt():
            nonlocal cache
            for i in range(len(pr)):
                lg, cache = step(feed[i:i + 1], cache, i)
            return lg[0]
        logits = run("pp_tp_prompt", mesh, pp_tp_prompt, steps=len(pr))
        tok = logits.argmax().reshape(1)
        cache = greedy("pp_tp_decode", mesh, step, cache, tok, len(pr))
        out["pp_tp_decode"]["tok0"] = int(tok[0])
        fed = [int(tok[0])] + out["pp_tp_decode"]["tokens"][:-1]
        want, _, ref = reference(pr + fed, len(pr) - 1)
        check_logits("pp_tp_prompt", logits, want)
        W = cfg.kv_dim // 2
        check_cache("pp_tp_decode", cache, ref, pipeline.stage_layers(cfg, mesh),
                    slice(0, len(pr) + SP_NEW), cols=heads(m * W, W))
        out["backend"] = mesh.describe()
    return out


def near_tie_gaps(torch, params, cfg, ids, plain=None):
    """Per cache row of ``ids``, k and v: the largest |difference| over the
    layers and columns between the single-rank kernel path's cache and its
    plain twin's (``plain``: that cache when the caller has it), as CPU
    tensors. Where SP_TIE_SPREAD times it passes a case's tolerance, the
    row is at a near-tie."""
    from tpu_llm_torch.models import llama as M

    seq = torch.tensor([ids], device="cuda")

    def cache():
        c = M.init_cache(cfg, 1, SP_MAX_SEQ, torch.float32, "cuda")
        return M.forward(params, cfg, seq, c, 0)[1]
    with torch.inference_mode():
        kern = cache()
        if plain is None:
            with plain_path():
                plain = cache()
    n = len(ids)
    return {kk: torch.stack([(a[:, :n] - b[:, :n]).abs().amax(dim=(0, 2))
                             for a, b in zip(kern[kk], plain[kk])]).amax(0).cpu()
            for kk in ("k", "v")}


def hold_cache_rows(torch, label, x, gaps):
    """A rank's cache rows (seq_pipe_rank's ``cache_rows_*``) against
    ``gaps`` (near_tie_gaps over the same tokens, or zeros): each row
    within the case's ``cache_tol``, or, at a near-tie row (SP_TIE_SPREAD
    times its gap past that tolerance), within SP_TIE_SPREAD times the
    gap. Fails the smoke on any row beyond; returns what it held."""
    a, b = x["cache_rows"]
    held = {}
    for kk in ("k", "v"):
        d, gap, tol = torch.tensor(x[f"cache_rows_{kk}"]), gaps[kk][a:b], x[f"cache_tol_{kk}"]
        tie = SP_TIE_SPREAD * gap > tol
        over = d > torch.where(tie, SP_TIE_SPREAD * gap, torch.full_like(gap, tol))
        held[kk] = dict(tol=tol, max_abs=d.max().item(),
                        max_abs_off_ties=d[~tie].max().item() if (~tie).any() else 0.0,
                        near_tie_rows=(a + tie.nonzero()[:, 0]).tolist()[:8],
                        n_near_tie_rows=int(tie.sum()),
                        rows_over=(a + over.nonzero()[:, 0]).tolist()[:8])
        if over.any():
            fail(f"{label}: cache {kk} rows off the single-rank path beyond {tol} "
                 f"(or {SP_TIE_SPREAD}x their near-tie gap): {held[kk]}")
    return held


def seq_pipe_full_width(torch, npz: str):
    """Ring attention, sequence-sharded decode, Ulysses, sequence-parallel
    prefill, the pipeline and PP x TP (tpu_llm_torch.parallel) at
    TinyLlama-1.1B width and depth, Q4_0 (phase tp_full_width's .npz), f32
    activations and caches: one launch of four ranks on the one card
    (gloo) runs every case (seq_pipe_rank). Each rank's counts show its
    run's kernels, exactly as the code launches them (K1 on every path,
    K4 on the Ulysses and pipeline prefills, K2 on the Ulysses, pipeline
    and PP x TP decode); each rank's first-token logits (where it has them)
    lie within 1e-3 * max|logit| of the single-rank kernel path with the
    same top-1; the cache rows it wrote lie within 1e-3 * max|k| (or |v|)
    of that path's elementwise, except at a near-tie row, held to
    SP_TIE_SPREAD times the kernel path's own distance from its plain twin
    there (hold_cache_rows), and within SP_CACHE_REL of that path's per
    layer (Frobenius, relative); a CP rank leaves the rows it does not own
    as they were; every greedy token is on the plain path's argmax under
    greedy_vs_plain's near-tie rule."""
    from tpu_llm_torch.config import tinyllama_1_1b
    from tpu_llm_torch.io.weight_cache import load_weight_cache
    from tpu_llm_torch.parallel.distributed import launch

    cfg = tinyllama_1_1b()
    prompts = seq_pipe_prompts(cfg.vocab_size)
    t = time.perf_counter()
    try:
        ranks = launch(seq_pipe_rank, 4, npz, prompts, device="cuda", timeout=900)
    except RuntimeError as e:
        fail(f"seq_pipe_full_width: {e}")
    launch_s = time.perf_counter() - t
    L = cfg.n_layers
    Ls = L // 2                                 # a pipeline stage's layers
    q_fwd = 4 * L                               # K1 launches of a forward (fused layout)
    want = {"ring_prefill": lambda ix: dict(qmatmul=q_fwd + (ix[2] == 3), flash_gqa_attention=0,
                                            flash_decode_attention=0),
            "cp_decode": lambda ix: dict(qmatmul=(q_fwd + 1) * SP_NEW, flash_decode_attention=0),
            "ulysses_prefill": lambda ix: dict(qmatmul=q_fwd + (ix[2] == 3),
                                               flash_gqa_attention=L),
            "ulysses_decode": lambda ix: dict(qmatmul=(q_fwd + 1) * SP_NEW,
                                              flash_decode_attention=L * SP_NEW),
            "sp_prefill": lambda ix: dict(qmatmul=q_fwd + 1, flash_gqa_attention=L),
            "pp_prefill": lambda ix: dict(qmatmul=4 * Ls * 2 + 1, flash_gqa_attention=Ls * 2),
            "pp_decode": lambda ix: dict(qmatmul=(4 * Ls + 1) * SP_NEW,
                                         flash_decode_attention=Ls * SP_NEW),
            "pp_tp_prompt": lambda ix: dict(qmatmul=(4 * Ls + 1) * SP_PPTP_PROMPT,
                                            flash_decode_attention=Ls * SP_PPTP_PROMPT),
            "pp_tp_decode": lambda ix: dict(qmatmul=(4 * Ls + 1) * SP_NEW,
                                            flash_decode_attention=Ls * SP_NEW)}
    runs, total = {}, {n: 0 for n in counters()}
    for name, fn in want.items():
        for r, res in enumerate(ranks):
            c = res[name]["counts"]
            for k in SP_MUST.get(name, ()):
                if c[k] <= 0:
                    fail(f"main path {name} rank {r}: kernel {k} was never launched ({c})")
            w = fn(res[name]["index"])
            if any(c[k] != v for k, v in w.items()):
                fail(f"{name} rank {r}: launches {c}, want {w}")
            for k, v in c.items():
                total[k] += v
            runs[f"{name}_rank{r}"] = c
    # the held numbers, on every rank that has them
    held = {}
    for name in want:
        for r, res in enumerate(ranks):
            x = res[name]
            if "logits_err" in x:
                held.setdefault(name, {})[f"rank{r}_logits"] = [x["logits_err"], x["logits_tol"]]
                if not x["logits_err"] <= x["logits_tol"] or x["top1"] != x["top1_ref"]:
                    fail(f"{name} rank {r}: first-token logits off the single-rank path: "
                         f"{x['logits_err']} > {x['logits_tol']} or top-1 "
                         f"{x['top1']} != {x['top1_ref']}")
            for kk in ("k", "v"):
                if f"cache_rel_{kk}" in x:
                    held.setdefault(name, {})[f"rank{r}_cache_rel_{kk}"] = x[f"cache_rel_{kk}"]
                    if not x[f"cache_rel_{kk}"] <= SP_CACHE_REL:
                        fail(f"{name} rank {r}: cache {kk} off the single-rank path: "
                             f"{x[f'cache_rel_{kk}']} > {SP_CACHE_REL} (Frobenius, relative)")
            if "cache_kept" in x and not x["cache_kept"]:
                fail(f"{name} rank {r}: a cache row the rank does not own was written")
            if "hidden_err" in x and not x["hidden_err"] <= x["hidden_tol"]:
                fail(f"{name} rank {r}: hidden rows off the single-rank prefill: "
                     f"{x['hidden_err']} > {x['hidden_tol']}")
    # greedy tokens: alike on the ranks of a batch row, on the plain argmax;
    # then each case's tokens (a batch row's) give the near-tie rows
    params, _ = load_weight_cache(npz, "cuda")
    params["tok_emb"] = params["tok_emb"].float()
    gv, gaps = {}, {}
    for name, prompt_of in (("cp_decode", lambda d: prompts["cp"]),
                            ("ulysses_decode", lambda d: prompts["ulysses"]),
                            ("pp_decode", lambda d: prompts["pp"][d]),
                            ("pp_tp_decode", lambda d: prompts["pp_tp"])):
        by_row = {}
        for res in ranks:
            x = res[name]
            by_row.setdefault(x["index"][1], []).append([x["tok0"]] + x["tokens"])
        for d, seqs in sorted(by_row.items()):
            if any(sq != seqs[0] for sq in seqs):
                fail(f"{name}: the ranks of batch row {d} generated different tokens: {seqs}")
            gv[f"{name}[{d}]"], plain = greedy_vs_plain(torch, f"{name}[{d}]", params, cfg,
                                                        prompt_of(d), seqs[0], keep_cache=True)
            gaps[name, d] = near_tie_gaps(torch, params, cfg, prompt_of(d) + seqs[0][:-1],
                                          plain)
            del plain
    gaps["ring_prefill", 0] = near_tie_gaps(torch, params, cfg, prompts["ring"])
    for d in (0, 1):
        gaps["sp_prefill", d] = near_tie_gaps(torch, params, cfg, prompts["sp"][d])
    del params
    torch.cuda.empty_cache()
    rows_held = {}
    for name in want:
        for r, res in enumerate(ranks):
            x = res[name]
            if "cache_rows" in x:
                rows_held[f"{name}_rank{r}"] = hold_cache_rows(
                    torch, f"{name} rank {r}", x, gaps[name, x["index"][1]])

    def per(name, res):
        """The rank's collectives a step (or a prefill), counted."""
        n = res[name]["steps"]
        return {k: v / n for k, v in res[name]["collectives"].items()}

    row = dict(model="tinyllama_1.1b", kind="q4_0", layers=L, ranks=4, activations="f32",
               backend=ranks[0]["backend"], launch_s=launch_s,
               run_s={name: [res[name]["s"] for res in ranks] for name in want},
               collectives_a_step={name: [per(name, res) for res in ranks] for name in want},
               peak_mb={name: [res[name]["peak_mb"] for res in ranks] for name in want},
               held=held, cache_rows=rows_held,
               greedy={k: greedy_summary(v) for k, v in gv.items()},
               launches={k: {n: v for n, v in c.items() if v} for k, c in runs.items()})
    emit("seq_pipe_full_width", **row)
    return dict(runs=runs, total=total, row=row)


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
                           **{f"qwen2_{n}_case": dict(weight=f"qwen2_{n}", x="float32")
                              for n in QWEN2_SHAPES},
                           **{f"qwen2_{n}_bf16_case": dict(weight=f"qwen2_{n}", x="bfloat16")
                              for n in QWEN2_SHAPES}},
               "flash_decode_attention": {"llama2_7b_case": dict(D=128, Hkv=32),
                                          "phi2_d80_case": dict(D=80),
                                          "qwen2_g7_case": dict(H=28, Hkv=4)},
               "flash_decode_fused": {"phi2_d80_case": dict(D=80)},
               "paged_flash_decode_attention": {"batch1_case": dict(pool="bf16", B=1),
                                                "bs64_case": dict(pool="bf16", BS=64, B=8),
                                                "phi2_d80_case": dict(D=80)},
               "paged_flash_decode_q": {"batch1_case": dict(pool="int8", B=1)}}
# the local shapes of a TinyLlama rank at tp 2 (check_tp_shapes)
for _name, _pick in (("flash_decode_attention", dict(tp=2, B=8)),
                     ("flash_decode_fused", dict(tp=2)),
                     ("flash_gqa_attention", dict(tp=2, T=512)),
                     ("paged_flash_decode_attention", dict(tp=2)),
                     ("paged_flash_decode_q", dict(tp=2)),
                     ("ffn_fused", dict(tp=2, rows=1))):
    EXTRA_CASES.setdefault(_name, {})["tp2_case"] = _pick
EXTRA_CASES["qmatmul"].update({f"{n}_case": dict(weight=n, rows=1) for n in TP2_SHAPES})
# the shapes of a rank of phase seq_pipe_full_width (check_seq_pipe_shapes)
EXTRA_CASES["flash_gqa_attention"].update(
    seq_pipe_ulysses_case=dict(seq_pipe="ulysses_prefill"),
    seq_pipe_sp_case=dict(seq_pipe="sp_prefill"),
    seq_pipe_pp_chunk0_case=dict(seq_pipe="pp_prefill", offset=0),
    seq_pipe_pp_chunk1_case=dict(seq_pipe="pp_prefill", offset=SP_LONG // 2))
EXTRA_CASES["flash_decode_attention"].update(
    {f"seq_pipe_{p}_case": dict(seq_pipe=f"{p}_decode") for p in ("ulysses", "pp", "pp_tp")})

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
    with tempfile.TemporaryDirectory() as tmp:
        mf = mamba_full_width(torch, tmp)
        mc = mamba_cli_phase(torch, tmp, mf["paths"]["mamba_130m"])
        ct = checkpoint_tools(torch, tmp)
        pp = perplexity_phase(torch, ct["gguf"])
        lo = lora_full_width(torch, tmp, ct["gguf"])
        tpf = tp_full_width(torch, tmp)
        spf = seq_pipe_full_width(torch, tpf["npz"])
    bc = bench_cli_full_width(torch)
    phases = (fw, sc, sv, hs, mk, f32, kq, fam, mf, mc, ct, pp, lo, tpf, spf, bc)
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
            out[-1]["tp2_unfused_ms"] = case(name, dict(tp=2, rows=1))["unfused_ms"]
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
