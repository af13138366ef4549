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
   2e-2 * max|plain|), kernel / plain / library times (CUDA events, L2
   flushed before every launch, median), and the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate of
   their type, whichever is larger).
   The paged decode kernels (K5, K6) run at serving shapes (batch 8, 32/4
   heads, 1024-row tables, shuffled blocks, positions 15-1023), and again
   with every block past pos // BS and block 0 poisoned (NaN): the output
   must not change. K2 and K4 run again at the shapes serving gives them
   (bf16 q over bf16 planes: K2 at batch 8 with positions 15-1023, K4 over
   one slot's 1024-row view at offset 256 and 0). K1's library time is
   torch._weight_int4pack_mm.
3. cli — the port's `llm` CLI on a tiny GGUF (f32 and Q4_0, written here
   with the port's own writer), --dtype f32 and native, on the card and on
   the CPU: the greedy text must be identical.
4. serve_cli — the port's `llm-serve` on the tiny GGUF, dense, --paged and
   --paged --cache-dtype int8, on the card and on the CPU: the same
   completions.
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
   the device-busy share of 16 profiled engine steps; one batched decode
   step's logits held against the plain path.
Each main-path run starts with every launch count at 0 and reads the
counts after; a kernel of the path that never launched fails the run.

The last lines: the card's name and power limit, the kernels JSON, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
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


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
             "flash_gqa_attention": []}

    def compare(name, got, want, bf16: bool, **info):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name} {info}: non-finite output")
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        tol = (2e-2 if bf16 else 1e-3) * ref
        if not err <= tol:
            fail(f"{name} {info}: max abs err {err} > tolerance {tol}")
        return err, tol

    def record(name, info, err, tol, ms, plain_ms, lib_ms, bmoved, ops, kind):
        b_ms, b_by = bound(bmoved, ops, kind)
        row = dict(info, max_abs_err=err, tol=tol, kernel_ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        cases[name].append(row)
        emit("kernel", name=name, **row)

    # K1: every projection of a TinyLlama layer and the classifier, decode
    # rows 1 and 8, plus prefill rows 512 on w13
    shapes = {"wqkv": (2048, 2560), "wo": (2048, 2048), "w13": (2048, 11264),
              "w2": (5632, 2048), "wcls": (2048, 32000)}
    runs = [(n, kn, r) for kn in ("q4_0", "q8_0") for n in shapes for r in (1, 8)]
    runs += [("w13", kn, 512) for kn in ("q4_0", "q8_0")]
    for wname, kind, rows in runs:
        K, N = shapes[wname]
        if kind == "q4_0":
            q = torch.randint(0, 256, (K // 2, N), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
        else:
            q = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                              dtype=torch.int32).to(torch.int8)
        scales = torch.rand((K // 32, N), generator=g, device=dev) * 0.009 + 0.001
        w = QTensor(q, scales, kind)
        x = torch.randn((rows, K), generator=g, device=dev).bfloat16()
        out_dtype = torch.float32 if wname == "wcls" else torch.bfloat16
        got = qmatmul(x, w, out_dtype=out_dtype)
        want = qmatmul_plain(x, w, out_dtype=out_dtype)
        info = dict(weight=wname, kind=kind, rows=rows, K=K, N=N, x="bf16",
                    out=str(out_dtype).replace("torch.", ""))
        err, tol = compare("qmatmul", got, want, True, **info)
        ms = timer.ms(lambda: qmatmul(x, w, out_dtype=out_dtype))
        plain_ms = timer.ms(lambda: qmatmul_plain(x, w, out_dtype=out_dtype))
        lib_ms = None
        if kind == "q4_0" and rows <= 8:
            lib_ms = int4pack_ms(torch, timer, x, w, want, info)
        record("qmatmul", info, err, tol, ms, plain_ms, lib_ms,
               w.nbytes + nbytes(x) + rows * N * got.element_size(),
               2.0 * rows * K * N, "bf16")

    # K2 / K3: TinyLlama decode attention, batch 1, S = 2048, bf16 q,
    # f32 cache (the CLI's default cache dtype)
    B, H, Hkv, D, S = 1, 32, 4, 64, 2048
    kc = torch.randn((B, S, Hkv * D), generator=g, device=dev)
    vc = torch.randn((B, S, Hkv * D), generator=g, device=dev)
    q = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
    k_cur = torch.randn((B, 1, Hkv * D), generator=g, device=dev).bfloat16()
    v_cur = torch.randn((B, 1, Hkv * D), generator=g, device=dev).bfloat16()
    it = kc.element_size()

    def sdpa(n_keys):
        # one library call over the same cache rows (GQA, no mask needed:
        # every row < n_keys is visible to the one query)
        k4 = kc.view(B, S, Hkv, D)[:, :n_keys].transpose(1, 2)
        v4 = vc.view(B, S, Hkv, D)[:, :n_keys].transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q.float().transpose(1, 2), k4, v4, enable_gqa=True)

    for pos in (15, 1000, 2047):
        p = torch.tensor([pos], dtype=torch.int32, device=dev)
        info = dict(B=B, H=H, Hkv=Hkv, D=D, S=S, pos=pos, q="bf16", cache="f32")
        got = FA.flash_decode_attention(q, kc, vc, p)
        err, tol = compare("flash_decode_attention", got,
                           FA.flash_decode_attention_plain(q, kc, vc, p), True, **info)
        record("flash_decode_attention", info, err, tol,
               timer.ms(lambda: FA.flash_decode_attention(q, kc, vc, p)),
               timer.ms(lambda: FA.flash_decode_attention_plain(q, kc, vc, p)),
               timer.ms(sdpa(pos + 1)),
               nbytes(q) * 2 + 2 * B * (pos + 1) * Hkv * D * it,
               4.0 * B * H * (pos + 1) * D, "f32")

        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got, _, _ = FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)
        want, _, _ = FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)
        err, tol = compare("flash_decode_fused", got, want, True, **info)
        for new, old, cur in ((k1, kc, k_cur), (v1, vc, v_cur)):
            if not torch.equal(new[:, pos], cur[:, 0].float()):
                fail(f"flash_decode_fused pos={pos}: row pos is not this step's k/v")
            rest = torch.ones(S, dtype=torch.bool, device=dev)
            rest[pos] = False
            if not torch.equal(new[:, rest], old[:, rest]):
                fail(f"flash_decode_fused pos={pos}: a row other than pos changed")
        record("flash_decode_fused", info, err, tol,
               timer.ms(lambda: FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)),
               timer.ms(lambda: FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)),
               timer.ms(sdpa(pos + 1)),
               nbytes(q) * 2 + 2 * B * pos * Hkv * D * it + nbytes(k_cur, v_cur)
               + 2 * Hkv * D * it,
               4.0 * B * H * (pos + 1) * D, "f32")

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


def int4pack_ms(torch, timer, x, w, want, info):
    """torch._weight_int4pack_mm on the same q4_0 weight (repacked once,
    outside the timed region): q4_0 is (n - 8) * d, the op's scale-and-zero
    form with zero 0; the op keeps its scales in bf16. None, with the
    reason emitted, when the installed torch lacks the op on the card."""
    K2, N = w.q.shape
    q = w.q.reshape(K2 // 16, 16, N).int()
    vals = torch.cat([q & 15, q >> 4], dim=1).reshape(2 * K2, N).t()   # (N, K) 0..15
    try:
        packed = torch._convert_weight_to_int4pack(
            ((vals[:, ::2] << 4) | vals[:, 1::2]).to(torch.uint8).contiguous(), 8)
        sz = torch.stack([w.scales.bfloat16(), torch.zeros_like(w.scales, dtype=torch.bfloat16)],
                         dim=-1).contiguous()
        fn = lambda: torch._weight_int4pack_mm(x, packed, 32, sz)  # noqa: E731
        err = (fn().float() - want.float()).abs().max().item()
    except (AttributeError, RuntimeError, NotImplementedError) as e:
        emit("library_int4pack", **info, available=False, reason=str(e)[:200])
        return None
    ms = timer.ms(fn)
    emit("library_int4pack", **info, available=True, ms=ms, max_abs_err_vs_plain=err)
    return ms


PAGED_POS = [15, 100, 257, 511, 700, 900, 1000, 1023]


def check_paged_kernels(torch, timer, g, compare, record, cases):
    """K5 (bf16 and f32 pools, block 16) and K6 (int8 pools, block 32)
    against their plain twins at serving shapes: batch 8, 32/4 heads,
    head_dim 64, max_seq 1024, shuffled tables, positions PAGED_POS. Then
    block 0 and every block past pos // BS poisoned: the same output.
    Library: F.scaled_dot_product_attention over the rows gathered (and,
    for int8, dequantized) beforehand, masked to s <= pos; the gather is
    not timed."""
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.ops.kv_cache import dequantize_kv
    from tpu_llm_torch.ops.paged_kv import (PagedKV, paged_gather, scale_pool_width,
                                            scale_rows_per_block)

    F = torch.nn.functional
    dev = "cuda"
    B, H, Hkv, D, max_seq = 8, 32, 4, 64, 1024
    pos = torch.tensor(PAGED_POS, dtype=torch.int32, device=dev)
    q_bf = torch.randn((B, 1, H, D), generator=g, device=dev).bfloat16()
    cases["paged_flash_decode_attention"] = []
    cases["paged_flash_decode_q"] = []
    for name, pool, BS in (("paged_flash_decode_attention", "bf16", 16),
                           ("paged_flash_decode_attention", "f32", 16),
                           ("paged_flash_decode_q", "int8", 32)):
        MB = max_seq // BS
        N = 1 + B * MB
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
        q = q_bf if pool != "f32" else q_bf.float()
        kernel = getattr(FA, name)
        plain = getattr(FA, name + "_plain")
        args = (q, kp, vp, *scales, table, pos)
        info = dict(B=B, H=H, Hkv=Hkv, D=D, BS=BS, MB=MB, pool=pool,
                    q=str(q.dtype).replace("torch.", ""), positions=PAGED_POS)
        got = kernel(*args)
        err, tol = compare(name, got, plain(*args), pool != "f32", **info)

        # poison block 0 and every block no row reads (past pos // BS)
        live = set()
        for b in range(B):
            live.update(table[b, :PAGED_POS[b] // BS + 1].tolist())
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
        rows_read = sum(p + 1 for p in PAGED_POS)
        it = kp.element_size()
        moved = (nbytes(q) * 2 + 2 * rows_read * Hkv * D * it
                 + sum(4 * (p // BS + 1) for p in PAGED_POS)             # table entries
                 + (2 * rows_read * Hkv * 4 if pool == "int8" else 0))   # scales
        record(name, dict(info, library="sdpa over pre-gathered rows (gather not timed)"),
               err, tol, timer.ms(lambda: kernel(*args)), timer.ms(lambda: plain(*args)),
               timer.ms(lambda: F.scaled_dot_product_attention(
                   qs, k4, v4, attn_mask=mask, enable_gqa=True)),
               moved, 4.0 * H * D * rows_read, "f32")


# -- phase 3: the CLI on a tiny GGUF ---------------------------------------------

def write_tiny_gguf(path: str, quant: bool, seed: int = 0):
    """The recipe of tests/make_tiny_gguf.py::build (same RNG sequence):
    2 layers, dim 64, 4 heads / 2 kv heads, ffn 96, a 32-token toy vocab."""
    import numpy as np

    from tpu_llm_torch.io import gguf as gg

    rng = np.random.default_rng(seed)
    dim, hidden, L, H, KVH, V = 64, 96, 2, 4, 2, 32
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


def check_cli(tmp: str):
    results = []
    for quant in (False, True):
        path = os.path.join(tmp, f"tiny_{'q4_0' if quant else 'f32'}.gguf")
        write_tiny_gguf(path, quant)
        for dtype in ("f32", "native"):
            args = ["-m", path, "-p", "abc", "-n", "12", "--dtype", dtype]
            card = run_cli(args + ["--device", "cuda"]).split(b"\n")[0]
            cpu = run_cli(args + ["--device", "cpu"]).split(b"\n")[0]
            row = dict(model=os.path.basename(path), dtype=dtype,
                       cuda=card.decode(errors="replace"),
                       cpu=cpu.decode(errors="replace"), equal=card == cpu)
            emit("cli", **row)
            if card != cpu or not card.startswith(b"abc") or len(card) <= 3:
                fail(f"cli greedy output differs between card and CPU: {row}")
            results.append(row)
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
    base = ["-m", path, "-p", "abc", "-p", "ab", "-p", "abc abc ab", "-p", "abc abc b",
            "-n", "6", "--batch", "2", "--dtype", "f32"]
    for mode, flags in SERVE_MODES.items():
        card, card_sum = run_serve_cli(base + flags + ["--device", "cuda"])
        cpu, _ = run_serve_cli(base + flags + ["--device", "cpu"])
        comp = [(r["completion"], r["n_tokens"]) for r in card]
        row = dict(mode=mode, cuda=comp, cpu=[(r["completion"], r["n_tokens"]) for r in cpu],
                   summary=card_sum)
        emit("serve_cli", **row)
        if row["cuda"] != row["cpu"] or len(comp) != 4 or any(n != 6 for _, n in comp):
            fail(f"serve_cli completions differ between card and CPU: {row}")


# -- phase 5: full width ---------------------------------------------------------

def synth_tinyllama_q4(torch, cfg, seed: int):
    """TinyLlama-shaped packed Q4_0 weights built on the card from a seeded
    generator (fused wqkv / w13 layout, per-layer list)."""
    from tpu_llm_torch.quant.qtensor import QTensor

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    E, Fh, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim

    def qt(K, N):
        q = torch.randint(0, 256, (K // 2, N), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
        s = torch.rand((K // 32, N), generator=g, device="cuda") * 0.009 + 0.001
        return QTensor(q, s, "q4_0")

    ones = lambda: torch.ones(E, device="cuda")  # noqa: E731
    layers = [{"attn_norm": ones(), "ffn_norm": ones(), "wqkv": qt(E, E + 2 * KV),
               "wo": qt(E, E), "w13": qt(E, 2 * Fh), "w2": qt(Fh, E)}
              for _ in range(cfg.n_layers)]
    emb = (torch.randn((V, E), generator=g, device="cuda") * 0.02).bfloat16()
    return {"tok_emb": emb, "final_norm": ones(), "wcls": qt(E, V), "layers": layers}


def profile_busy(torch, run, steps: int):
    """torch.profiler around ``run()`` (``steps`` steps, ending
    synchronized): device busy time (sum of kernel times on the one
    stream) over wall time, and the kernels that take the most of it. The
    profiler slows the host, so the busy share is a lower bound on the
    unprofiled one."""
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
    return dict(steps=steps, wall_ms_per_step=wall_us / steps / 1e3,
                device_ms_per_step=busy_us / steps / 1e3,
                device_busy_share=busy_us / wall_us,
                top=[dict(kernel=k[:80], ms_per_step=us / steps / 1e3,
                          calls_per_step=c / steps) for us, k, c in rows[:10]])


def profile_decode(torch, params, cfg, max_seq: int, steps: int):
    """The device busy share over ``steps`` decode steps of the CLI path
    (K2, positions 16..)."""
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

        return profile_busy(torch, run, steps)


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls to their plain twins (on the card)."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.quant import linear, qmatmul

    from tpu_llm_torch.ops import paged_kv

    swaps = [(M, n) for n in ("flash_decode_attention", "flash_decode_fused",
                              "flash_gqa_attention")]
    swaps += [(paged_kv, n) for n in ("paged_flash_decode_attention", "paged_flash_decode_q",
                                      "flash_gqa_attention")]
    saved = [(mod, n, getattr(mod, n)) for mod, n in swaps]
    saved_q = linear.qmatmul
    try:
        linear.qmatmul = qmatmul.qmatmul_plain
        for mod, n in swaps:
            setattr(mod, n, getattr(FA, n + "_plain"))
        yield
    finally:
        linear.qmatmul = saved_q
        for mod, n, f in saved:
            setattr(mod, n, f)


def counters():
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.quant import qmatmul

    return {"qmatmul": qmatmul.qmatmul, "flash_decode_attention": FA.flash_decode_attention,
            "flash_decode_fused": FA.flash_decode_fused,
            "flash_gqa_attention": FA.flash_gqa_attention,
            "paged_flash_decode_attention": FA.paged_flash_decode_attention,
            "paged_flash_decode_q": FA.paged_flash_decode_q}


def reset_counts():
    for f in counters().values():
        f.launches = 0


def read_counts():
    return {n: f.launches for n, f in counters().items()}


def full_width(torch):
    import numpy as np

    from tpu_llm_torch.config import tinyllama_1_1b
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    # random weights need no column permutation: the neox form is what
    # fold_rope_interleave makes of an interleaved checkpoint
    cfg = dataclasses.replace(tinyllama_1_1b(), rope_variant="neox")
    t0 = time.perf_counter()
    params = synth_tinyllama_q4(torch, cfg, seed=7)
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

    def first_logits():
        c = M.init_cache(cfg, 1, max_seq, torch.float32, "cuda")
        x, _ = M.forward(params, cfg, ids, c, 0)
        return M.lm_head(params, cfg, x[:, -1:])[0, 0]

    with torch.inference_mode():
        kern = first_logits()
        with plain_path():
            plain = first_logits()
    if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
        fail("full-width logits are not finite")
    err = (kern - plain).abs().max().item()
    tol = 2e-2 * plain.abs().max().item()
    top2 = torch.topk(plain, 2).values
    row = dict(top1_kernel=int(kern.argmax()), top1_plain=int(plain.argmax()),
               max_abs_err=err, tol=tol, max_abs_logit=plain.abs().max().item(),
               top2_gap=(top2[0] - top2[1]).item())
    emit("logits_vs_plain", **row)
    if row["top1_kernel"] != row["top1_plain"] or not err <= tol:
        fail(f"full-width logits differ from the plain path: {row}")

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
        prof = profile_busy(torch, lambda: [eng.step() for _ in range(16)], 16)
        row["launches_per_step"] = {k: v / 16 for k, v in read_counts().items()}
        row["profile"] = prof
        emit("serve_full_width", **row)
        runs[label] = row
        decode_logits_vs_plain(torch, eng, params, cfg, requests, label)
        del eng
        torch.cuda.empty_cache()
    return dict(runs=runs, total=total)


# -- main --------------------------------------------------------------------------

KERNELS = [
    ("qmatmul", "tpu_llm_torch/csrc/qmatmul.cu", "tpu_llm/quant/pallas_matmul.py:59",
     dict(weight="w13", kind="q4_0", rows=1)),
    ("flash_decode_attention", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:121", dict(cache="bf16")),
    ("flash_decode_fused", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:801", dict(pos=1000)),
    ("flash_gqa_attention", "tpu_llm_torch/csrc/flash_attention.cu",
     "tpu_llm/ops/flash_attention.py:51", dict(T=512, cache="bf16")),
    ("paged_flash_decode_attention", "tpu_llm_torch/csrc/paged_attention.cu",
     "tpu_llm/ops/flash_attention.py:264", dict(pool="bf16")),
    ("paged_flash_decode_q", "tpu_llm_torch/csrc/paged_attention.cu",
     "tpu_llm/ops/flash_attention.py:439", dict(pool="int8")),
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
        check_serve_cli(tmp)
    fw, params, cfg = full_width(torch)
    emit("full_width", **{k: v for k, v in fw.items() if k != "runs"})
    sv = serve_full_width(torch, params, cfg)
    total = {k: fw["total"][k] + sv["total"][k] for k in fw["total"]}

    out = []
    for name, source, replaces, pick in KERNELS:
        rep = next(c for c in cases[name] if all(c.get(k) == v for k, v in pick.items()))
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total[name],
            "max_abs_err": rep["max_abs_err"],
            "max_abs_err_all_cases": max(c["max_abs_err"] for c in cases[name]),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "case": pick,
        })
    print(smi_line)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
