"""A closed loop of ``clients`` offline-batch clients through ``BatchEngine``,
as ``llm-serve --batch N`` runs it by default: a dense cache of
``max_seq`` rows a slot, one dedicated prefill an admission, one batched
decode a step. Each client sends its next request as soon as its last one
completes.

Set-up builds the engine, warms up every prefill bucket the mix's prompts
fall in and the decode step, resets it, and runs the loop for ``ramp_s``
before the window opens. When the window closes the clients stop sending;
the loop steps on, untimed, until the finished requests hold the check's
sample (at most ``drain_s``), and abandons the rest.
"""

from __future__ import annotations

import time

import torch

from benchmark import check
from benchmark.record import Req, Run

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _buckets(lo: int, hi: int):
    """Prompt lengths (+ BOS) that land in every power-of-two bucket
    between the mix's shortest and longest prompt."""
    out, b = [], 16
    while b < 2 * (hi + 1):
        n = min(b, hi + 1) - 1                 # the bucket's longest prompt
        if n + 1 > lo:
            out.append(max(n, lo))
        b *= 2
    return sorted(set(out))


def instrument_steps(ctx, eng, kv_bytes: int) -> None:
    """A batch engine's decode and host read, for the traced run: their
    spans, the decode rows' positions and each decode forward's work
    (PagedEngine shares them)."""
    rec = ctx.rec
    peak = ctx.attn_peak(kv_bytes)
    decode, collect = eng._decode, eng._collect

    def _decode(offsets):
        live = [(i, s.pos - 1) for i, s in enumerate(eng.slots) if not s.free]
        rec.pos_hint = [0] * eng.batch
        for i, p in live:
            rec.pos_hint[i] = p
        rec.forward([(p, 1) for _, p in live], len(live), kv_bytes, peak)
        with rec.span("decode"):
            return decode(offsets)

    def _collect(*a):
        with rec.span("collect (host read)"):
            return collect(*a)

    eng._decode, eng._collect = _decode, _collect


def instrument(ctx, eng, kv_bytes: int) -> None:
    rec = ctx.rec
    peak = ctx.attn_peak(kv_bytes)
    prefill = eng._prefill

    def _prefill(idx, toks, last_idx):
        rec.forward([(0, last_idx + 1)], 1, kv_bytes, peak)
        with rec.span("admit (prefill)"):
            return prefill(idx, toks, last_idx)

    eng._prefill = _prefill
    instrument_steps(ctx, eng, kv_bytes)


def run(ctx) -> Run:
    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import ModelAdapter

    mix = ctx.mix
    e = mix["engine"]
    dtype = DTYPES[e["cache_dtype"]]
    eng = BatchEngine(ctx.params, ModelAdapter.llama(ctx.pcfg, dtype, bos_id=ctx.bos_id,
                                                     device=ctx.device),
                      batch=e["batch"], max_seq=e["max_seq"], eos_id=ctx.eos_id)
    lo, hi = ctx.cfg_file["token_ids"]
    g = torch.Generator().manual_seed(0)
    for n in _buckets(mix["prompt"]["min"], mix["prompt"]["max"]):
        eng.submit(Request(prompt=torch.randint(lo, hi, (n,), generator=g).tolist(),
                           max_new=3))
    eng.run()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    eng.reset()
    if ctx.rec is not None:
        instrument(ctx, eng, dtype.itemsize)

    t_start_loop = time.perf_counter()
    t_open = ctx.open_window(t_start_loop + mix["ramp_s"])
    t_close = t_open + ctx.seconds
    run = Run(t_open=t_open, t_close=t_close, setup_s=t_open - ctx.t_start)
    live = []

    def send():
        spec = next(ctx.specs)
        now = time.perf_counter()
        r = Req(spec=spec, due=now, sent=now, n_in=len(spec.prompt) + 1)

        def stream(tok, r=r):
            r.times.append(time.perf_counter())
            r.tokens.append(tok)
            r.done = len(r.tokens) >= spec.max_new

        eng.submit(Request(prompt=spec.prompt, max_new=spec.max_new,
                           temperature=spec.temperature, seed=spec.seed, stream=stream,
                           stop_at_eos=mix.get("stop_at_eos", False)))
        run.requests.append(r)
        live.append(r)

    for _ in range(mix["clients"]):
        send()
    while True:
        now = time.perf_counter()
        ctx.tick(now)
        if now >= t_close and (now >= t_close + mix["drain_s"] or not eng.n_active or sum(
                len(r.tokens) for r in check.finished(run)) >= mix["check"]["served_tokens"]):
            break
        with ctx.span("engine step"):
            n = eng.step()
        run.steps.append((now, time.perf_counter(), n))
        for r in [r for r in live if r.done]:
            live.remove(r)
            if now < t_close:
                send()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    run.t_end = time.perf_counter()

    def release():
        nonlocal eng
        eng = None

    run.release = release
    return run
