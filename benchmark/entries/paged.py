"""Open-loop serving through the program's paged engine (the architecture
module's ``paged_engine``), as ``llm-serve --paged`` runs it: a paged KV
pool with prefix caching, chunked prefill, continuous batching over the
mix's slots.

Set-up builds the engine, warms up every shape the mix can send (each
prefill-tail bucket, the chunked prefill, the decode step with and
without the top-p filter), resets it, and then starts the arrival
schedule ``ramp_s`` before the window opens, so the window opens on a
loaded engine. Each request is timed from its due time. After the window
the loop keeps stepping, untimed, until every request due in the window
has its first token and the finished greedy requests hold the check's
sample (at most ``drain_s``).
"""

from __future__ import annotations

import time

import torch

from benchmark import check
from benchmark.entries.batch import DTYPES, instrument_steps
from benchmark.record import Req, Run



def _engine(ctx):
    e = ctx.mix["engine"]
    bs = e["block_size"]
    return ctx.arch.paged_engine(ctx, batch=e["batch"], n_blocks=1 + e["pool_tokens"] // bs,
                                 block_size=bs, max_seq=e["max_seq"], eos_id=ctx.eos_id,
                                 bos_id=ctx.bos_id, cache_dtype=DTYPES[e["cache_dtype"]],
                                 prefill_chunk=e["prefill_chunk"], device=ctx.device)


def warm_lengths(mix: dict):
    """Prompt lengths whose tails (+ BOS) land in every prefill bucket up to
    the chunk, and one long enough for two chunks and a tail, within the
    mix's longest prompt."""
    chunk, top = mix["engine"]["prefill_chunk"], mix["prompt"]["max"]
    out, b = [], 16
    while b <= chunk:
        out.append(b * 3 // 4)
        b *= 2
    out.append(2 * chunk + chunk // 4)
    return sorted({min(n, top) for n in out})


def warm_up(ctx, eng) -> None:
    from tpu_llm_torch.runtime.batching import Request

    lo, hi = ctx.cfg_file["token_ids"]
    g = torch.Generator().manual_seed(0)
    samp = ctx.mix.get("sampling", {})
    for temp in (0.0, samp.get("temperature", 0.0)):
        for n in warm_lengths(ctx.mix):
            ids = torch.randint(lo, hi, (n,), generator=g).tolist()
            eng.submit(Request(prompt=ids, max_new=3, temperature=temp,
                               top_p=samp.get("top_p", 1.0) if temp else 1.0))
        eng.run()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    eng.reset()


def instrument(ctx, eng, kv_bytes: int) -> None:
    """Spans and the prefill forwards' work, for the traced run."""
    rec = ctx.rec
    peak = ctx.attn_peak(kv_bytes)
    admit, part, tail = eng._admit, eng._prefill_part, eng._prefill_tail

    def _admit():
        with rec.span("admit (prefill)"):
            return admit()

    def _part(idx, toks, pos0):
        rec.forward([(pos0, toks.shape[1])], 0, kv_bytes, peak)
        return part(idx, toks, pos0)

    def _tail(idx, toks, pos0, last_idx):
        rec.forward([(pos0, last_idx + 1)], 1, kv_bytes, peak)
        return tail(idx, toks, pos0, last_idx)

    eng._admit, eng._prefill_part, eng._prefill_tail = _admit, _part, _tail
    instrument_steps(ctx, eng, kv_bytes)


def run(ctx) -> Run:
    from tpu_llm_torch.runtime.batching import Request

    mix = ctx.mix
    eng = _engine(ctx)
    kv_bytes = DTYPES[mix["engine"]["cache_dtype"]].itemsize
    warm_up(ctx, eng)
    if ctx.rec is not None:
        instrument(ctx, eng, kv_bytes)
    t_sched = time.perf_counter()
    t_open = ctx.open_window(t_sched + mix["ramp_s"])
    t_close = t_open + ctx.seconds
    run = Run(t_open=t_open, t_close=t_close, setup_s=t_open - ctx.t_start)
    pool = eng._n_blocks - 1
    spec = next(ctx.specs)
    hits0 = None
    blocks_peak = 0

    def submit(spec) -> Req:
        due = t_sched + spec.due
        r = Req(spec=spec, due=due, sent=time.perf_counter(), n_in=len(spec.prompt) + 1)

        def stream(tok, r=r):
            r.times.append(time.perf_counter())
            r.tokens.append(tok)
            if len(r.tokens) >= spec.max_new:
                r.done = True

        eng.submit(Request(prompt=spec.prompt, max_new=spec.max_new,
                           temperature=spec.temperature, top_p=spec.top_p, seed=spec.seed,
                           stream=stream, stop_at_eos=mix.get("stop_at_eos", False)))
        run.requests.append(r)
        return r

    while True:
        now = time.perf_counter()
        if hits0 is None and now >= t_open:
            hits0 = eng.prefix.hits
        ctx.tick(now)
        while spec.due + t_sched <= now and spec.due + t_sched < t_close:
            submit(spec)
            spec = next(ctx.specs)
        if now >= t_close:
            waiting = [r for r in run.due_in_window() if r.first is None]
            short = sum(len(r.tokens) for r in check.finished(run)) < mix["check"]["served_tokens"]
            if now >= t_close + mix["drain_s"] or not (waiting or short and eng.n_active):
                break
        if eng._queue or eng.n_active:
            with ctx.span("engine step"):
                n = eng.step()
            t1 = time.perf_counter()
            run.steps.append((now, t1, n))
            if t_open <= t1 < t_close:
                blocks_peak = max(blocks_peak, eng.hbm_blocks_in_use)
            if t1 < t_close:
                run.counters["hits_close"] = eng.prefix.hits
        else:
            nxt = min(spec.due + t_sched, t_close)
            with ctx.span("idle (no request)"):
                time.sleep(max(0.0, min(nxt - now, 0.002)))
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    run.t_end = time.perf_counter()
    for r in run.requests:
        r.failed = r.first is None
    run.counters.update(
        hits_open=hits0 or 0, block_size=eng.block_size, pool_blocks=pool,
        blocks_peak=blocks_peak,
        prompt_tokens=sum(r.n_in for r in run.requests
                          if r.first is not None and t_open <= r.first < t_close))

    def release():
        nonlocal eng
        eng = None

    run.release = release
    return run
