"""One fixed offline-batch job through ``BatchEngine``, as ``llm-serve
--batch N`` runs it: a dense cache of ``max_seq`` rows a slot, one
dedicated prefill an admission, one batched decode a step.

The job is the mix's first ``steps`` engine steps over its requests in
the mix's order: before each step the loop hands the engine one request
for every slot that the step will find free, so admission follows the
engine's steps and not the clock, and two runs of one seed do the same
steps, with the same rows and prefills, in the same order. The window is
the whole job, from the first submit until the last step's tokens are
read; ``seconds`` does not change it (``steps`` is sized on the card).

Set-up builds the engine and warms up every prefill bucket the mix's
prompts fall in and the decode step. For a configuration with experts
the run records the experts the program chose (``routes.py``): the entry
names the request and positions of every prefill row and live decode row.
"""

from __future__ import annotations

import time

import torch

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
    (the paged engine shares them)."""
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


def follow(eng, routes) -> None:
    """Name the rows of every prefill and decode forward for ``routes``:
    an admission's prompt rows, and each live slot's row at its position."""
    prefill, decode = eng._prefill, eng._decode

    def _prefill(idx, toks, last_idx):
        routes.begin([(0, eng.slots[idx].req.rid, 0, last_idx + 1)])
        return prefill(idx, toks, last_idx)

    def _decode(offsets):
        routes.begin([(i, s.req.rid, s.pos - 1, 1)
                      for i, s in enumerate(eng.slots) if not s.free])
        return decode(offsets)

    eng._prefill, eng._decode = _prefill, _decode


def run(ctx) -> Run:
    from tpu_llm_torch.runtime.batching import BatchEngine, Request

    from benchmark.routes import Routes

    mix = ctx.mix
    e = mix["engine"]
    dtype = DTYPES[e["cache_dtype"]]
    eng = BatchEngine(ctx.params, ctx.arch.adapter(ctx.pcfg, dtype, ctx.bos_id, ctx.device),
                      batch=e["batch"], max_seq=e["max_seq"], eos_id=ctx.eos_id)
    lo, hi = ctx.cfg_file["token_ids"]
    g = torch.Generator().manual_seed(0)
    for n in _buckets(mix["prompt"]["min"], mix["prompt"]["max"]):
        eng.submit(Request(prompt=torch.randint(lo, hi, (n,), generator=g).tolist(),
                           max_new=3))
    eng.run()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    routes = None
    if ctx.d["X"]:
        routes = Routes(ctx.params, ctx.d["k"], ctx.arch.router_site)
        follow(eng, routes)
    if ctx.rec is not None:
        instrument(ctx, eng, dtype.itemsize)

    t_open = ctx.open_window(time.perf_counter(), mix.get("trace_end_s"))
    run = Run(t_open=t_open, t_close=t_open, setup_s=t_open - ctx.t_start, routes=routes)

    def send():
        spec = next(ctx.specs)
        now = time.perf_counter()
        r = Req(spec=spec, due=now, sent=now, n_in=len(spec.prompt) + 1)

        def stream(tok, r=r):
            r.times.append(time.perf_counter())
            r.tokens.append(tok)
            r.done = len(r.tokens) >= spec.max_new

        r.rid = eng.submit(Request(prompt=spec.prompt, max_new=spec.max_new,
                                   temperature=spec.temperature, seed=spec.seed,
                                   stream=stream,
                                   stop_at_eos=mix.get("stop_at_eos", False))).rid
        run.requests.append(r)

    if routes is not None:
        routes.install()
    try:
        for _ in range(mix["steps"]):
            now = time.perf_counter()
            ctx.tick(now)
            for _ in range(sum(s.free for s in eng.slots) - len(eng._queue)):
                send()
            with ctx.span("engine step"):
                n = eng.step()
            run.steps.append((now, time.perf_counter(), n))
        eng._collect()                         # the last step's tokens
        if ctx.device == "cuda":
            torch.cuda.synchronize()
    finally:
        if routes is not None:
            routes.uninstall()
    run.t_close = run.t_end = time.perf_counter()

    def release():
        nonlocal eng
        eng = None

    run.release = release
    return run
