"""One user at a time through ``Engine.generate(..., use_scan=True)``, as
``llm --scan`` runs it: the prompt's prefill, then a CUDA graph of one
decode step replayed once a token, the tokens fetched at the end.

Set-up builds the engine, warms up every prefill bucket the mix's prompts
fall in and captures the decode graph. The window is whole requests: it
opens as the first request starts and closes as the last request that
started within ``seconds`` of it ends, so every token of every request
in it, and all of their time, count.
"""

from __future__ import annotations

import time

import torch

from benchmark.entries.batch import DTYPES, _buckets
from benchmark.record import Req, Run


def instrument(ctx, eng, kv_bytes: int) -> None:
    rec = ctx.rec
    peak = ctx.attn_peak(kv_bytes)
    prefill, graph = eng._prefill, eng._run_decode_graph

    def _prefill(tokens, last_idx, state=None):
        rec.forward([(0, last_idx + 1)], 1, kv_bytes, peak)
        with rec.span("prefill"):
            return prefill(tokens, last_idx, state)

    def _graph(first, pos, steps, *a, **k):
        rec.graph_pos = pos
        for i in range(steps):
            rec.forward([(pos + i, 1)], 1, kv_bytes, peak)
        with rec.span("graph replays"):
            return graph(first, pos, steps, *a, **k)

    eng._prefill, eng._run_decode_graph = _prefill, _graph


def run(ctx) -> Run:
    from tpu_llm_torch.runtime.engine import Engine

    mix = ctx.mix
    e = mix["engine"]
    dtype = DTYPES[e["cache_dtype"]]
    eng = Engine(ctx.params, ctx.arch.adapter(ctx.pcfg, dtype, ctx.bos_id, ctx.device),
                 max_seq=e["max_seq"], device=ctx.device)
    lo, hi = ctx.cfg_file["token_ids"]
    g = torch.Generator().manual_seed(0)
    for n in _buckets(mix["prompt"]["min"], mix["prompt"]["max"]):
        eng.generate(torch.randint(lo, hi, (n,), generator=g).tolist(), n_new=3,
                     use_scan=True)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    if ctx.rec is not None:
        instrument(ctx, eng, dtype.itemsize)

    t_open = ctx.open_window(time.perf_counter())
    run = Run(t_open=t_open, t_close=t_open, setup_s=t_open - ctx.t_start)
    while True:
        now = time.perf_counter()
        ctx.tick(now)
        if now >= t_open + ctx.seconds:
            break
        spec = next(ctx.specs)
        r = Req(spec=spec, due=now, sent=now, n_in=len(spec.prompt) + 1)
        with ctx.span("generate"):
            res = eng.generate(spec.prompt, n_new=spec.max_new, use_scan=True)
        end = time.perf_counter()
        r.tokens = res.tokens[len(spec.prompt):]
        r.times = [end] * len(r.tokens)
        r.done = len(r.tokens) == spec.max_new
        run.requests.append(r)
        run.chats.append((now, end, res.ttft_s, res.decode_s, max(len(r.tokens) - 1, 0)))
        run.t_close = time.perf_counter()          # after every token it received
    run.t_end = run.t_close

    def release():
        nonlocal eng
        eng = None

    run.release = release
    return run
