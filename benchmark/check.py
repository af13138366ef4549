"""What decides ``correct``: a sample of the greedy requests the window
finished, held against the plain reference of the configuration's
architecture (its module's ``logits_at``, ``arch/<arch>.py``).

The sample is drawn from the run's seed and always holds the request with
the most served tokens; more are added until ``check.served_tokens``
tokens are in it. The reference runs once over each request's BOS, prompt
and served tokens, and at each served position reads the gap by which the
served token's logit lies below its best logit. ``max_gap`` is the widest
such gap: 0 where the program's greedy choice is the reference's, small
where a near-tie fell the other way, large where a token is wrong. A
cell's ``limits/<workload>.json`` holds its limits. ``overrun`` counts requests given more tokens than they asked
for. The control (``control.py``) is judged by the same numbers, with the
reference one precision lower in the program's place.

A mixture of experts is judged in two parts where the run recorded the
program's routing (``routes.py``). The reference takes the experts the
program chose at every layer and position, with the program's gate
weights, so that ``max_gap`` judges the layers around the router: with
random weights at Mixtral's width the gates amplify rounding layer after
layer, and a reference that routed or weighted for itself would leave the
program's path. The router is judged on its own, against the reference's
router logits at the same positions: ``route_gap``, the widest amount by
which the reference's k-th largest logit exceeds the smallest logit among
the experts chosen (0 where the sets agree), and ``router_gap``, the widest
difference between the router's logits and the reference's, which is what
the gate weights follow. The control takes the program's routing for
``max_gap``, and its own logits and top k for the other two. A run that
recorded routes but lacks one for a sampled position fails all three.
"""

from __future__ import annotations

import random
from typing import List

import torch

from benchmark.record import Req, Run

NO_SAMPLE = 1e30             # max_gap of a run that finished no greedy request


def finished(run: Run) -> List[Req]:
    """The greedy requests the run finished (in its ramp, window or drain)."""
    return [r for r in run.requests if r.spec.greedy and r.done and r.tokens]


def sample(run: Run, served_tokens: int, seed: int) -> List[Req]:
    pool = finished(run)
    if not pool:
        return []
    longest = max(pool, key=lambda r: (len(r.tokens), r.spec.index))
    rest = [r for r in pool if r is not longest]
    random.Random(seed).shuffle(rest)
    out, n = [longest], len(longest.tokens)
    for r in rest:
        if n >= served_tokens:
            break
        out.append(r)
        n += len(r.tokens)
    return out


def sequences(reqs: List[Req], bos_id: int):
    """(token ids, logits span, served tokens) of each request: the logits at
    positions n_in - 1 .. predict its served tokens."""
    seqs, spans, served = [], [], []
    for r in reqs:
        seqs.append([bos_id] + list(r.spec.prompt) + r.tokens[:-1])
        spans.append((r.n_in - 1, r.n_in - 1 + len(r.tokens)))
        served.append(r.tokens)
    return seqs, spans, served


def gaps(logits: List[torch.Tensor], chosen: List[torch.Tensor]) -> torch.Tensor:
    """Each chosen token's distance below the best logit at its position."""
    out = []
    for lg, tok in zip(logits, chosen):
        tok = tok.to(lg.device).long()
        out.append(lg.max(dim=-1).values - lg.gather(-1, tok[:, None])[:, 0])
    return torch.cat(out)


def router_gaps(ref_logits: List[torch.Tensor], logits: List[torch.Tensor], k: int):
    """(route_gap, router_gap) of router ``logits`` against the reference's
    at every layer (each layer's (positions, n_experts) logits): the widest
    amount by which the reference's k-th largest logit exceeds the
    smallest of the experts the logits choose (their top k), and the widest
    difference of the logits themselves."""
    route = router = 0.0
    for ref, lg in zip(ref_logits, logits):
        lg = lg.to(ref.device)
        chosen = torch.topk(torch.softmax(lg, dim=-1), k, dim=-1).indices
        kth = torch.topk(ref, k, dim=-1).values[:, -1]
        route = max(route, (kth - ref.gather(-1, chosen).min(dim=-1).values).max().item())
        router = max(router, (lg - ref).abs().max().item())
    return route, router


def check(arch, cfg: dict, raw: dict, run: Run, mix: dict, limits: dict, seed: int) -> dict:
    """The numbers that decide ``correct``, each with its limit."""
    return judged(arch, cfg, raw, run, mix, limits, seed)[None]


def judged(arch, cfg: dict, raw: dict, run: Run, mix: dict, limits: dict, seed: int,
           controls=()) -> dict:
    """{None: the program's numbers} and, for each precision in ``controls``,
    the numbers of the reference at that precision put in the program's
    place: the tokens it puts first at the same served positions, fed the
    same prompts and served tokens (the reference: ``arch.logits_at``, of
    the configuration's architecture module). Each number has its limit;
    the run's overrun is the same for all."""
    reqs = sample(run, mix["check"]["served_tokens"], seed)
    overrun = sum(len(r.tokens) > r.spec.max_new for r in run.requests)
    routed = run.routes is not None
    keys = ("max_gap", "route_gap", "router_gap") if routed else ("max_gap",)
    found = {a: dict.fromkeys(keys, NO_SAMPLE) for a in (None, *controls)}
    seqs, spans, served = sequences(reqs, int(cfg["bos_token_id"]))
    got = [run.routes.of(r.rid, len(s)) for r, s in zip(reqs, seqs)] if routed else None
    if reqs and not (routed and any(x is None for x in got)):
        k = int(cfg.get("num_experts_per_tok", 0))
        routes = [g[:2] for g in got] if routed else None       # experts, gate weights
        rl = [] if routed else None
        ref = arch.logits_at(cfg, raw, seqs, spans, "f32", routes, rl)
        found[None]["max_gap"] = gaps(ref, [torch.tensor(s) for s in served]).max().item()
        if routed:
            found[None]["route_gap"], found[None]["router_gap"] = router_gaps(
                rl, [torch.cat([g[2][li] for g in got]) for li in range(len(rl))], k)
        for act in controls:
            low_rl = [] if routed else None
            low = arch.logits_at(cfg, raw, seqs, spans, act, routes, low_rl)
            found[act]["max_gap"] = gaps(ref, [lg.argmax(dim=-1) for lg in low]).max().item()
            if routed:
                found[act]["route_gap"], found[act]["router_gap"] = router_gaps(rl, low_rl, k)
    return {act: {**{n: {"value": v, "limit": limits[n]} for n, v in nums.items()},
                  "overrun": {"value": overrun, "limit": 0}}
            for act, nums in found.items()}


def verdict(numbers: dict) -> bool:
    """``correct``: every number within its limit."""
    return all(n["value"] <= n["limit"] for n in numbers.values())
