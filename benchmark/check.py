"""What decides ``correct``: a sample of the greedy requests the window
finished, held against the plain reference (``reference/model.py``).

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
"""

from __future__ import annotations

import random
from typing import List

import torch

from benchmark.record import Req, Run
from benchmark.reference import model as reference

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


def check(cfg: dict, raw: dict, run: Run, mix: dict, limits: dict, seed: int) -> dict:
    """The numbers that decide ``correct``, each with its limit."""
    return judged(cfg, raw, run, mix, limits, seed)[None]


def judged(cfg: dict, raw: dict, run: Run, mix: dict, limits: dict, seed: int,
           controls=()) -> dict:
    """{None: the program's numbers} and, for each precision in ``controls``,
    the numbers of the reference at that precision put in the program's
    place: the tokens it puts first at the same served positions, fed the
    same prompts and served tokens. Each number has its limit; the run's
    overrun is the same for all."""
    reqs = sample(run, mix["check"]["served_tokens"], seed)
    overrun = sum(len(r.tokens) > r.spec.max_new for r in run.requests)
    found = {a: NO_SAMPLE for a in (None, *controls)}
    if reqs:
        seqs, spans, served = sequences(reqs, int(cfg["bos_token_id"]))
        ref = reference.logits_at(cfg, raw, seqs, spans, "f32")
        found[None] = gaps(ref, [torch.tensor(s) for s in served]).max().item()
        for act in controls:
            low = reference.logits_at(cfg, raw, seqs, spans, act)
            found[act] = gaps(ref, [lg.argmax(dim=-1) for lg in low]).max().item()
    return {act: {"max_gap": {"value": g, "limit": limits["max_gap"]},
                  "overrun": {"value": overrun, "limit": 0}}
            for act, g in found.items()}


def verdict(numbers: dict) -> bool:
    """``correct``: every number within its limit."""
    return all(n["value"] <= n["limit"] for n in numbers.values())
