"""The one traffic generator: a mix file (``benchmark/traffic/<mix>.json``)
of parameters in, a stream of request specs out.

Every seed gets the same work: the sizes and the arrivals come from the
mix's own ``size_seed``, and the run's seed draws only the token ids, the
system prompts and each request's sampling seed. Sizes are stratified:
requests come in blocks of ``block``, and in each block the prompt
lengths are the ``block`` quantiles (u = (j + jitter) / block) of a
clipped log-normal, the output lengths likewise, and so are the gaps
between arrivals (exponential, for an open loop at ``rate_per_s``), each
in an order of their own; the shared-prefix and greedy slots of a block
hold their shares exactly. (Seeds that reorder the sizes moved a
window's TTFT tail by a quarter between seeds, against 1-3% between two
runs of one seed.)

Token ids are uniform over the configuration's ``token_ids`` range (the
vocabulary without its special ids). A request with a shared prefix
begins with one of ``prefix.count`` system prompts of ``prefix.tokens``
ids (drawn once a run), followed by at least 16 ids of its own.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
from typing import Iterator, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PREFIX_OWN_MIN = 16          # ids of its own after a shared system prompt


@dataclasses.dataclass
class Spec:
    index: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    prefix: int = -1             # which system prompt, or -1
    due: Optional[float] = None  # seconds after the schedule's start (open loop)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def lognormal_quantile(u: float, dist: dict) -> int:
    """The u-quantile of a log-normal of median ``dist["median"]`` and log
    standard deviation ``dist["sigma"]``, clipped to [min, max]."""
    z = statistics.NormalDist().inv_cdf(min(max(u, 1e-9), 1 - 1e-9))
    v = dist["median"] * math.exp(dist["sigma"] * z)
    return int(min(max(round(v), dist["min"]), dist["max"]))


def _block_sizes(mix: dict, b: int, what: str) -> np.ndarray:
    """The ``block`` stratified draws of one block for ``what`` (the same
    for every run seed)."""
    G = mix["block"]
    rng = np.random.default_rng([mix["size_seed"], b, {"prompt": 0, "output": 1,
                                                       "gap": 2}[what]])
    u = (np.arange(G) + rng.random(G)) / G
    if what == "gap":
        return -np.log1p(-u) / mix["rate_per_s"]
    dist = mix[what]
    return np.array([lognormal_quantile(x, dist) for x in u])


def _slots(G: int, share: float) -> np.ndarray:
    """A 0/1 vector with round(share * G) ones."""
    out = np.zeros(G, dtype=bool)
    out[:int(round(share * G))] = True
    return out


def stream(mix: dict, token_ids, seed: int) -> Iterator[Spec]:
    """Endless request specs of ``mix`` for the run's ``seed``."""
    G = mix["block"]
    lo, hi = token_ids
    rng = np.random.default_rng([int(seed), 0x5EED])        # the run's content
    order = np.random.default_rng([mix["size_seed"], 0x0D])  # the mix's shape
    pre = mix.get("prefix") or {"share": 0.0, "count": 0, "tokens": 0}
    systems = [rng.integers(lo, hi, pre["tokens"]).tolist() for _ in range(pre["count"])]
    samp = mix.get("sampling") or {}
    greedy_share = samp.get("greedy_share", 1.0 if samp.get("temperature", 0.0) == 0 else 0.0)
    t, i, b = 0.0, 0, 0
    while True:
        prompts = order.permutation(_block_sizes(mix, b, "prompt"))
        outputs = order.permutation(_block_sizes(mix, b, "output"))
        gaps = order.permutation(_block_sizes(mix, b, "gap")) if "rate_per_s" in mix else None
        shared = order.permutation(_slots(G, pre["share"]))
        greedy = order.permutation(_slots(G, greedy_share))
        which = order.permutation(np.arange(G) % max(pre["count"], 1))
        for j in range(G):
            n = int(prompts[j])
            prefix = -1
            ids: List[int] = []
            if shared[j] and systems:
                prefix = int(which[j])
                ids = list(systems[prefix])
                n = max(n, len(ids) + PREFIX_OWN_MIN)
            ids += rng.integers(lo, hi, n - len(ids)).tolist()
            due = None
            if gaps is not None:
                t += float(gaps[j])
                due = t
            temp = 0.0 if greedy[j] else float(samp.get("temperature", 0.0))
            yield Spec(index=i, prompt=ids, max_new=int(outputs[j]), temperature=temp,
                       top_p=1.0 if temp == 0.0 else float(samp.get("top_p", 1.0)),
                       seed=int(rng.integers(0, 2 ** 31)), prefix=prefix, due=due)
            i += 1
        b += 1


def describe(specs: List[Spec]) -> dict:
    """The drawn distribution of ``specs``, for the run's report."""
    if not specs:
        return {"requests": 0}

    def summary(xs):
        xs = sorted(xs)
        return {"min": xs[0], "p50": xs[len(xs) // 2],
                "p95": xs[min(len(xs) - 1, math.ceil(0.95 * len(xs)) - 1)], "max": xs[-1],
                "mean": sum(xs) / len(xs)}

    out = {"requests": len(specs),
           "prompt_tokens": summary([len(s.prompt) for s in specs]),
           "output_tokens": summary([s.max_new for s in specs]),
           "shared_prefix_share": sum(s.prefix >= 0 for s in specs) / len(specs),
           "greedy_share": sum(s.greedy for s in specs) / len(specs)}
    dues = [s.due for s in specs if s.due is not None]
    if len(dues) > 1:
        out["offered_rate_per_s"] = (len(dues) - 1) / (dues[-1] - dues[0])
    return out
