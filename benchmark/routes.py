"""The routing the program chose, read from its own router, for a
configuration with experts.

While installed, the record keeps the output of the router projection of
every MoE layer of every forward that an entry has announced (``begin``):
the (B, T, experts) f32 logits the program computed, held as they are (no
copy, no launch, no host read). The router is found by identity: the
projection whose weight is a layer's ``router``, passed through the
function that the architecture module names as its ``router_site``
(``(module, name)``). After the run ``of`` gives, for every position of
one request (BOS and prompt from its prefill, each served token from the
decode step that fed it), the router's logits and what they choose by the
program's rule: the experts (softmax over the experts, the top k) and
their gate weights (the k renormalised to sum 1), by the same operations
on the same tensor on the same device.

An entry says which rows of the forward hold which request (``begin``):
(row, request id, first position, positions). Rows it does not name
(padding, dead slots) are not kept.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch


class Routes:
    def __init__(self, params: dict, k: int, site: Tuple[str, str]):
        self.k = k
        self.site = site
        self.layer_of = {id(lp["router"]): i for i, lp in enumerate(params["layers"])
                         if "router" in lp}
        self.n_layers = len(params["layers"])
        # (rows, per-layer router logits) of each announced forward
        self.calls: List[Tuple[list, list]] = []
        self._now: Optional[list] = None
        self._orig = None
        self._chosen: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    # -- while the program runs ------------------------------------------------

    def install(self) -> None:
        module, name = self.site
        mod = importlib.import_module(module)
        rec, orig = self, getattr(mod, name)
        self._orig = orig

        def matmul(x, w, out_dtype=None, row_scale=None):
            y = orig(x, w, out_dtype=out_dtype, row_scale=row_scale)
            i = rec.layer_of.get(id(w))
            if i is not None and rec._now is not None:
                rec._now[i] = y
            return y

        setattr(mod, name, matmul)

    def uninstall(self) -> None:
        if self._orig is not None:
            module, name = self.site
            setattr(importlib.import_module(module), name, self._orig)
            self._orig = None
        self._now = None

    def begin(self, rows: list) -> None:
        """The next forward's rows: [(row, request id, first position, n)]."""
        self._now = [None] * self.n_layers
        self.calls.append((rows, self._now))

    # -- after the run ---------------------------------------------------------------

    def _experts(self, c: int) -> Tuple[torch.Tensor, ...]:
        """(layers, B, T, k) experts and gate weights and (layers, B, T,
        n_experts) logits of call ``c``, on the host."""
        if c not in self._chosen:
            idx, gates = [], []
            for lg in self.calls[c][1]:
                topw, topi = torch.topk(torch.softmax(lg, dim=-1), self.k, dim=-1)
                topw = topw / torch.sum(topw, dim=-1, keepdim=True)
                idx.append(topi.cpu())
                gates.append(topw.cpu())
            self._chosen[c] = (torch.stack(idx), torch.stack(gates),
                               torch.stack([lg.float().cpu() for lg in self.calls[c][1]]))
        return self._chosen[c]

    def of(self, rid: int, n: int) -> Optional[Tuple[torch.Tensor, ...]]:
        """(experts, gate weights, router logits) that the program had at
        positions 0..n-1 of request ``rid``, (layers, n, k) and (layers, n,
        n_experts); None where a position has none."""
        out = None
        seen = torch.zeros(n, dtype=torch.bool)
        for c, (rows, logits) in enumerate(self.calls):
            for row, r, p0, m in rows:
                if r != rid or p0 >= n:
                    continue
                if any(lg is None for lg in logits):
                    return None
                m = min(m, n - p0)
                got = self._experts(c)
                if out is None:
                    out = [torch.zeros((self.n_layers, n, g.shape[-1]), dtype=g.dtype)
                           for g in got]
                for o, g in zip(out, got):
                    o[:, p0:p0 + m] = g[:, row, :m]
                seen[p0:p0 + m] = True
        return tuple(out) if out is not None and bool(seen.all()) else None
