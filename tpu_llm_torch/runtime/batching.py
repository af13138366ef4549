"""Continuous batching engine (``tpu_llm/runtime/batching.py``): the batch
is a set of SLOTS; each step runs ONE batched decode for all slots at
their own positions (a (B,) offset vector), and the host admits and
retires requests between steps.

Admission runs a DEDICATED PREFILL: the slot's cache rows are zeroed and
the whole prompt (padded to a power-of-two bucket) goes through one
forward into the slot's rows, ``cache[:, slot:slot+1]`` (contiguous
views of the per-layer (B, S, Hkv*D) planes, written in place). Its last
position's logits give the request's first token.

The decode loop is pipelined one step deep: step i+1 is dispatched from
the device-side sampled tokens before step i's tokens are read on the
host. On the card the read is a non-blocking copy into pinned memory
with an event, so waiting for step i does not wait for step i+1, and the
per-step host inputs (offsets, table cells) go up the same way.
Bookkeeping lags one step: a slot whose request just finished decodes
one garbage token into its own rows, which the next admission's prefill
overwrites. Dead slots decode garbage at offset 0 of their own rows.

Sampling is per slot: temperature 0 -> argmax, else one uniform draw a
step from the slot's ``torch.Generator`` seeded by ``Request.seed``, so a
sampled request gives the stream of the single-stream ``Engine`` with
that seed. Penalties, ``logit_bias``, top-k/top-p/min-p and logprobs are
not in this slice: a request asking for them is refused at ``submit``
(ROADMAP.md queue 1).

SPECULATION (``speculative_k`` > 0, positional state only): a step whose
live slots include a greedy one, and where every slot has room for k+1
rows, drafts up to k tokens a greedy slot (prompt lookup over the host
context, or ``draft``: a same-vocabulary (params, adapter) whose own dense
cache mirrors the slots and greedy-decodes k tokens for every slot a
step), verifies every window in ONE (B, k+1) forward, and emits each
greedy slot's accepted prefix plus one token: exactly the plain greedy
stream. A sampled slot accepts no drafts and emits the token sampled at
window position 0 with one draw from its generator, as a plain step
would. The verify reads its tokens on the host at once (drafting needs
the context), so a spec step is not pipelined; ``stats`` counts verify
forwards (one a live slot) and the tokens they emitted.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from tpu_llm_torch.ops.kv_cache import QuantKV
from tpu_llm_torch.ops.sampling import greedy, select_token, select_tokens
from tpu_llm_torch.runtime.engine import ModelAdapter, _lookup_draft, _next_bucket

# the ROADMAP.md item that holds what a request may not ask for here
_LATER = "ROADMAP.md queue 1: batch-engine sampling controls"


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    stream: Optional[Callable[[int], None]] = None
    stop_at_eos: bool = False
    top_k: int = 0               # 0 = no top-k filter
    top_p: float = 1.0           # 1.0 = no nucleus filter
    min_p: float = 0.0           # 0 = off
    logprobs: bool = False
    top_logprobs: int = 0
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logit_bias: Optional[dict] = None
    # extra end-of-generation ids beyond the model EOS, checked when
    # stop_at_eos is set
    stop_token_ids: Optional[List[int]] = None
    # filled by the engine:
    rid: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated only
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    top_ids: List[List[int]] = dataclasses.field(default_factory=list)
    top_lps: List[List[float]] = dataclasses.field(default_factory=list)
    done: bool = False


def _unsupported(req: Request) -> List[str]:
    """The fields of ``req`` that ask for what this slice does not do."""
    asks = {
        "top_k/top_p/min_p": req.top_k > 0 or req.top_p < 1.0 or req.min_p > 0.0,
        "logprobs": req.logprobs or req.top_logprobs > 0,
        "penalties": (req.frequency_penalty != 0.0 or req.presence_penalty != 0.0
                      or req.repetition_penalty != 1.0),
        "logit_bias": bool(req.logit_bias),
    }
    return [k for k, v in asks.items() if v]


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                          # next cache write position
    generator: Optional[torch.Generator] = None

    @property
    def free(self) -> bool:
        return self.req is None


def to_device(values, dtype, device: torch.device) -> torch.Tensor:
    """A small host array as a tensor on ``device``; on the card through
    pinned memory and a non-blocking copy, so it does not wait for the
    work already queued."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _start_fetch(t: torch.Tensor):
    """Begin copying ``t`` to the host: (host tensor, event or None)."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _finish_fetch(fetch) -> list:
    host, ev = fetch
    if ev is not None:
        ev.synchronize()
    return host.tolist()


def _map_state(state, fn):
    """Apply ``fn`` to every tensor leaf of a dict / list / QuantKV state
    (a QuantKV's planes and scales share the batch axis 0)."""
    if isinstance(state, dict):
        return {k: _map_state(v, fn) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_map_state(v, fn) for v in state]
    if isinstance(state, QuantKV):
        return QuantKV(fn(state.q), fn(state.s))
    return None if state is None else fn(state)


def _first_leaf(state) -> torch.Tensor:
    leaves = []
    _map_state(state, leaves.append)
    return leaves[0]


class BatchEngine:
    def __init__(self, params, adapter: ModelAdapter, batch: int = 8,
                 max_seq: int = 1024, eos_id: int = 2, speculative_k: int = 0,
                 draft=None):
        self.params = params
        self.adapter = adapter
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.bos_id = adapter.bos_id
        self._baxis = adapter.state_batch_axis
        self.state = adapter.init_state(batch, max_seq)
        self.device = _first_leaf(self.state).device
        self._next_rid = 0
        # recurrent state cannot roll back a rejected draft: no speculation
        self._init_spec(speculative_k if adapter.positional_state else 0, draft,
                        adapter.vocab_size)
        self._reset_common()

    def _init_spec(self, speculative_k: int, draft, vocab_size: int) -> None:
        """Speculation settings: k, and the draft (params, adapter), kept
        only with k > 0, whose dense state ``_reset_common`` makes."""
        self.spec_k = speculative_k
        self._draft = None
        if draft is not None and speculative_k:
            if draft[1].vocab_size != vocab_size:
                raise ValueError("draft model must share the target vocabulary")
            self._draft = draft
        self.stats = {"spec_forwards": 0, "spec_tokens": 0}

    # -- device work ------------------------------------------------------

    def _prefill(self, idx: int, toks: torch.Tensor, last_idx: int,
                 temperature: float, generator) -> torch.Tensor:
        """Zero slot ``idx``'s rows and run the prompt (1, Tpad) into them
        at offset 0. Returns the first token, (1,) on the device."""
        sub = _map_state(self.state, lambda a: a.narrow(self._baxis, idx, 1).zero_())
        hidden, _ = self.adapter.apply(self.params, toks, sub, 0)
        logits = self.adapter.lm_head(self.params, hidden[:, last_idx:last_idx + 1])
        return select_token(logits[:, 0, :], temperature, generator)

    def _decode(self, offsets: torch.Tensor, temps, generators) -> torch.Tensor:
        """One batched decode step from the device-side tokens."""
        hidden, self.state = self.adapter.apply(
            self.params, self._token_dev[:, None], self.state, offsets)
        logits = self.adapter.lm_head(self.params, hidden)[:, 0, :]
        return select_tokens(logits, temps, generators)

    def _verify_logits(self, tokens: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """(B, k+1, V) logits of the windows ``tokens`` at per-slot offsets."""
        hidden, self.state = self.adapter.apply(self.params, tokens, self.state, offsets)
        return self.adapter.lm_head(self.params, hidden)

    def _verify(self, tokens: torch.Tensor, offsets: torch.Tensor, temps, generators):
        """Speculative verify of the (B, k+1) windows ``tokens`` at per-slot
        offsets: the greedy next token after every window position (B, k+1),
        and a token sampled at position 0 for the slots with a temperature
        (which accept no drafts: their stream is the plain sampled one)."""
        logits = self._verify_logits(tokens, offsets)
        return greedy(logits), select_tokens(logits[:, 0], temps, generators)

    def _draft_scan(self, tokens: torch.Tensor, offsets: torch.Tensor, k: int) -> torch.Tensor:
        """Greedy-decode ``k`` tokens for every slot at its own offset on the
        draft model (two-model speculation): (k, B) on the device."""
        dparams, dadapter = self._draft
        toks = []
        for _ in range(k):
            hidden, self._draft_state = dadapter.apply(
                dparams, tokens[:, None], self._draft_state, offsets)
            tokens = greedy(dadapter.lm_head(dparams, hidden)[:, 0, :])
            toks.append(tokens)
            offsets = offsets + 1
        return torch.stack(toks)

    def _draft_prefill(self, idx: int, toks: torch.Tensor) -> None:
        """Zero slot ``idx``'s rows of the draft state and run the prompt
        (1, Tpad) into them at offset 0 (the prefill without its sampling)."""
        dparams, dadapter = self._draft
        ax = dadapter.state_batch_axis
        sub = _map_state(self._draft_state, lambda a: a.narrow(ax, idx, 1).zero_())
        dadapter.apply(dparams, toks, sub, 0)

    # -- public API -------------------------------------------------------

    def _reset_common(self):
        self.slots = [_Slot() for _ in range(self.batch)]
        self._queue: List[Request] = []
        self._token_dev = torch.zeros((self.batch,), dtype=torch.int32,
                                      device=self.device)
        self._inflight = None       # ((host tokens, event), [(slot_idx, req)])
        if self._draft is not None:
            self._draft_state = self._draft[1].init_state(self.batch, self.max_seq)

    def reset(self) -> None:
        """Reinitialize all decode state (crash recovery): live slots and
        the queue are dropped; the caller fails their requests."""
        self._reset_common()
        self.state = self.adapter.init_state(self.batch, self.max_seq)

    def submit(self, req: Request) -> Request:
        req.rid = self._next_rid
        self._next_rid += 1
        if not req.prompt:
            raise ValueError("empty prompt")
        asks = _unsupported(req)
        if asks:
            raise NotImplementedError(
                f"request asks for {', '.join(asks)}: not in this slice of "
                f"tpu_llm_torch ({_LATER})")
        n_bos = 1 if self.bos_id >= 0 else 0
        if len(req.prompt) + n_bos + req.max_new > self.max_seq:
            raise ValueError("prompt (+BOS) + max_new exceeds max_seq")
        self._queue.append(req)
        return req

    @property
    def n_active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    def _new_generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _seat(self, idx: int, slot: _Slot, first: torch.Tensor, n_in: int) -> None:
        """Record the prefill's first token (one host read a request) and
        put it in the slot's lane of the device-side tokens."""
        slot.pos = n_in
        self._token_dev[idx] = first[0]
        self._record(slot, int(first[0]))

    def _admit(self):
        for idx, slot in enumerate(self.slots):
            if slot.free and self._queue:
                req = self._queue.pop(0)
                slot.req = req
                slot.generator = self._new_generator(req.seed)
                bos = [self.bos_id] if self.bos_id >= 0 else []
                input_ids = bos + req.prompt
                n_in = len(input_ids)
                toks = np.zeros((1, min(_next_bucket(n_in), self.max_seq)), np.int64)
                toks[0, :n_in] = input_ids
                toks = to_device(toks, torch.long, self.device)
                first = self._prefill(idx, toks, n_in - 1, req.temperature,
                                      slot.generator)
                if self._draft is not None:
                    self._draft_prefill(idx, toks)
                self._seat(idx, slot, first, n_in)

    def _record(self, slot: _Slot, tok: int):
        """Append a fetched token to the slot's request; retire on EOS or
        a stop id (with stop_at_eos), the budget, or the context's end."""
        req = slot.req
        if req is None or req.done:
            return
        req.tokens.append(tok)
        if req.stream:
            req.stream(tok)
        ends = len(req.tokens) >= req.max_new or (
            req.stop_at_eos and (tok == self.eos_id
                                 or (req.stop_token_ids is not None
                                     and tok in req.stop_token_ids)))
        if ends or slot.pos >= self.max_seq:
            req.done = True
            slot.req = None

    def cancel(self, req: Request) -> bool:
        """Retire ``req`` now (client disconnect, stop string). Safe between
        steps: in-flight bookkeeping skips retired slots. Returns True if
        it was live or queued."""
        if req.done:
            return False
        for slot in self.slots:
            if slot.req is req:
                req.done = True
                slot.req = None
                return True
        if req in self._queue:
            self._queue.remove(req)
            req.done = True
            return True
        return False

    _POP = object()        # sentinel: collect whatever is in flight

    def _collect(self, inflight=_POP):
        """Read a dispatched step's tokens and update the bookkeeping (one
        step behind the device)."""
        if inflight is BatchEngine._POP:
            inflight, self._inflight = self._inflight, None
        if inflight is None:
            return
        fetch, metas = inflight
        fetched = _finish_fetch(fetch)
        for idx, req in metas:
            slot = self.slots[idx]
            if slot.req is not req or req.done:
                continue            # retired or reused after the dispatch
            self._record(slot, int(fetched[idx]))

    def _pre_dispatch(self, live) -> None:
        """Hook between admission and dispatch (PagedEngine maps blocks
        here)."""

    def _step_spec(self, live) -> int:
        """One speculative iteration: drafts for every greedy slot, ONE
        (B, k+1) verify forward, the accepted prefix + 1 token emitted a
        greedy slot and the position-0 sample a sampled one; then the
        device token vector gets each slot's last token, for a later plain
        (pipelined) step to feed from."""
        k = self.spec_k
        B = self.batch
        toks = np.zeros((B, k + 1), np.int64)
        offsets = np.zeros((B,), np.int32)
        temps = [0.0] * B
        gens: List[Optional[torch.Generator]] = [None] * B
        bos = [self.bos_id] if self.bos_id >= 0 else []
        ctxs = {i: bos + req.prompt + req.tokens for i, req in live}
        model_drafts = None
        if self._draft is not None:
            # one batched draft run for every slot at its own offset
            feed = np.zeros((B,), np.int64)
            for i, ctx in ctxs.items():
                feed[i] = ctx[-1]
                offsets[i] = self.slots[i].pos
            model_drafts = self._draft_scan(
                to_device(feed, torch.long, self.device),
                to_device(offsets, torch.int32, self.device), k).tolist()    # (k, B)
        drafts_by_slot = {}
        for i, req in live:
            ctx = ctxs[i]
            if req.temperature != 0:
                drafts = []
            elif model_drafts is not None:
                drafts = [row[i] for row in model_drafts]
            else:
                drafts = _lookup_draft(ctx, k)
            drafts_by_slot[i] = drafts
            toks[i, 0] = ctx[-1]
            toks[i, 1:1 + len(drafts)] = drafts
            offsets[i] = self.slots[i].pos
            temps[i] = req.temperature
            gens[i] = self.slots[i].generator
        chain, sampled0 = self._verify(to_device(toks, torch.long, self.device),
                                       to_device(offsets, torch.int32, self.device),
                                       temps, gens)
        # one host read for both
        fetched = torch.cat([chain, sampled0[:, None]], dim=1).tolist()
        chain, sampled0 = [r[:k + 1] for r in fetched], [r[k + 1] for r in fetched]
        lanes, vals = [], []
        for i, req in live:
            slot = self.slots[i]
            drafts = drafts_by_slot[i]
            if req.temperature > 0:
                new = [sampled0[i]]
            else:
                acc = 0
                while acc < len(drafts) and drafts[acc] == chain[i][acc]:
                    acc += 1
                new = drafts[:acc] + [chain[i][acc]]
            slot.pos += len(new)
            self.stats["spec_forwards"] += 1
            self.stats["spec_tokens"] += len(new)
            for t in new:
                self._record(slot, int(t))
                if slot.req is not req or req.done:
                    break
            lanes.append(i)
            vals.append(new[-1])
        self._token_dev[to_device(lanes, torch.long, self.device)] = \
            to_device(vals, torch.int32, self.device)
        return len(live)

    @torch.no_grad()
    def step(self) -> int:
        """Admit (prefill), dispatch one batched decode, then read the
        PREVIOUS step's tokens. Returns the number of live slots. With
        speculation, a step that can verify drafts runs ``_step_spec``."""
        self._admit()
        if self.spec_k:
            # read the pipelined step BEFORE taking the live slots: its
            # bookkeeping may retire one, and the spec step drafts from
            # (and indexes by) the state after it
            self._collect()
        live = [(i, s.req) for i, s in enumerate(self.slots) if not s.free]
        self._pre_dispatch(live)
        if not live:
            self._collect()
            return 0
        # only a greedy slot can accept drafts, and a window must fit the
        # cache (near its end, the plain step); penalties and logit_bias,
        # which would keep a batch on the plain step, are refused at submit
        if self.spec_k and any(r.temperature == 0 for _, r in live) and all(
                self.slots[i].pos + self.spec_k + 1 <= self.max_seq for i, _ in live):
            return self._step_spec(live)
        offsets = np.zeros((self.batch,), np.int32)
        temps = [0.0] * self.batch
        gens: List[Optional[torch.Generator]] = [None] * self.batch
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            offsets[i] = min(slot.pos, self.max_seq - 1)
            temps[i] = slot.req.temperature
            gens[i] = slot.generator
            slot.pos += 1
        self._token_dev = self._decode(to_device(offsets, torch.int32, self.device),
                                       temps, gens)
        prev = self._inflight
        self._inflight = (_start_fetch(self._token_dev), live)
        self._collect(prev)
        return len(live)

    def run(self) -> int:
        """Drive until every submitted request completes. Returns the
        number of engine steps taken."""
        steps = 0
        while self._queue or self.n_active:
            self.step()
            steps += 1
        self._collect()
        return steps
