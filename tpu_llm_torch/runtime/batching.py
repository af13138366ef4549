"""Continuous batching engine (``tpu_llm/runtime/batching.py``): the batch
is a set of SLOTS; each step runs ONE batched decode for all slots at
their own positions (a (B,) offset vector), and the host admits and
retires requests between steps.

Admission runs a DEDICATED PREFILL: the slot's cache rows are zeroed and
the whole prompt (padded to a power-of-two bucket) goes through one
forward into the slot's rows, ``cache[:, slot:slot+1]`` (contiguous
views of the per-layer (B, S, Hkv*D) planes, written in place), with
``length`` the prompt's real length. Its last position's logits give the
request's first token. A recurrent state (Mamba's per-layer conv and SSM
rows, ``ModelAdapter.mamba``) takes the same route: zeroed on admission,
so a reused slot starts clean, and stopped at ``length``.

The decode loop is pipelined one step deep: step i+1 is dispatched from
the device-side sampled tokens before step i's tokens are read on the
host. On the card the read is a non-blocking copy into pinned memory
with an event, so waiting for step i does not wait for step i+1, and the
per-step host inputs (offsets, table cells) go up the same way.
Bookkeeping lags one step: a slot whose request just finished decodes
one garbage token into its own rows, which the next admission's prefill
overwrites. Dead slots decode garbage at offset 0 of their own rows.

Sampling is per slot: temperature 0 -> argmax, else one uniform draw a
sampled token from the slot's ``torch.Generator`` seeded by
``Request.seed``, so a sampled request gives the stream of the
single-stream ``Engine`` with that seed. A request may also ask for
top-k / top-p / min-p, OpenAI's frequency and presence penalties, the HF
repetition penalty, a ``logit_bias`` and (top) logprobs, as in the JAX
package. The plain step pays for none of them while no live request asks:
the filters' sort runs only in a step where some live request filters
(``filtered_sample``, one (B, V) sort for the batch); the penalty counts
(B, V) int32 live on the device only while some live request penalises,
rebuilt from the host context on admission and bumped by a scatter-add
after each sample; the bias rows (B, V) only while some live request
biases; logprobs are taken from the raw logits (no penalty, bias,
temperature or filter) and read in the same asynchronous fetch as the
tokens, so the step stays pipelined one deep.

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
from tpu_llm_torch.ops.sampling import filtered_sample, greedy, select_tokens
from tpu_llm_torch.runtime import trace
from tpu_llm_torch.runtime.engine import ModelAdapter, _lookup_draft, _next_bucket


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
    submitted: Optional[float] = None      # submit()'s clock, only while tracing
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated only
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    top_ids: List[List[int]] = dataclasses.field(default_factory=list)
    top_lps: List[List[float]] = dataclasses.field(default_factory=list)
    done: bool = False


def _bias_row(req: Request, vocab: int) -> np.ndarray:
    """Dense f32 bias row from the sparse OpenAI ``logit_bias`` mapping
    (int or str token ids; values clamped to +/-100)."""
    row = np.zeros((vocab,), np.float32)
    for k, v in (req.logit_bias or {}).items():
        t = int(k)
        if 0 <= t < vocab:
            row[t] = float(np.clip(float(v), -100.0, 100.0))
    return row


def _penalized(req: Request) -> bool:
    return (req.frequency_penalty != 0.0 or req.presence_penalty != 0.0
            or req.repetition_penalty != 1.0)


def _filtered(req: Request) -> bool:
    return req.top_k > 0 or req.top_p < 1.0 or req.min_p > 0.0


def _wants_lp(req: Request) -> bool:
    return req.logprobs or req.top_logprobs > 0


def _apply_penalties(logits, counts, fps, pps, rps):
    """Penalty-adjusted logits for sampling (reported logprobs stay raw).
    logits (..., V); counts (..., V) token counts over the text so far;
    fps / pps / rps (...) knobs: seen tokens' positive logits are divided
    by the repetition penalty and negative ones multiplied, then
    frequency * count and presence * seen are subtracted."""
    c = counts.float()
    seen = c > 0
    x = logits.float()
    rp = torch.where(seen, rps[..., None], 1.0)
    x = torch.where(x > 0, x / rp, x * rp)
    return x - fps[..., None] * c - pps[..., None] * seen


def _prefill_extras(req: Request, vocab: int, input_ids, device):
    """(counts (1, V) int32, (fp, pp, rp) (1,) knobs) of a penalised
    request's prompt (BOS + prompt: the first sampled token is penalised
    too), else (None, None); and its (1, V) bias row or None."""
    counts = knobs = bias = None
    if _penalized(req):
        counts = to_device(np.bincount(input_ids, minlength=vocab)[None], torch.int32, device)
        knobs = tuple(to_device([v], torch.float32, device) for v in (
            req.frequency_penalty, req.presence_penalty, req.repetition_penalty))
    if req.logit_bias:
        bias = to_device(_bias_row(req, vocab)[None], torch.float32, device)
    return counts, knobs, bias


def _req_filters(req: Request, device):
    """(top_k, top_p, min_p) (1,) tensors of a filtering request, else
    None: None keeps the sampler without the sort."""
    if _filtered(req):
        return (to_device([req.top_k], torch.int64, device),
                to_device([req.top_p], torch.float32, device),
                to_device([req.min_p], torch.float32, device))
    return None


def _sample_rows(logits: torch.Tensor, temps, generators, filters=None) -> torch.Tensor:
    """(B, V) logits -> (B,) int32, one uniform from a sampled row's
    generator: the cheap greedy / CDF sampler (``select_tokens``) unless
    ``filters`` (top_k, top_p, min_p (B,) tensors) is given."""
    if filters is None:
        return select_tokens(logits, temps, generators)
    dev = logits.device
    r = torch.cat([torch.rand((1, 1), generator=g, device=dev) if t > 0.0
                   else torch.zeros((1, 1), device=dev)
                   for t, g in zip(temps, generators)])
    return filtered_sample(logits, r, to_device(temps, torch.float32, dev), *filters)


def _sample_step(logits, temps, generators, filters=None, counts=None, knobs=None,
                 biases=None) -> torch.Tensor:
    """A decode step's sampling: biases, then penalties, then the
    sampler; the sampled tokens' counts are bumped on the device (a
    scatter-add, no host read)."""
    slog = logits if biases is None else logits + biases
    if counts is not None:
        slog = _apply_penalties(slog, counts, *knobs)
    sampled = _sample_rows(slog, temps, generators, filters)
    if counts is not None:
        rows = torch.arange(counts.shape[0], device=counts.device)
        counts.index_put_((rows, sampled.long()),
                          torch.ones_like(sampled, dtype=counts.dtype), accumulate=True)
    return sampled


_TOPN = 20     # top_logprobs width (the host slices per request; OpenAI's chat maximum)


def _top_rows(logits: torch.Tensor):
    """(..., V) logits -> (log-softmax values, int32 ids), each
    (..., _TOPN): the OpenAI top_logprobs report."""
    x = logits.float()
    vals, ids = torch.topk(x - torch.logsumexp(x, dim=-1, keepdim=True),
                           min(_TOPN, x.shape[-1]), dim=-1)
    return vals, ids.to(torch.int32)


def _token_logprob(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log P(tok) under the raw (untempered, unfiltered) distribution:
    what OpenAI's ``logprobs`` reports. logits (..., V), toks (...)."""
    x = logits.float()
    chosen = x.gather(-1, toks.long()[..., None])[..., 0]
    return chosen - torch.logsumexp(x, dim=-1)


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


def _start_fetch(*ts: Optional[torch.Tensor]):
    """Begin copying the tensors ``ts`` (None entries stay None) to the
    host, behind one event: (host tensors, event or None)."""
    if not any(t is not None and t.device.type == "cuda" for t in ts):
        return [None if t is None else t.clone() for t in ts], None
    hosts = []
    for t in ts:
        if t is not None:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t = host
        hosts.append(t)
    ev = torch.cuda.Event()
    ev.record()
    return hosts, ev


def _finish_fetch(fetch) -> list:
    """The fetched tensors as lists (one wait for all of them)."""
    hosts, ev = fetch
    if ev is not None:
        ev.synchronize()
    return [None if h is None else h.tolist() for h in hosts]


def _stream_drained(device: torch.device) -> Optional[bool]:
    """Whether the card has finished all the work queued on its stream so
    far (the ``dispatch`` span's ``drained``); None off the card."""
    return torch.cuda.current_stream(device).query() if device.type == "cuda" else None


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
        self._vocab = adapter.vocab_size
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

    def _prefill(self, idx: int, toks: torch.Tensor, last_idx: int) -> torch.Tensor:
        """Zero slot ``idx``'s rows and run the prompt (1, Tpad) into them
        at offset 0. Returns the last prompt position's logits (1, V) (under
        data parallelism: computed by the rank that holds the slot's rows,
        and shared)."""
        ad = self.adapter
        row = idx if ad.local_row is None else ad.local_row(idx, self.batch)
        if row is None:
            logits = torch.zeros((1, self._vocab), dtype=torch.float32, device=self.device)
        else:
            sub = _map_state(self.state, lambda a: a.narrow(self._baxis, row, 1).zero_())
            hidden, _ = ad.apply(self.params, toks, sub, 0, length=last_idx + 1)
            logits = ad.lm_head(self.params, hidden[:, last_idx:last_idx + 1])[:, 0, :]
        return logits if ad.share_row is None else ad.share_row(logits, idx, self.batch)

    def _decode(self, offsets: torch.Tensor) -> torch.Tensor:
        """One batched decode step from the device-side tokens: (B, V)
        logits."""
        hidden, self.state = self.adapter.apply(
            self.params, self._token_dev[:, None], self.state, offsets)
        return self.adapter.lm_head(self.params, hidden)[:, 0, :]

    def _verify_logits(self, tokens: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """(B, k+1, V) logits of the windows ``tokens`` at per-slot offsets."""
        hidden, self.state = self.adapter.apply(self.params, tokens, self.state, offsets)
        return self.adapter.lm_head(self.params, hidden)

    def _verify(self, tokens: torch.Tensor, offsets: torch.Tensor, temps, generators,
                filters=None):
        """Speculative verify of the (B, k+1) windows ``tokens`` at per-slot
        offsets: the window's logits, the greedy next token after every
        window position (B, k+1), and a token sampled at position 0 for the
        slots with a temperature (which accept no drafts: their stream is
        the plain sampled one)."""
        logits = self._verify_logits(tokens, offsets)
        return logits, greedy(logits), _sample_rows(logits[:, 0], temps, generators, filters)

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

    def _draft_prefill(self, idx: int, toks: torch.Tensor, last_idx: int) -> None:
        """Zero slot ``idx``'s rows of the draft state and run the prompt
        (1, Tpad) into them at offset 0 (the prefill without its sampling)."""
        dparams, dadapter = self._draft
        ax = dadapter.state_batch_axis
        row = idx if dadapter.local_row is None else dadapter.local_row(idx, self.batch)
        if row is None:
            return
        sub = _map_state(self._draft_state, lambda a: a.narrow(ax, row, 1).zero_())
        dadapter.apply(dparams, toks, sub, 0, length=last_idx + 1)

    # -- public API -------------------------------------------------------

    def _reset_common(self):
        self.slots = [_Slot() for _ in range(self.batch)]
        self._queue: List[Request] = []
        self._token_dev = torch.zeros((self.batch,), dtype=torch.int32,
                                      device=self.device)
        # ((host tokens, logprobs, top values, top ids), event), [(slot_idx, req)]
        self._inflight = None
        # penalty counts (B, V) int32 and their (fps, pps, rps) (B,) knobs,
        # on the device while a live request penalises; bias rows (B, V)
        # f32 while one biases. Both rebuilt from the host on admission.
        self._counts = self._knobs = None
        self._counts_dirty = False
        self._bias = None
        self._bias_dirty = False
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
        if (_penalized(req) or req.logit_bias) and self._vocab <= 0:
            raise ValueError("penalties/logit_bias need the vocabulary size for the "
                             "count/bias buffers")
        n_bos = 1 if self.bos_id >= 0 else 0
        if len(req.prompt) + n_bos + req.max_new > self.max_seq:
            raise ValueError("prompt (+BOS) + max_new exceeds max_seq")
        req.submitted = trace.now()
        self._queue.append(req)
        return req

    @property
    def n_active(self) -> int:
        return sum(0 if s.free else 1 for s in self.slots)

    def _new_generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return g

    def _seat(self, idx: int, slot: _Slot, logits: torch.Tensor, input_ids) -> None:
        """Sample the request's first token from the prefill's last logits
        (1, V), with its filters, penalties over the prompt and bias; read
        it (and its logprobs) on the host at once (one read a request) and
        put it in the slot's lane of the device-side tokens."""
        req = slot.req
        if _penalized(req) or self._counts is not None:
            self._counts_dirty = True
        if req.logit_bias or self._bias is not None:
            self._bias_dirty = True
        counts, knobs, bias = _prefill_extras(req, self._vocab, input_ids, self.device)
        first = _sample_step(logits, [req.temperature], [slot.generator],
                             _req_filters(req, self.device), counts, knobs, bias)
        lp = _token_logprob(logits, first) if _wants_lp(req) else None
        top = _top_rows(logits) if req.top_logprobs > 0 else (None, None)
        tok, lps, vals, ids = _finish_fetch(_start_fetch(first, lp, *top))
        slot.pos = len(input_ids)
        self._token_dev[idx] = first[0]
        self._record(slot, tok[0], None if lps is None else lps[0],
                     None if ids is None else (ids[0], vals[0]))

    def _admit(self):
        for idx, slot in enumerate(self.slots):
            if slot.free and self._queue:
                req = self._queue.pop(0)
                with trace.span("prefill", req.rid) as sp:
                    trace.add("queued", req.submitted, sp.t0, req.rid)
                    slot.req = req
                    slot.generator = self._new_generator(req.seed)
                    bos = [self.bos_id] if self.bos_id >= 0 else []
                    input_ids = bos + req.prompt
                    n_in = len(input_ids)
                    toks = np.zeros((1, min(_next_bucket(n_in), self.max_seq)), np.int64)
                    toks[0, :n_in] = input_ids
                    toks = to_device(toks, torch.long, self.device)
                    logits = self._prefill(idx, toks, n_in - 1)
                    if self._draft is not None:
                        self._draft_prefill(idx, toks, n_in - 1)
                    self._seat(idx, slot, logits, input_ids)

    def _record(self, slot: _Slot, tok: int, lp: Optional[float] = None, top=None):
        """Append a fetched token to the slot's request (with its logprob,
        and ``top``: the (ids, logprobs) of the _TOPN alternatives, when
        the request asks); retire on EOS or a stop id (with stop_at_eos),
        the budget, or the context's end."""
        req = slot.req
        if req is None or req.done:
            return
        req.tokens.append(tok)
        if _wants_lp(req) and lp is not None:
            req.token_logprobs.append(lp)
        if req.top_logprobs > 0 and top is not None:
            n = min(req.top_logprobs, len(top[0]))
            req.top_ids.append([int(t) for t in top[0][:n]])
            req.top_lps.append([float(x) for x in top[1][:n]])
        if req.stream:
            req.stream(tok)
        ends = len(req.tokens) >= req.max_new or (
            req.stop_at_eos and (tok == self.eos_id
                                 or (req.stop_token_ids is not None
                                     and tok in req.stop_token_ids)))
        if ends or slot.pos >= self.max_seq:
            req.done = True
            slot.req = None

    def _filter_vecs(self, live):
        """(top_k, top_p, min_p) (B,) tensors, or None while no live request
        filters (the sampler without the sort)."""
        if not any(_filtered(r) for _, r in live):
            return None
        topks = np.zeros((self.batch,), np.int64)
        topps = np.ones((self.batch,), np.float32)
        minps = np.zeros((self.batch,), np.float32)
        for i, r in live:
            topks[i], topps[i], minps[i] = r.top_k, r.top_p, r.min_p
        return (to_device(topks, torch.int64, self.device),
                to_device(topps, torch.float32, self.device),
                to_device(minps, torch.float32, self.device))

    def _penalty_args(self, live):
        """(counts, knobs) for the step, both None while no live request
        penalises. The counts are rebuilt from the host context after an
        admission and kept by the steps' scatter-adds in between."""
        if not any(_penalized(r) for _, r in live):
            self._counts = self._knobs = None
            return None, None
        if self._counts is None or self._counts_dirty:
            # read the pipelined step first: its token is not in
            # req.tokens yet and the rebuild would miss it
            self._collect()
            rows = np.zeros((self.batch, self._vocab), np.int32)
            knobs = np.zeros((3, self.batch), np.float32)
            knobs[2] = 1.0
            bos = [self.bos_id] if self.bos_id >= 0 else []
            for i, r in live:
                rows[i] = np.bincount(bos + r.prompt + r.tokens, minlength=self._vocab)
                knobs[:, i] = (r.frequency_penalty, r.presence_penalty,
                               r.repetition_penalty)
            self._counts = to_device(rows, torch.int32, self.device)
            self._knobs = tuple(to_device(k, torch.float32, self.device) for k in knobs)
            self._counts_dirty = False
        return self._counts, self._knobs

    def _want_top(self, live) -> bool:
        return any(r.top_logprobs > 0 for _, r in live)

    def _bias_args(self, live):
        """The (B, V) bias rows, None while no live request biases; static
        a request, rebuilt on the host after an admission."""
        if not any(r.logit_bias for _, r in live):
            self._bias = None
            return None
        if self._bias is None or self._bias_dirty:
            rows = np.zeros((self.batch, self._vocab), np.float32)
            for i, r in live:
                if r.logit_bias:
                    rows[i] = _bias_row(r, self._vocab)
            self._bias = to_device(rows, torch.float32, self.device)
            self._bias_dirty = False
        return self._bias

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
        """Read a dispatched step's tokens (and logprobs) and update the
        bookkeeping (one step behind the device)."""
        if inflight is BatchEngine._POP:
            inflight, self._inflight = self._inflight, None
        if inflight is None:
            return
        fetch, metas = inflight
        with trace.span("fetch_wait"):
            toks, lps, vals, ids = _finish_fetch(fetch)
        for idx, req in metas:
            slot = self.slots[idx]
            if slot.req is not req or req.done:
                continue            # retired or reused after the dispatch
            self._record(slot, int(toks[idx]), None if lps is None else lps[idx],
                         None if ids is None else (ids[idx], vals[idx]))

    def _pre_dispatch(self, live) -> None:
        """Hook between admission and dispatch (PagedEngine maps blocks
        here)."""

    def _step_spec(self, live) -> int:
        """One speculative iteration: drafts for every greedy slot, ONE
        (B, k+1) verify forward, the accepted prefix + 1 token emitted a
        greedy slot and the position-0 sample a sampled one, with the
        chain's logprobs; then the device token vector gets each slot's
        last token, for a later plain (pipelined) step to feed from."""
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
        with trace.span("dispatch"):
            logits, chain, sampled0 = self._verify(
                to_device(toks, torch.long, self.device),
                to_device(offsets, torch.int32, self.device), temps, gens,
                self._filter_vecs(live))
            lps = s0lp = None
            if any(_wants_lp(r) for _, r in live):
                lps = _token_logprob(logits, chain)
                s0lp = _token_logprob(logits[:, 0], sampled0)
            top = _top_rows(logits) if self._want_top(live) else (None, None)
        # one host read for all of them
        chain, sampled0, lps, s0lp, vals, ids = _finish_fetch(
            _start_fetch(chain, sampled0, lps, s0lp, *top))
        lanes, vals_last = [], []
        for i, req in live:
            slot = self.slots[i]
            drafts = drafts_by_slot[i]
            if req.temperature > 0:
                new = [sampled0[i]]
                new_lp = [None if s0lp is None else s0lp[i]]
            else:
                acc = 0
                while acc < len(drafts) and drafts[acc] == chain[i][acc]:
                    acc += 1
                # the emitted tokens are chain[:acc + 1]: their logprobs
                # are the chain's
                new = drafts[:acc] + [chain[i][acc]]
                new_lp = [None] * (acc + 1) if lps is None else lps[i][:acc + 1]
            slot.pos += len(new)
            self.stats["spec_forwards"] += 1
            self.stats["spec_tokens"] += len(new)
            for j, (t, lp) in enumerate(zip(new, new_lp)):
                # window position j's logits gave emitted token j
                self._record(slot, int(t), lp,
                             None if ids is None else (ids[i][j], vals[i][j]))
                if slot.req is not req or req.done:
                    break
            lanes.append(i)
            vals_last.append(new[-1])
        self._token_dev[to_device(lanes, torch.long, self.device)] = \
            to_device(vals_last, torch.int32, self.device)
        return len(live)

    @torch.inference_mode()
    def step(self) -> int:
        """Admit (prefill), dispatch one batched decode, then read the
        PREVIOUS step's tokens. Returns the number of live slots. With
        speculation, a step that can verify drafts runs ``_step_spec``."""
        with trace.span("step"):
            return self._step()

    def _step(self) -> int:
        queued = len(self._queue)
        self._admit()
        # a prefill's first-token read, or the read of the pipelined step,
        # drains the stream before the dispatch: ``drained`` is left out
        synced = len(self._queue) < queued or self.spec_k
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
        # cache (near its end, the plain step); penalised and biased slots
        # keep the batch on the plain step too (the verify's greedy chain
        # would need counts that evolve along the window)
        if self.spec_k and any(r.temperature == 0 for _, r in live) and not any(
                _penalized(r) or r.logit_bias for _, r in live) and all(
                self.slots[i].pos + self.spec_k + 1 <= self.max_seq for i, _ in live):
            return self._step_spec(live)
        with trace.span("dispatch") as sp:
            if trace.enabled() and not synced:
                sp.note("drained", _stream_drained(self.device))
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
            filters = self._filter_vecs(live)
            counts, knobs = self._penalty_args(live)
            biases = self._bias_args(live)
            logits = self._decode(to_device(offsets, torch.int32, self.device))
            self._token_dev = _sample_step(logits, temps, gens, filters, counts, knobs,
                                           biases)
            lp = (_token_logprob(logits, self._token_dev)
                  if any(_wants_lp(r) for _, r in live) else None)
            top = _top_rows(logits) if self._want_top(live) else (None, None)
            prev = self._inflight
            self._inflight = (_start_fetch(self._token_dev, lp, *top), live)
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
