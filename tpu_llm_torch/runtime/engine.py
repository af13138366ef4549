"""Generation engine (``tpu_llm/runtime/engine.py::Engine.generate``).

- PREFILL: the whole prompt in one forward, padded to a power-of-two
  bucket (at least 16). Padding is safe under causal masking: a padded
  cache slot s is visible only to queries at positions >= s, and the
  decode step that first reaches position s overwrites the slot before
  attending to it.
- DECODE, the step loop: one forward + classifier + sampling per token.
  The sampled id feeds the next step as a device tensor, and the host
  reads token i only after step i+1 is enqueued, so the read does not
  stall the card.
- DECODE, ``use_scan=True`` (``llm --scan``; the JAX package's
  ``lax.scan`` loop): the q4 family is converted once per engine to
  int4-plane weights (``unpack_params_int4``, f32 scales), and one decode
  step over static buffers (token, position, step index, seed, the token
  buffer and the KV cache) is captured in a CUDA graph and replayed once a
  token (runtime/graphs.py). The host fetches the tokens once at the end:
  no streaming, as in the JAX package. On the CPU the same step runs
  eagerly.
- SPECULATION (``speculative_k`` > 0, greedy, positional state only):
  each iteration verifies k drafted tokens in one forward over a k+1
  window and emits the accepted prefix plus one token: exactly the plain
  greedy stream. Drafts come from prompt lookup (``_lookup_draft``) or
  from a ``draft`` engine that greedy-decodes k tokens. With ``use_scan``
  (prompt lookup, batch 1) the draft/verify/accept iteration runs on the
  device as a captured graph (``_spec_graph``): the host replays it and
  reads one pair (tokens out, position) a forward, the loop's condition;
  ``stats["spec_host_syncs"]`` counts those reads. The routing is the JAX
  package's (``use_scan`` with ``draft`` runs the plain graph loop).

Sampling: temperature 0 -> argmax; else softmax(logits / T) and an
inverse-CDF draw: in the step loop from a ``torch.Generator`` on the
engine's device seeded by ``seed`` (a stream that differs from the JAX
package's PRNG stream), in the graph loop from a counter-based uniform
(``ops/sampling.select_token_counter``), deterministic for a seed.
Penalties and top-k/top-p/min-p are later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tpu_llm_torch.ops.sampling import greedy, select_token, select_token_counter


@dataclasses.dataclass
class ModelAdapter:
    """Uniform model interface for the engine.

    apply(params, tokens (B, T), state, offset) -> (hidden (B, T, E), state);
      offset an int or a (B,) tensor of per-row positions
    lm_head(params, hidden (B, T, E)) -> logits (B, T, V) float32
    init_state(batch, max_seq) -> state
    """

    apply: Callable
    lm_head: Callable
    init_state: Callable
    bos_id: int = 1
    # batch axis of every state leaf (per-layer (B, S, Hkv*D) planes: 0)
    state_batch_axis: int = 0
    # True when state rows are keyed by position (a KV cache): rows past
    # the current position are causally invisible, so a speculative verify
    # may write ahead and accept a prefix. False for recurrent state.
    positional_state: bool = True
    vocab_size: int = 0

    @classmethod
    def llama(cls, cfg, cache_dtype=torch.float32, bos_id: int = 1,
              device="cuda") -> "ModelAdapter":
        from tpu_llm_torch.models import llama as M

        if cache_dtype in ("int8", torch.int8):
            raise NotImplementedError(
                "a dense int8 KV cache is not in this slice of tpu_llm_torch "
                "(ROADMAP.md queue 1: the dense int8 QuantKV cache); int8 pools "
                "serve through the paged engine")
        return cls(
            apply=lambda params, tokens, state, offset: M.forward(
                params, cfg, tokens, state, offset),
            lm_head=lambda params, hidden: M.lm_head(params, cfg, hidden),
            init_state=lambda batch, max_seq: M.init_cache(
                cfg, batch, max_seq, cache_dtype, device),
            bos_id=bos_id,
            vocab_size=cfg.vocab_size,
        )


def _next_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]              # all emitted tokens (prompt echo + generated)
    n_prompt: int
    ttft_s: float                  # time to first sampled token (prefill + 1 step)
    decode_s: float                # wall time of the pure decode phase
    total_s: float
    tokens_per_s: float            # decode-phase throughput
    phase_times: Optional[dict] = None


def _lookup_draft(ctx: List[int], k: int, ngram: int = 2) -> List[int]:
    """Prompt-lookup drafting: the k tokens that followed the most recent
    prior occurrence of the context's trailing ``ngram``."""
    if k <= 0 or len(ctx) < ngram + 1:
        return []
    tail = ctx[-ngram:]
    for j in range(len(ctx) - ngram - 1, -1, -1):
        if ctx[j:j + ngram] == tail:
            return ctx[j + ngram:j + ngram + k]
    return []


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    def __init__(self, params, adapter: ModelAdapter, batch: int = 1,
                 max_seq: int = 2048, device="cuda"):
        self.params = params
        self.adapter = adapter
        self.batch = batch
        self.max_seq = max_seq
        self.device = torch.device(device)
        # device-spec observability (tokens per verify forward, host reads)
        self.stats = {"spec_forwards": 0, "spec_tokens": 0, "spec_host_syncs": 0}
        # the graph loops' int4-plane weights, KV cache and captured steps
        self._int4_params = None
        self._graph_state = None
        self._graphs: Dict[tuple, dict] = {}

    def _prefill(self, tokens: torch.Tensor, last_idx: int, state=None):
        if state is None:
            state = self.adapter.init_state(self.batch, self.max_seq)
        hidden, state = self.adapter.apply(self.params, tokens, state, 0)
        logits = self.adapter.lm_head(self.params, hidden[:, last_idx:last_idx + 1])
        return logits[:, 0, :], state

    def _decode(self, token: torch.Tensor, state, pos: int, temperature: float,
                generator):
        hidden, state = self.adapter.apply(self.params, token[:, None], state, pos)
        logits = self.adapter.lm_head(self.params, hidden)[:, 0, :]
        return select_token(logits, temperature, generator), state

    def _verify(self, tokens: torch.Tensor, state, pos: int):
        """Teacher-force ``tokens`` (B, k+1) at positions [pos, pos+k]: the
        greedy next token after each, one forward. Cache rows written past
        the accepted prefix are stale but causally invisible, and the next
        verify overwrites them before they can be attended."""
        hidden, state = self.adapter.apply(self.params, tokens, state, pos)
        return greedy(self.adapter.lm_head(self.params, hidden)), state

    def _draft_steps(self, token: int, state, pos: int, n: int) -> List[int]:
        """Greedy-decode ``n`` tokens from ``token`` at ``pos`` (the draft
        side of two-model speculation), fetched once at the end."""
        tok = torch.full((self.batch,), token, dtype=torch.int32, device=self.device)
        toks = []
        for i in range(n):
            tok, state = self._decode(tok, state, pos + i, 0.0, None)
            toks.append(tok[0])
        return [int(t) for t in torch.stack(toks).tolist()]

    # -- the graph loops ---------------------------------------------------

    def _graph_params(self):
        if self._int4_params is None:
            from tpu_llm_torch.quant.convert_params import unpack_params_int4

            self._int4_params = unpack_params_int4(self.params)
        return self._int4_params

    def _static_state(self):
        """The KV cache the captured steps read and write: one per engine, so
        a captured graph serves every later ``generate``."""
        if self._graph_state is None:
            self._graph_state = self.adapter.init_state(self.batch, self.max_seq)
        return self._graph_state

    def _int_buffer(self, n: int, dtype=torch.int64) -> torch.Tensor:
        return torch.zeros(n, dtype=dtype, device=self.device)

    def _decode_graph(self, temperature: float) -> dict:
        """Static buffers and the step over them: the token fed (B,), the
        next position, the step index into ``out`` (max_seq, B) and the
        sampling seed; ``step`` decodes one token and advances them."""
        key = ("decode", float(temperature))
        if key in self._graphs:
            return self._graphs[key]
        params, state, B = self._graph_params(), self._static_state(), self.batch
        g = {"tok": self._int_buffer(B, torch.int32), "pos": self._int_buffer(1, torch.int32),
             "i": self._int_buffer(1), "seed": self._int_buffer(1),
             "out": self._int_buffer((self.max_seq, B), torch.int32)}

        def step():
            hidden, _ = self.adapter.apply(params, g["tok"][:, None], state, g["pos"])
            logits = self.adapter.lm_head(params, hidden)[:, 0, :]
            nxt = select_token_counter(logits, temperature, g["seed"], g["pos"])
            g["out"].index_copy_(0, g["i"], nxt[None, :])
            g["tok"].copy_(nxt)
            g["pos"].add_(1)
            g["i"].add_(1)

        g["step"] = step
        g["captured"] = None
        self._graphs[key] = g
        return g

    def _run_decode_graph(self, first: int, pos: int, steps: int, temperature: float,
                          seed: int) -> List[List[int]]:
        """``steps`` tokens after ``first`` at ``pos``: (steps, B) ids."""
        from tpu_llm_torch.runtime.graphs import CapturedStep

        g = self._decode_graph(temperature)
        g["tok"].fill_(first)
        g["pos"].fill_(pos)
        g["i"].zero_()
        g["seed"].fill_(seed)
        done = 0
        if g["captured"] is None:
            # the warm-up before the capture is the first real step
            g["captured"] = CapturedStep(g["step"], self.device, warmup=1)
            done = 1
        for _ in range(steps - done):
            g["captured"]()
        return g["out"][:steps].tolist()

    def _spec_graph(self, k: int) -> dict:
        """DEVICE-side prompt-lookup speculation, one verify forward a
        replay (the JAX package's ``_spec_scan_impl`` loop body). ``ctx``
        (max_seq + k + 1,) holds the prompt and the emitted tokens, ``n_ctx``
        its fill, ``pos`` the next cache row (n_ctx - 1), ``out`` the
        emitted tokens, ``n_out`` their count, ``n_fwd`` the forwards. The
        most recent prior occurrence of the trailing 2-gram is a masked max
        over one compare of the whole buffer, preferring one with a full
        k-token continuation; [last, d1..dk] is teacher-forced at
        [pos, pos+k] and the accepted prefix + 1 is written to ``ctx`` and
        ``out``."""
        key = ("spec", k)
        if key in self._graphs:
            return self._graphs[key]
        params, state = self._graph_params(), self._static_state()
        S = self.max_seq + k + 1
        dev = self.device
        g = {"ctx": self._int_buffer(S, torch.int32), "n_ctx": self._int_buffer(1),
             "pos": self._int_buffer(1, torch.int32), "out": self._int_buffer(S, torch.int32),
             "n_out": self._int_buffer(1), "n_fwd": self._int_buffer(1)}
        idx = torch.arange(S - 1, device=dev)
        ks = torch.arange(k, device=dev)
        ks1 = torch.arange(k + 1, device=dev)

        def step():
            ctx, n_ctx = g["ctx"], g["n_ctx"]
            t_last = ctx.index_select(0, n_ctx - 1)
            t_prev = ctx.index_select(0, n_ctx - 2)
            match = (ctx[:-1] == t_prev) & (ctx[1:] == t_last) & (idx <= n_ctx - 3)
            full = match & (idx <= n_ctx - 2 - k)
            jfull = torch.where(full, idx, -1).max()
            jany = torch.where(match, idx, -1).max()
            jstar = torch.where(jfull >= 0, jfull, jany)
            start = (jstar.clamp(min=0) + 2).clamp(max=S - k)   # dynamic_slice's clamp
            drafts = ctx.index_select(0, start + ks)
            d_len = torch.where(jstar >= 0, (n_ctx - (jstar + 2)).clamp(0, k), 0)
            window = torch.cat([t_last, drafts])[None, :]
            hidden, _ = self.adapter.apply(params, window, state, g["pos"])
            chain = greedy(self.adapter.lm_head(params, hidden))[0]
            ok = ((drafts == chain[:k]) & (ks < d_len)).long()
            step_n = torch.cumprod(ok, 0).sum() + 1
            g["out"].index_copy_(0, g["n_out"] + ks1, chain)
            ctx.index_copy_(0, n_ctx + ks1, chain)
            n_ctx.add_(step_n)
            g["pos"].add_(step_n)
            g["n_out"].add_(step_n)
            g["n_fwd"].add_(1)

        g["step"] = step
        g["captured"] = None
        self._graphs[key] = g
        return g

    def _run_spec_graph(self, ctx_ids: List[int], pos: int, steps: int, k: int):
        """(emitted tokens, forwards, next position) of the device-spec
        loop: replay while fewer than ``steps`` tokens are out and the next
        window fits the cache, reading (n_out, pos) once a forward."""
        from tpu_llm_torch.runtime.graphs import CapturedStep

        g = self._spec_graph(k)
        g["ctx"].zero_()
        g["ctx"][:len(ctx_ids)] = torch.tensor(ctx_ids, dtype=torch.int32).to(self.device)
        g["n_ctx"].fill_(len(ctx_ids))
        g["pos"].fill_(pos)
        for name in ("n_out", "n_fwd"):
            g[name].zero_()
        n_out = 0
        while n_out < steps and pos + k + 1 <= self.max_seq:
            if g["captured"] is None:
                g["captured"] = CapturedStep(g["step"], self.device, warmup=1)
            else:
                g["captured"]()
            n_out, pos = (int(v) for v in torch.cat([g["n_out"], g["pos"].long()]).tolist())
            self.stats["spec_host_syncs"] += 1
        n_emit = min(n_out, steps)
        return g["out"][:n_emit].tolist(), int(g["n_fwd"].item()), pos

    # -- public API --------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt_ids: Sequence[int],
        n_total: Optional[int] = None,
        n_new: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        stream: Optional[Callable[[int], None]] = None,
        add_bos: bool = True,
        use_scan: bool = False,
        speculative_k: int = 0,
        draft: Optional["Engine"] = None,
    ) -> GenerationResult:
        """Single-stream generation with the reference's -n semantics:
        ``n_total`` counts prompt echo + generated tokens; alternatively
        pass ``n_new``. ``use_scan``, ``speculative_k`` and ``draft`` as in
        the module docstring; every speculative mode emits exactly the
        plain greedy stream. ``use_scan`` on a card that cannot capture the
        step raises."""
        prompt_ids = list(prompt_ids)
        if n_total is None:
            n_total = len(prompt_ids) + (n_new if n_new is not None else 128)
        n_total = min(n_total, self.max_seq - 1)

        bos = [self.adapter.bos_id] if add_bos and self.adapter.bos_id >= 0 else []
        if not bos and not prompt_ids:
            raise ValueError("empty prompt with no BOS")
        input_ids = bos + prompt_ids
        if len(input_ids) >= self.max_seq:
            raise ValueError(
                f"prompt ({len(input_ids)} tokens incl. BOS) does not fit "
                f"max_seq={self.max_seq}; raise --max-seq or shorten the prompt")
        emitted: List[int] = []
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        positional = self.adapter.positional_state
        # the JAX package's routing: device speculation is prompt lookup,
        # greedy, batch 1, on the graph loop; host speculation any other
        # greedy spec without use_scan
        use_device_spec = (speculative_k > 0 and temperature == 0 and use_scan
                           and draft is None and self.batch == 1 and positional)
        use_spec = speculative_k > 0 and temperature == 0 and not use_scan and positional
        graph_state = self._static_state() if use_scan else None

        t0 = time.perf_counter()
        n_in = len(input_ids)
        pad_to = min(_next_bucket(n_in), self.max_seq)
        toks = np.zeros((self.batch, pad_to), np.int64)
        toks[:, :n_in] = np.asarray(input_ids, np.int64)
        toks_dev = torch.from_numpy(toks).to(self.device)
        logits, state = self._prefill(toks_dev, n_in - 1, graph_state)

        def emit(t: int):
            emitted.append(t)
            if stream:
                stream(t)

        # echo the prompt (the reference prints prompt tokens as it forces them)
        for t in prompt_ids[:n_total]:
            emit(int(t))

        n_gen = n_total - len(emitted)
        ttft_s = None
        if n_gen > 0:
            token = select_token(logits, temperature, generator)
            first = int(token[0])
            ttft_s = time.perf_counter() - t0
            emit(first)

        t_decode = time.perf_counter()
        pos = n_in  # next write position
        steps = max(n_gen - 1, 0)
        if steps and use_device_spec:
            k = speculative_k
            out, n_fwd, pos = self._run_spec_graph(input_ids + [emitted[-1]], pos, steps, k)
            for t in out:
                emit(int(t))
            self.stats["spec_forwards"] += n_fwd
            self.stats["spec_tokens"] += len(out)
            # context-window tail (pos + k + 1 would write past the cache):
            # plain single-token steps with the loaded weights
            self._plain_tail(emitted, emit, state, pos, steps - len(out), generator)
        elif steps and use_spec:
            self._host_spec(toks_dev, input_ids, emitted, emit, state, pos, steps,
                            speculative_k, draft, generator)
        elif steps and use_scan:
            out = self._run_decode_graph(emitted[-1], pos, steps, temperature, seed)
            for row in out:
                emit(int(row[0]))
        elif steps:
            pending = None
            for _ in range(steps):
                token, state = self._decode(token, state, pos, temperature, generator)
                pos += 1
                if pending is not None:
                    emit(int(pending[0]))
                pending = token
            emit(int(pending[0]))
        _sync(self.device)
        t_end = time.perf_counter()

        decode_s = t_end - t_decode
        return GenerationResult(
            tokens=emitted,
            n_prompt=len(prompt_ids),
            ttft_s=ttft_s if ttft_s is not None else t_end - t0,
            decode_s=decode_s,
            total_s=t_end - t0,
            tokens_per_s=(steps / decode_s) if decode_s > 0 and steps else 0.0,
        )

    def _plain_tail(self, emitted, emit, state, pos: int, n: int, generator):
        """``n`` greedy single-token steps after the last emitted token."""
        token = torch.full((self.batch,), emitted[-1], dtype=torch.int32, device=self.device)
        for _ in range(n):
            token, state = self._decode(token, state, pos, 0.0, generator)
            pos += 1
            emit(int(token[0]))

    def _host_spec(self, toks_dev, input_ids, emitted, emit, state, pos: int,
                   remaining: int, k: int, draft: Optional["Engine"], generator):
        """Host-driven speculation: drafts from prompt lookup or from
        ``draft``, one ``_verify`` forward over [last, d1..dk] an
        iteration, the accepted prefix + 1 emitted; plain steps near the
        end of the context window."""
        ctx = list(input_ids) + [emitted[-1]]

        def take(t: int):
            ctx.append(t)
            emit(t)

        draft_state, draft_pos = None, 0
        if draft is not None:
            if draft.adapter.vocab_size != self.adapter.vocab_size:
                raise ValueError("draft model must share the target vocabulary")
            # the draft processes the same prompt once
            _, draft_state = draft._prefill(toks_dev.to(draft.device), len(input_ids) - 1)
            draft_pos = len(input_ids)
        while remaining > 0 and pos + k + 1 <= self.max_seq and (
                draft is None or draft_pos + k <= draft.max_seq):
            if draft is not None:
                drafts = draft._draft_steps(ctx[-1], draft_state, draft_pos, k)
            else:
                drafts = _lookup_draft(ctx, k)
            inp = np.zeros((self.batch, k + 1), np.int64)
            inp[:, 0] = ctx[-1]
            inp[:, 1:1 + len(drafts)] = np.asarray(drafts, np.int64)
            outs_dev, state = self._verify(torch.from_numpy(inp).to(self.device), state, pos)
            outs = outs_dev[0].tolist()
            acc = 0
            while acc < len(drafts) and acc < remaining - 1 and drafts[acc] == outs[acc]:
                acc += 1
            for t in drafts[:acc] + [outs[acc]]:
                take(int(t))
            pos += acc + 1
            remaining -= acc + 1
            # draft rows [draft_pos, draft_pos + acc] hold the accepted
            # prefix; later rows are stale but invisible
            draft_pos += acc + 1
        self._plain_tail(emitted, emit, state, pos, remaining, generator)
