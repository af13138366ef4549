"""Generation engine (``tpu_llm/runtime/engine.py::Engine.generate`` on the
plain step loop).

- PREFILL: the whole prompt in one forward, padded to a power-of-two
  bucket (at least 16). Padding is safe under causal masking: a padded
  cache slot s is visible only to queries at positions >= s, and the
  decode step that first reaches position s overwrites the slot before
  attending to it.
- DECODE: one forward + classifier + sampling per token. The sampled id
  feeds the next step as a device tensor, and the host reads token i only
  after step i+1 is enqueued, so the read does not stall the card.

Sampling: temperature 0 -> argmax; else softmax(logits / T) and an
inverse-CDF draw from a ``torch.Generator`` on the engine's device seeded
by ``seed`` (a stream that differs from the JAX package's PRNG stream).
CUDA-graph decode (``--scan``), speculation, penalties and top-k/top-p/
min-p are later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from tpu_llm_torch.ops.sampling import select_token


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

    def _prefill(self, tokens: torch.Tensor, last_idx: int):
        state = self.adapter.init_state(self.batch, self.max_seq)
        hidden, state = self.adapter.apply(self.params, tokens, state, 0)
        logits = self.adapter.lm_head(self.params, hidden[:, last_idx:last_idx + 1])
        return logits[:, 0, :], state

    def _decode(self, token: torch.Tensor, state, pos: int, temperature: float,
                generator):
        hidden, state = self.adapter.apply(self.params, token[:, None], state, pos)
        logits = self.adapter.lm_head(self.params, hidden)[:, 0, :]
        return select_token(logits, temperature, generator), state

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
    ) -> GenerationResult:
        """Single-stream generation with the reference's -n semantics:
        ``n_total`` counts prompt echo + generated tokens; alternatively
        pass ``n_new``."""
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

        t0 = time.perf_counter()
        n_in = len(input_ids)
        pad_to = min(_next_bucket(n_in), self.max_seq)
        toks = np.zeros((self.batch, pad_to), np.int64)
        toks[:, :n_in] = np.asarray(input_ids, np.int64)
        logits, state = self._prefill(torch.from_numpy(toks).to(self.device), n_in - 1)

        # echo the prompt (the reference prints prompt tokens as it forces them)
        for t in prompt_ids[:n_total]:
            emitted.append(int(t))
            if stream:
                stream(int(t))

        n_gen = n_total - len(emitted)
        ttft_s = None
        if n_gen > 0:
            token = select_token(logits, temperature, generator)
            first = int(token[0])
            ttft_s = time.perf_counter() - t0
            emitted.append(first)
            if stream:
                stream(first)

        t_decode = time.perf_counter()
        pos = n_in  # next write position
        pending = None
        for _ in range(max(n_gen - 1, 0)):
            token, state = self._decode(token, state, pos, temperature, generator)
            pos += 1
            if pending is not None:
                tid = int(pending[0])
                emitted.append(tid)
                if stream:
                    stream(tid)
            pending = token
        if pending is not None:
            tid = int(pending[0])
            emitted.append(tid)
            if stream:
                stream(tid)
        _sync(self.device)
        t_end = time.perf_counter()

        decode_s = t_end - t_decode
        n_decoded = max(n_gen - 1, 0)
        return GenerationResult(
            tokens=emitted,
            n_prompt=len(prompt_ids),
            ttft_s=ttft_s if ttft_s is not None else t_end - t0,
            decode_s=decode_s,
            total_s=t_end - t0,
            tokens_per_s=(n_decoded / decode_s) if decode_s > 0 and n_decoded else 0.0,
        )
