"""Token sampling (``tpu_llm/ops/sampling.py``): greedy argmax at
temperature 0, else softmax(logits / T) and an inverse-CDF draw — the
Fortran reference's two modes. The uniform draw comes from a
``torch.Generator``, so a sampled stream differs from the JAX package's
(whose bits come from a JAX PRNG key); ``cdf_sample`` takes the draw as an
argument so both packages can be held to the same one. Top-k / top-p /
min-p are not in this slice.

``select_tokens`` picks one token a batch row with the row's own
temperature and generator: greedy rows by argmax, each sampled row by
``select_token`` on its own (1, V) logits with one uniform draw from its
generator, so a slot's stream equals the single-stream engine's with the
same seed."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab (first max wins, like Fortran ``maxloc``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def cdf_sample(probs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """First index whose CDF exceeds the uniform ``r`` (probs.shape[:-1] +
    (1,)); the last index when none does."""
    cdf = torch.cumsum(probs, dim=-1)
    idx = torch.sum((cdf <= r).to(torch.int32), dim=-1)
    return torch.clamp(idx, max=probs.shape[-1] - 1).to(torch.int32)


def select_token(logits: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids."""
    if temperature <= 0.0:
        return greedy(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    r = torch.rand(probs.shape[:-1] + (1,), generator=generator,
                   device=probs.device, dtype=probs.dtype)
    return cdf_sample(probs, r)


def select_tokens(logits: torch.Tensor, temperatures: Sequence[float],
                  generators: Sequence[Optional[torch.Generator]]) -> torch.Tensor:
    """(B, V) logits, B temperatures and B generators -> (B,) int32."""
    out = greedy(logits)
    for i, t in enumerate(temperatures):
        if t > 0.0:
            out[i] = select_token(logits[i:i + 1], t, generators[i])[0]
    return out
