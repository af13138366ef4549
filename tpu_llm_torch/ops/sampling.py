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
same seed.

``select_token_counter`` is the sampling step of the CUDA-graph decode
(``Engine.generate(use_scan=True)``): its uniform is a hash of a seed and
a counter that live on the device (splitmix64 in int64 tensor ops), so a
captured step draws a fresh number each replay, deterministic for a seed
on any device and any PyTorch version. Its stream differs from the
generator's, as the JAX package's scan stream differs from its step
loop's."""

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


# splitmix64 constants as signed int64 (tensor arithmetic wraps mod 2^64)
_GOLDEN = -7046029254386353131       # 0x9e3779b97f4a7c15
_MIX1 = -4658895280553007687         # 0xbf58476d1ce4e5b9
_MIX2 = -7723592293110705685         # 0x94d049bb133111eb


def _shr(z: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (z >> n) & ((1 << (64 - n)) - 1)


def counter_uniform(seed: torch.Tensor, counter: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, 1) float32 uniforms in [0, 1) from int64 ``seed`` and
    ``counter`` tensors (one element each), row r from stream element
    seed * golden + counter * rows + r through the splitmix64 finalizer;
    24 bits a draw. No host read and no generator state: a CUDA graph
    captures it."""
    z = (seed.long() * _GOLDEN + counter.long() * rows
         + torch.arange(rows, device=counter.device)).reshape(rows, 1)
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    z = z ^ _shr(z, 31)
    return _shr(z, 40).float() * (1.0 / (1 << 24))


def select_token_counter(logits: torch.Tensor, temperature: float, seed: torch.Tensor,
                         counter: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 token ids; a temperature > 0 draws from
    ``counter_uniform(seed, counter)``."""
    if temperature <= 0.0:
        return greedy(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return cdf_sample(probs, counter_uniform(seed, counter, probs.shape[0]))
