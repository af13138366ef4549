"""Token sampling (``tpu_llm/ops/sampling.py``): greedy argmax at
temperature 0, else softmax(logits / T) and an inverse-CDF draw — the
Fortran reference's two modes. The uniform draw comes from a
``torch.Generator``, so a sampled stream differs from the JAX package's
(whose bits come from a JAX PRNG key); ``cdf_sample`` takes the draw as an
argument so both packages can be held to the same one.

``filtered_sample`` is the per-request sampler of the engines: top-k,
min-p and top-p over rows whose knobs may all differ, then the
inverse-CDF draw from a uniform the caller passes (one a sampled row), in
the JAX package's filter order and tie rules. ``sample_token`` is the
JAX package's framework call with static knobs; ``masked_softmax`` the
reference's softmax over the first ``n`` entries.

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


def masked_softmax(x: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax over the first ``n`` entries of the last axis (f32), zeros
    elsewhere: the reference's ``softmax(x, s)``."""
    p = torch.softmax(x[..., :n].float(), dim=-1)
    return torch.nn.functional.pad(p, (0, x.shape[-1] - n))


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


def _column(v, dtype, device) -> torch.Tensor:
    """A knob (a number, or a (B,) tensor) as a (B, 1) or (1, 1) column."""
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(-1, 1)


def filtered_probs(logits: torch.Tensor, temperature, top_k, top_p,
                   min_p=None) -> torch.Tensor:
    """The distribution ``filtered_sample`` draws from: (B, V) logits and
    per-row knobs (numbers, or (B,) tensors) -> (B, V) f32 probabilities,
    zero outside the kept set. ``top_k`` 0, ``top_p`` >= 1 and ``min_p`` 0
    are identity filters.

    The JAX package's order and ties: top-k masks logits below the k-th
    largest (ties with it survive); min-p drops tokens whose probability
    under the softmax of the top-k-masked, UN-tempered logits is below
    min_p times the largest; top-p keeps the tokens of the tempered
    distribution whose exclusive cumulative sum (largest first) is below
    top_p, and renormalises (top_p >= 1 keeps all). Every mask and the tempered probabilities
    are monotone in the logits, so one descending sort of the logits
    orders all of them."""
    x = logits.float()
    B, V = x.shape
    dev = x.device
    t = _column(temperature, torch.float32, dev)
    k = _column(top_k, torch.int64, dev).clamp(0, V)
    sx, order = torch.sort(x, dim=-1, descending=True)
    kth = sx.gather(-1, (k.clamp(min=1) - 1).expand(B, 1))
    x0 = torch.where((k > 0) & (x < kth), float("-inf"), x)
    if min_p is not None:
        praw = torch.softmax(x0, dim=-1)
        floor = praw.amax(dim=-1, keepdim=True) * _column(min_p, torch.float32, dev)
        x0 = torch.where(praw < floor, float("-inf"), x0)
    probs = torch.softmax(x0 / t.clamp(min=1e-8), dim=-1)
    sp = probs.gather(-1, order)
    csum = torch.cumsum(sp, dim=-1)
    p = _column(top_p, torch.float32, dev)
    # top_p >= 1 keeps every token: the exclusive sum of the tail can round
    # up to 1.0 in one summation order and not in another
    keep = (csum - sp < p) | (p >= 1.0)
    cutoff = torch.where(keep, sp, float("inf")).amin(dim=-1, keepdim=True)
    probs = torch.where(probs < cutoff, 0.0, probs)
    return probs / probs.sum(dim=-1, keepdim=True)


def filtered_sample(logits: torch.Tensor, r: torch.Tensor, temperature, top_k, top_p,
                    min_p=None) -> torch.Tensor:
    """Greedy / top-k / min-p / top-p / inverse-CDF sampling of (B, V)
    logits with per-row knobs (``filtered_probs``): (B,) int32. ``r``
    (B, 1) holds each row's uniform; a row at temperature 0 takes the
    argmax of ``logits``."""
    probs = filtered_probs(logits, temperature, top_k, top_p, min_p)
    t = _column(temperature, torch.float32, logits.device)[:, 0].expand(logits.shape[0])
    return torch.where(t > 0, cdf_sample(probs, r), greedy(logits))


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 r: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(..., V) logits -> (...) int32 with static knobs: greedy at
    temperature 0, else softmax(logits / T) with an optional top-k and
    top-p filter and an inverse-CDF draw of ``r`` (drawn from
    ``generator`` when not given)."""
    if temperature == 0.0:
        return greedy(logits)
    x = logits.float() / temperature
    if top_k is not None and top_k > 0:
        kth = torch.topk(x, top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, float("-inf"), x)
    probs = torch.softmax(x, dim=-1)
    if top_p is not None and 0.0 < top_p < 1.0:
        sp = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(sp, dim=-1)
        cutoff = torch.where(csum - sp < top_p, sp, float("inf")).amin(dim=-1, keepdim=True)
        probs = torch.where(probs < cutoff, 0.0, probs)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    if r is None:
        r = torch.rand(probs.shape[:-1] + (1,), generator=generator, device=probs.device,
                       dtype=probs.dtype)
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
