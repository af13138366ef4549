"""Rotary position embeddings (``tpu_llm/ops/rope.py``).

- ``"interleaved"``: GGUF "NORM" rope. Per head of size D, pair j rotates
  dims (2j, 2j+1) by angle ``pos * theta^(-2j/D)``, pos 0-based.
- ``"neox"``: half rotation. Pair j rotates dims (j, j + rot/2) by
  ``pos * theta^(-2j/rot)``, rot = ``rope_dims`` (partial RoPE, phi-2) or
  D; the dims past rot pass through. ``quant/convert_params.
  fold_rope_interleave`` turns an interleaved model into this form by
  permuting the wq/wk columns.
- ``"llmf90"``: the Fortran reference's loop — pair j uses exponent
  (2j+1)/D and position pos+1; interleaved pairing.

Context-extension scaling, given as (type, factor, orig_ctx):

- ``"linear"``: frequencies divided by factor.
- ``"yarn"``: ggml's rope_yarn with beta_fast 32, beta_slow 1,
  ext_factor 1: dims that turn more than 32 times inside the original
  context keep their frequency, dims that turn less than once take
  freq / factor, a linear ramp between; cos and sin are scaled by
  1 + 0.1 ln(factor).

All math in float32, on the positions' device with no host read, so a
decode step whose positions are a device tensor can be captured in a CUDA
graph with the scaled angles in it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

RopeScaling = Tuple[str, float, int]


def _yarn_corr_dim(n_rot: int, orig_ctx: int, n_rotations: float,
                   theta: float) -> float:
    # the dim whose wavelength turns ``n_rotations`` times in orig_ctx
    return (n_rot * math.log(orig_ctx / (n_rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def _scaled_freqs(freq: torch.Tensor, j: torch.Tensor, rot: int, theta: float,
                  scaling: Optional[RopeScaling]):
    """Context scaling of the base frequencies: (freq, mscale)."""
    if scaling is None:
        return freq, 1.0
    kind, factor, orig_ctx = scaling
    if kind == "linear":
        return freq / factor, 1.0
    if kind == "yarn":
        low = max(math.floor(_yarn_corr_dim(rot, orig_ctx, 32.0, theta)), 0)
        high = min(math.ceil(_yarn_corr_dim(rot, orig_ctx, 1.0, theta)), rot - 1)
        # the extrapolation weight: 1 for the fast dims (kept), 0 for the
        # slow ones (interpolated to freq / factor)
        ramp = 1.0 - torch.clamp((j - low) / max(0.001, high - low), 0.0, 1.0)
        freq = (freq / factor) * (1.0 - ramp) + freq * ramp
        return freq, 1.0 + 0.1 * math.log(factor)
    raise ValueError(f"unknown rope scaling kind {kind!r}")


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                variant: str = "interleaved", rope_dims: Optional[int] = None,
                scaling: Optional[RopeScaling] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (int tensor (...,)), each shaped
    positions.shape + (rot//2,), float32, on positions' device."""
    rot = rope_dims if rope_dims is not None else head_dim
    if rot % 2:
        raise ValueError("rotated dim count must be even")
    j = torch.arange(rot // 2, dtype=torch.float32, device=positions.device)
    pos = positions.float()
    if variant == "llmf90":
        exponent = (2.0 * j + 1.0) / head_dim
        pos = pos + 1.0
    else:
        exponent = (2.0 * j) / rot
    # the base is filled on the device (no host copy): a CUDA graph captures it
    base = torch.full((), theta, dtype=torch.float32, device=j.device)
    freq, mscale = _scaled_freqs(torch.pow(base, -exponent), j, rot, theta, scaling)
    ang = pos[..., None] * freq
    if mscale != 1.0:
        return torch.cos(ang) * mscale, torch.sin(ang) * mscale
    return torch.cos(ang), torch.sin(ang)


def rope_table(max_pos: int, head_dim: int, theta: float = 10000.0,
               variant: str = "interleaved", rope_dims: Optional[int] = None,
               scaling: Optional[RopeScaling] = None, device="cpu"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for positions 0..max_pos-1, each (max_pos, rot//2)."""
    positions = torch.arange(max_pos, dtype=torch.int32, device=device)
    return rope_angles(positions, head_dim, theta, variant, rope_dims, scaling)


def apply_rope_table(x: torch.Tensor, table: Tuple[torch.Tensor, torch.Tensor],
                     positions: torch.Tensor, variant: str = "interleaved",
                     rope_dims: Optional[int] = None) -> torch.Tensor:
    """apply_rope with a precomputed table: the rows of (cos, sin) at
    ``positions`` (the table rows are rope_angles outputs, so the result is
    bit-identical)."""
    cos_t, sin_t = table
    idx = positions.long()
    return rotate(x, cos_t[idx], sin_t[idx], variant, rope_dims)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           variant: str, rope_dims: Optional[int] = None) -> torch.Tensor:
    """Rotate the first ``rope_dims`` (default all) dims of x (..., T, H, D)
    by cos/sin (..., T, rot//2); result in x's dtype."""
    cos = cos.unsqueeze(-2)     # broadcast over heads
    sin = sin.unsqueeze(-2)
    xf = x.float()
    D = x.shape[-1]
    rot = rope_dims if rope_dims is not None else D
    xr = xf[..., :rot]
    if variant == "neox":
        x0, x1 = xr[..., : rot // 2], xr[..., rot // 2:]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:  # interleaved / llmf90
        xp = xr.reshape(*xr.shape[:-1], rot // 2, 2)
        x0, x1 = xp[..., 0], xp[..., 1]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                          dim=-1).reshape(xr.shape)
    if rot < D:
        out = torch.cat([out, xf[..., rot:]], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               variant: str = "interleaved", rope_dims: Optional[int] = None,
               scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    cos, sin = rope_angles(positions, x.shape[-1], theta, variant, rope_dims, scaling)
    return rotate(x, cos, sin, variant, rope_dims)
