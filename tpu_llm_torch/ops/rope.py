"""Rotary position embeddings (``tpu_llm/ops/rope.py``).

- ``"interleaved"``: GGUF "NORM" rope. Per head of size D, pair j rotates
  dims (2j, 2j+1) by angle ``pos * theta^(-2j/D)``, pos 0-based.
- ``"neox"``: half rotation. Pair j rotates dims (j, j + D/2) by the same
  angle. ``quant/convert_params.fold_rope_interleave`` turns an
  interleaved model into this form by permuting the wq/wk columns.
- ``"llmf90"``: the Fortran reference's loop — pair j uses exponent
  (2j+1)/D and position pos+1; interleaved pairing.

All math in float32, on the positions' device with no host read, so a
decode step whose positions are a device tensor can be captured in a CUDA
graph. Context-extension scaling (linear, YaRN) and partial rope are not
in this slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                variant: str = "interleaved") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for ``positions`` (int tensor (...,)), each shaped
    positions.shape + (head_dim//2,), float32, on positions' device."""
    if head_dim % 2:
        raise ValueError("rotated dim count must be even")
    j = torch.arange(head_dim // 2, dtype=torch.float32, device=positions.device)
    pos = positions.float()
    if variant == "llmf90":
        exponent = (2.0 * j + 1.0) / head_dim
        pos = pos + 1.0
    else:
        exponent = (2.0 * j) / head_dim
    # the base is filled on the device (no host copy): a CUDA graph captures it
    base = torch.full((), theta, dtype=torch.float32, device=j.device)
    freq = torch.pow(base, -exponent)
    ang = pos[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           variant: str) -> torch.Tensor:
    """Rotate x (..., T, H, D) by cos/sin (..., T, D//2); result in x's dtype."""
    cos = cos.unsqueeze(-2)     # broadcast over heads
    sin = sin.unsqueeze(-2)
    xf = x.float()
    D = x.shape[-1]
    if variant == "neox":
        x0, x1 = xf[..., : D // 2], xf[..., D // 2 :]
        out = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:  # interleaved / llmf90
        xp = xf.reshape(*xf.shape[:-1], D // 2, 2)
        x0, x1 = xp[..., 0], xp[..., 1]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                          dim=-1).reshape(xf.shape)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               variant: str = "interleaved") -> torch.Tensor:
    cos, sin = rope_angles(positions, x.shape[-1], theta, variant)
    return rotate(x, cos, sin, variant)
