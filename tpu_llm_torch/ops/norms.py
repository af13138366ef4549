"""Norms (``tpu_llm/ops/norms.py``), computed in f32 whatever the storage
dtype, then cast back.

- RMSNorm: ``x * w / sqrt(mean(x*x) + eps)``, eps added to the MEAN
  SQUARE inside the sqrt (the Fortran reference's form).
- LayerNorm with scale and bias (phi-2's blocks)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps)
    if w is not None:
        out = out * w.float()
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)
