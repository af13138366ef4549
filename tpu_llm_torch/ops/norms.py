"""RMSNorm: ``x * w / sqrt(mean(x*x) + eps)`` — eps is added to the MEAN
SQUARE inside the sqrt (the Fortran reference's form). Computed in f32
whatever the storage dtype, then cast back (``tpu_llm/ops/norms.py``)."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps)
    if w is not None:
        out = out * w.float()
    return out.to(x.dtype)
