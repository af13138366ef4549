"""Activations (``tpu_llm/ops/activations.py``): SiLU written as the
reference writes it, ``x * sigmoid(x)``; GELU in its tanh approximation
(phi-2's MLP, gemma's GeGLU gate); softplus (Mamba's dt,
``ssm/mamba.f90:631``) as ``F.softplus`` with its threshold of 20: past
it the result is ``x``, which is what ``jax.nn.softplus``
(``logaddexp(x, 0)``) rounds to in f32 there."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)
