"""Activations (``tpu_llm/ops/activations.py``): SiLU written as the
reference writes it, ``x * sigmoid(x)``; GELU in its tanh approximation
(phi-2's MLP, gemma's GeGLU gate)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")
