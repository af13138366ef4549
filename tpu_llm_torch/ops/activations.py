"""Activations (``tpu_llm/ops/activations.py``): SiLU written as the
reference writes it, ``x * sigmoid(x)``."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
