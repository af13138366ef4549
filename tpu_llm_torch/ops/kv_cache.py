"""int8 KV quantization (``tpu_llm/ops/kv_cache.py``).

One f32 scale per (token, kv head) vector: absmax / 127, values rounded
half to even (``torch.round``, as ``jnp.round``) and clipped to +-127; an
all-zero vector gets scale 0 and values 0. Attention never dequantizes:
the K scale multiplies the score matrix and the V scale the softmax
weights (``ops/attention.py``'s int8 paths).

``QuantKV`` pairs an int8 plane with its scales. The dense int8 cache
(``models/llama.init_cache(dtype="int8")``, ``--cache-dtype int8``
without ``--paged``) is a list of per-layer FLAT pairs: ``q`` (B, S,
Hkv*D) int8 with kv-head-major scales ``s`` (B, Hkv, S), written by
``ops/attention.update_kv_cache``; the paged pools gather to the same
form.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class QuantKV:
    """int8 plane ``q`` with f32 scales ``s``: (..., S, Hkv, D) with
    (..., S, Hkv), or flat (B, S, Hkv*D) with (B, Hkv, S)."""

    q: torch.Tensor
    s: torch.Tensor


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) f32/bf16 -> (int8 values, f32 scale over the last axis)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    inv = torch.where(s > 0, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(kv: QuantKV, dtype=torch.float32, head_dim=None) -> torch.Tensor:
    """The float cache: 4D -> (B, S, Hkv, D); flat (q (B, S, Hkv*D), s
    (B, Hkv, S)) -> the same 4D shape (``head_dim`` required)."""
    if kv.q.dim() == kv.s.dim():       # flat layout
        if head_dim is None:
            raise ValueError("flat QuantKV needs head_dim to dequantize")
        *lead, S, hkvd = kv.q.shape
        q4 = kv.q.reshape(*lead, S, hkvd // head_dim, head_dim).float()
        return (q4 * kv.s.transpose(-1, -2)[..., None]).to(dtype)
    return (kv.q.float() * kv.s[..., None]).to(dtype)


def gather_scale_pool(scale_pool: torch.Tensor, table: torch.Tensor, n_blocks: int,
                      n_kv_heads: int, block_size: int) -> torch.Tensor:
    """A paged 2-D scale pool (n_blocks*HP, SP) through a (B, MB) block
    table -> the flat form's kv-head-major (B, Hkv, MB*BS) scales."""
    B, mb = table.shape
    s = scale_pool.reshape(n_blocks, -1, scale_pool.shape[-1])[table.long()]
    s = s[..., :n_kv_heads, :block_size]                     # (B, MB, Hkv, BS)
    return s.permute(0, 2, 1, 3).reshape(B, n_kv_heads, mb * block_size)
