"""Model configuration (a copy of ``tpu_llm/config.py``'s llama part).

Every model constant — including the ones the Fortran reference buries as
literals (rope theta 10000, rms eps 1e-5) — is an explicit field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# RoPE variants (see ops/rope.py):
#   "interleaved" — llama2.c / GGUF "NORM" rope: pairs (2i, 2i+1).
#   "neox"        — half-rotation: pairs (i, i + d/2).
#   "llmf90"      — the Fortran reference's loop: 1-based positions and odd
#                   frequency exponents; kept for parity runs.
ROPE_VARIANTS = ("interleaved", "neox", "llmf90")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-family transformer config (TinyLlama, Llama-2, ...).

    Mirrors the GGUF hparams: llama.block_count / embedding_length /
    attention.head_count / attention.head_count_kv / context_length /
    feed_forward_length."""

    dim: int = 2048                 # llama.embedding_length
    hidden_dim: int = 5632          # llama.feed_forward_length
    n_layers: int = 22              # llama.block_count
    n_heads: int = 32               # llama.attention.head_count
    n_kv_heads: int = 4             # llama.attention.head_count_kv
    vocab_size: int = 32000
    seq_len: int = 2048             # llama.context_length (max context)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5          # eps INSIDE the sqrt
    rope_variant: str = "interleaved"
    tie_embeddings: bool = False    # classifier shares the embedding table

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} not divisible by n_heads {self.n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {self.n_kv_heads}"
            )
        if self.rope_variant not in ROPE_VARIANTS:
            raise ValueError(f"unknown rope_variant {self.rope_variant!r}")


def tinyllama_1_1b() -> LlamaConfig:
    """TinyLlama-1.1B: dim 2048, ffn 5632, 22 layers, 32/4 heads, vocab 32000."""
    return LlamaConfig()
