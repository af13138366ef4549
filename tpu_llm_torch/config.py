"""Model configuration (a copy of ``tpu_llm/config.py``: the llama family
— llama, qwen2, gemma, phi-2 and Mixtral-style MoE — and Mamba).

Every model constant — including the ones the Fortran reference buries as
literals (rope theta 10000, rms eps 1e-5) — is an explicit field.
"""

from __future__ import annotations

import dataclasses
import math
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
    # partial RoPE (phi-2): the number of head dims rotated; None = all
    rope_dims: Optional[int] = None
    # phi-2's switches: attention and MLP read the same norm output,
    # LayerNorm with bias, biases on every projection
    parallel_block: bool = False
    use_layernorm: bool = False
    use_bias: bool = False
    act: str = "silu"               # "silu" (SwiGLU) or "gelu" (phi-2's MLP;
    #                                 with gated_mlp -> GeGLU, gemma)
    gated_mlp: bool = True          # gate * up, or a plain up projection
    tie_embeddings: bool = False    # classifier shares the embedding table
    # explicit per-head width (gemma); None = dim // n_heads
    head_dim_: Optional[int] = None
    emb_scale: float = 1.0          # embedding output scale (gemma: sqrt(dim))
    # RoPE context extension (GGUF <arch>.rope.scaling.type / factor /
    # original_context_length, or the legacy <arch>.rope.scale_linear)
    rope_scaling_type: str = "none"     # "none" | "linear" | "yarn"
    rope_scaling_factor: float = 1.0
    rope_orig_ctx: int = 0              # yarn's original context length
    # mixture of experts (llama.expert_count / expert_used_count; 0 =
    # dense FFN): softmax router, top-k, the k weights renormalized
    n_experts: int = 0
    n_experts_used: int = 2

    @property
    def head_dim(self) -> int:
        return self.head_dim_ if self.head_dim_ is not None else self.dim // self.n_heads

    @property
    def rope_scaling(self):
        """(type, factor, orig_ctx) for ops/rope.py, or None when unscaled."""
        if self.rope_scaling_type == "none" or self.rope_scaling_factor == 1.0:
            return None
        return (self.rope_scaling_type, self.rope_scaling_factor,
                self.rope_orig_ctx or self.seq_len)

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
        if self.head_dim_ is None and self.dim % self.n_heads:
            raise ValueError(f"dim {self.dim} not divisible by n_heads {self.n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {self.n_kv_heads}"
            )
        if self.rope_variant not in ROPE_VARIANTS:
            raise ValueError(f"unknown rope_variant {self.rope_variant!r}")
        if self.rope_scaling_type not in ("none", "linear", "yarn"):
            raise ValueError(f"unknown rope_scaling_type {self.rope_scaling_type!r}")


def tinyllama_1_1b() -> LlamaConfig:
    """TinyLlama-1.1B: dim 2048, ffn 5632, 22 layers, 32/4 heads, vocab 32000."""
    return LlamaConfig()


def llama2_7b() -> LlamaConfig:
    """Llama-2 7B: dim 4096, ffn 11008, 32 layers, 32/32 heads (head_dim
    128, one q head a kv head), vocab 32000, context 4096."""
    return LlamaConfig(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                       n_kv_heads=32, vocab_size=32000, seq_len=4096)


def phi2_2_7b() -> LlamaConfig:
    """Phi-2 2.7B: dim 2560, ffn 10240, 32 layers, 32/32 heads (head_dim
    80), vocab 51200; a parallel block with LayerNorm, biases, tanh-GELU
    MLP and neox RoPE over 32 of the 80 head dims."""
    return LlamaConfig(dim=2560, hidden_dim=10240, n_layers=32, n_heads=32,
                       n_kv_heads=32, vocab_size=51200, seq_len=2048,
                       rope_variant="neox", rope_dims=32, parallel_block=True,
                       use_layernorm=True, use_bias=True, act="gelu",
                       gated_mlp=False)


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba SSM config.

    Constants d_conv=4, expand=2, d_state=16 are the reference's hardcoded
    values (``ssm/mamba.f90:106-108``); d_inner and dt_rank are derived the
    same way (``ssm/mamba.f90:177-179``).
    """

    d_model: int = 768
    n_layers: int = 24
    vocab_size: int = 50280
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    norm_eps: float = 1e-5          # ssm/mamba.f90:493
    dt_rank: Optional[int] = None   # default ceil(d_model/16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank is not None else math.ceil(self.d_model / 16)


def mamba_130m() -> MambaConfig:
    """Mamba-130M (HF state-spaces/mamba-130m): d_model 768, 24 layers."""
    return MambaConfig(d_model=768, n_layers=24, vocab_size=50280)


def mamba_790m() -> MambaConfig:
    """Mamba-790M (HF state-spaces/mamba-790m): d_model 1536, 48 layers."""
    return MambaConfig(d_model=1536, n_layers=48, vocab_size=50280)
