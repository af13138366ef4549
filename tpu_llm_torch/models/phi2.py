"""Phi-2 loader (``tpu_llm/models/phi2.py``).

Phi-2 runs through the llama forward (models/llama.py) with the
architecture switches: a parallel attention + MLP block sharing one
LayerNorm, biases on every projection and the classifier, a tanh-GELU
plain MLP, neox RoPE over ``rope.dimension_count`` of the head dims.

GGUF "phi2" tensors: blk.N.attn_qkv.weight / .bias (fused rows [q; k;
v]), blk.N.attn_output, blk.N.ffn_up / ffn_down, attn_norm (+ bias),
output_norm (+ bias), output (+ bias). q / k / v load dense whatever the
policy, as in the reference (f32, bf16 under "bf16"); the other
projections follow ``dtype_policy``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from tpu_llm_torch.config import LlamaConfig


def config_from_gguf(gguf) -> LlamaConfig:
    g = lambda k, d=None: gguf.hparam(f"phi2.{k}", default=d)  # noqa: E731
    n_heads = g("attention.head_count")
    head_dim = g("embedding_length") // n_heads
    return LlamaConfig(
        dim=g("embedding_length"),
        hidden_dim=g("feed_forward_length"),
        n_layers=g("block_count"),
        n_heads=n_heads,
        n_kv_heads=g("attention.head_count_kv", n_heads),
        vocab_size=len(gguf.metadata.get("tokenizer.ggml.tokens", []))
        or g("vocab_size", 51200),
        seq_len=g("context_length", 2048),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        norm_eps=float(g("attention.layer_norm_epsilon", 1e-5)),
        rope_variant="neox",
        rope_dims=int(g("rope.dimension_count", head_dim)),
        parallel_block=True,
        use_layernorm=True,
        use_bias=True,
        act="gelu",
        gated_mlp=False,
    )


def load_gguf(path_or_gguf, dtype_policy: str = "f32",
              device="cpu") -> Tuple[Dict, LlamaConfig]:
    """Phi-2 weights on ``device``, per-layer, q|k|v and their biases
    concatenated (convert_params.fuse_llama_layers)."""
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models.llama import _load_weight
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    gguf = path_or_gguf if not isinstance(path_or_gguf, str) else GGUFFile(path_or_gguf)
    cfg = config_from_gguf(gguf)
    E, KV = cfg.dim, cfg.kv_dim

    def vec(name):
        return torch.from_numpy(np.ascontiguousarray(
            gguf.dequantized(name, np.float32))).to(device)

    emb = vec("token_embd.weight")
    params: Dict = {
        "tok_emb": emb.bfloat16() if dtype_policy in ("bf16", "native") else emb,
        "final_norm": vec("output_norm.weight"),
        "final_norm_b": vec("output_norm.bias"),
        "wcls": _load_weight(gguf, "output.weight", dtype_policy, device),
        "bcls": vec("output.bias"),
    }
    wdt = torch.bfloat16 if dtype_policy == "bf16" else torch.float32

    def dense(a):
        return torch.from_numpy(np.ascontiguousarray(a.T)).to(device=device, dtype=wdt)

    layers = []
    for i in range(cfg.n_layers):
        qkv = gguf.dequantized(f"blk.{i}.attn_qkv.weight", np.float32)
        qkv_b = vec(f"blk.{i}.attn_qkv.bias")
        layers.append({
            "attn_norm": vec(f"blk.{i}.attn_norm.weight"),
            "attn_norm_b": vec(f"blk.{i}.attn_norm.bias"),
            "wq": dense(qkv[:E]), "wk": dense(qkv[E:E + KV]), "wv": dense(qkv[E + KV:]),
            "bq": qkv_b[:E], "bk": qkv_b[E:E + KV], "bv": qkv_b[E + KV:],
            "wo": _load_weight(gguf, f"blk.{i}.attn_output.weight", dtype_policy, device),
            "bo": vec(f"blk.{i}.attn_output.bias"),
            "w3": _load_weight(gguf, f"blk.{i}.ffn_up.weight", dtype_policy, device),
            "b3": vec(f"blk.{i}.ffn_up.bias"),
            "w2": _load_weight(gguf, f"blk.{i}.ffn_down.weight", dtype_policy, device),
            "b2": vec(f"blk.{i}.ffn_down.bias"),
        })
    params["layers"] = fuse_llama_layers(layers, lambda i, k: f"blk.{i}.attn_qkv ({k})")
    return params, cfg
