"""Llama-family transformer (TinyLlama-1.1B, Llama-2) — the port of
``tpu_llm/models/llama.py``'s per-layer (unstacked) path.

``forward(params, cfg, tokens, cache, offset)`` serves prefill (T > 1)
and decode (T = 1). Per layer: rmsnorm -> fused wqkv -> RoPE -> attention
with the KV cache -> wo -> rmsnorm -> fused w13 -> SiLU(gate)*up -> w2;
then the final norm and ``lm_head``. Numerics follow the reference:
rmsnorm with eps inside the sqrt, GQA kv head h // G, SwiGLU, an f32
classifier.

Projections go through quant/linear.matmul (packed QTensors of every
kind -> the qmatmul kernel). With ``TPU_LLM_NORM_FOLD`` set the rmsnorm
weights ride the qkv and w13 projections as their ``row_scale``; with
``TPU_LLM_FFN_MEGAKERNEL`` set a decode FFN (<= 8 bf16 rows, q4_0/q8_0
w13 and w2) is one ffn_fused launch (K7) — the JAX package's switches,
read at the same points (``llama._norm_folded``,
``llama._use_ffn_megakernel``). Attention routes as
``tpu_llm.models.llama._attend`` does: decode to the flash decode kernel
(K2), prefill to the flash prefill kernel (K4) once the einsum path's
(B, T, H, S) scores would pass 64 MB, else to the plain einsum path;
``defer_kv=True`` decode goes to the fused attention + append kernel (K3).

The KV cache is a list of per-layer flat (B, S, Hkv*D) planes, written IN
PLACE (the JAX version threads new arrays through; here a decode step
writes one row), or, for the int8 cache, of ``QuantKV`` planes: decode
attends them on the plain int8 path, and a prefill past the 64 MB gate
dequantizes them once to bf16 for K4. There is no autograd: this path
serves only.

``offset`` is an int, or a (B,) tensor giving each batch row its own
position (continuous batching: positions (B, T) flow through RoPE, the
cache write and attention; decode then goes to K2 with per-row
positions), or a one-element tensor for every row: the engine's
CUDA-graph decode step, which reads its position on the device only.
``update_fn`` / ``attn_fn`` replace the cache write and the attention (the
paged engine's hooks, as in the reference).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.ops.activations import silu
from tpu_llm_torch.ops.attention import gqa_attention, update_kv_cache
from tpu_llm_torch.ops.flash_attention import (flash_decode_attention,
                                               flash_decode_fused,
                                               flash_gqa_attention)
from tpu_llm_torch.ops.kv_cache import QuantKV, dequantize_kv
from tpu_llm_torch.ops.norms import rmsnorm
from tpu_llm_torch.ops.rope import rope_angles, rotate
from tpu_llm_torch.quant.ffn import MAX_ROWS, ffn_fused, ffn_ok
from tpu_llm_torch.quant.linear import matmul
from tpu_llm_torch.quant.qtensor import plane_from_numpy, qtensor_from_numpy

Params = Dict[str, Any]
Cache = Dict[str, List[torch.Tensor]]

# prefill switches from the einsum path to the flash kernel once the
# (B, T, H, S) f32 scores tensor would pass this size (llama._attend)
FLASH_PREFILL_SCORES_BYTES = 64 * 1024 * 1024


# -- KV cache ----------------------------------------------------------------

def init_cache(cfg: LlamaConfig, batch: int = 1, max_seq=None,
               dtype=torch.float32, device="cpu") -> Cache:
    """Per-layer flat (B, S, Hkv*D) K and V planes, zero-filled. ``dtype``
    f32 / bf16, or the string "int8": ``QuantKV`` planes, int8 values
    (B, S, Hkv*D) with kv-head-major f32 scales (B, Hkv, S)
    (ops/kv_cache.py)."""
    S = max_seq or cfg.seq_len
    shape = (batch, S, cfg.kv_dim)
    if dtype in ("int8", torch.int8):
        mk = lambda: QuantKV(  # noqa: E731
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros((batch, cfg.n_kv_heads, S), dtype=torch.float32, device=device))
    else:
        mk = lambda: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    return {"k": [mk() for _ in range(cfg.n_layers)],
            "v": [mk() for _ in range(cfg.n_layers)]}


# -- forward -----------------------------------------------------------------

def _attend(q, kc, vc, positions, offset):
    quant = isinstance(kc, QuantKV)
    T, S, H = q.shape[1], (kc.q if quant else kc).shape[1], q.shape[2]
    if T == 1:
        # int8 planes decode on the plain path, as XLA runs them in the
        # JAX package (its decode kernel takes float caches only)
        return gqa_attention(q, kc, vc, positions) if quant else \
            flash_decode_attention(q, kc, vc, positions)
    if (not torch.is_tensor(offset)
            and q.shape[0] * T * S * H * 4 > FLASH_PREFILL_SCORES_BYTES):
        if quant:
            # dequantize once a prefill call (bf16, 2x the int8 bytes)
            # rather than materialize the einsum path's scores
            D = q.shape[3]
            kc = dequantize_kv(kc, torch.bfloat16, head_dim=D)
            vc = dequantize_kv(vc, torch.bfloat16, head_dim=D)
            return flash_gqa_attention(q.bfloat16(), kc, vc, offset).to(q.dtype)
        return flash_gqa_attention(q, kc, vc, offset)
    return gqa_attention(q, kc, vc, positions)


def _norm_folded(cfg: LlamaConfig, x, lp, prefix: str):
    """(rmsnorm(x, w), None), or, with TPU_LLM_NORM_FOLD set, (the
    weightless rmsnorm, w): the weight then multiplies x inside the next
    projection as its row_scale."""
    if not os.environ.get("TPU_LLM_NORM_FOLD"):
        return rmsnorm(x, lp[f"{prefix}_norm"], cfg.norm_eps), None
    return rmsnorm(x, None, cfg.norm_eps), lp[f"{prefix}_norm"]


def _use_ffn_megakernel(x, lp) -> bool:
    """The opt-in one-launch FFN (quant/ffn.py): TPU_LLM_FFN_MEGAKERNEL set,
    bf16 activations, at most 8 rows, fused q4_0/q8_0 w13 and w2."""
    if not os.environ.get("TPU_LLM_FFN_MEGAKERNEL") or x.dtype != torch.bfloat16:
        return False
    B, T, _ = x.shape
    return B * T <= MAX_ROWS and "w13" in lp and ffn_ok(lp["w13"], lp.get("w2"))


def _block(cfg: LlamaConfig, x, lp, kc, vc, positions, offset, rope_cs,
           defer_kv: bool, update_fn=None, attn_fn=None):
    B, T, _ = x.shape
    h, rs = _norm_folded(cfg, x, lp, "attn")
    if "wqkv" in lp:
        Q, KV = cfg.q_dim, cfg.kv_dim
        qkv = matmul(h, lp["wqkv"], row_scale=rs)
        q, k, v = qkv[..., :Q], qkv[..., Q:Q + KV], qkv[..., Q + KV:]
    else:
        q, k, v = (matmul(h, lp[n], row_scale=rs) for n in ("wq", "wk", "wv"))
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    cos, sin = rope_cs
    q = rotate(q, cos, sin, cfg.rope_variant)
    k = rotate(k, cos, sin, cfg.rope_variant)

    if defer_kv:
        # attend the STALE cache plus this step's k/v; the kernel stores
        # them at row pos itself
        attn, kc, vc = flash_decode_fused(q, kc, vc, k.reshape(B, T, cfg.kv_dim),
                                          v.reshape(B, T, cfg.kv_dim), positions)
    else:
        kc, vc = (update_fn or update_kv_cache)(kc, vc, k, v, offset)
        attn = (attn_fn or _attend)(q, kc, vc, positions, offset)
    x = x + matmul(attn.reshape(B, T, cfg.q_dim), lp["wo"])

    h, rs = _norm_folded(cfg, x, lp, "ffn")
    if _use_ffn_megakernel(x, lp):
        if rs is not None:       # the megakernel takes the weighted input
            h = (h.float() * rs).to(h.dtype)
        return x + ffn_fused(h, lp["w13"], lp["w2"])
    if "w13" in lp:
        F = cfg.hidden_dim
        h13 = matmul(h, lp["w13"], row_scale=rs)
        mid = silu(h13[..., :F]) * h13[..., F:]
    else:
        mid = silu(matmul(h, lp["w1"], row_scale=rs)) * matmul(h, lp["w3"], row_scale=rs)
    return x + matmul(mid, lp["w2"])


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, cache: Cache,
            offset, defer_kv: bool = False, update_fn=None,
            attn_fn=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, T) at positions [offset, offset + T) -> (final-normed
    hidden (B, T, E), cache). ``offset`` is an int, or a device tensor: (B,)
    per-row positions, or one element for every row. With a tensor offset
    nothing of the step reads the position on the host, so one captured
    CUDA graph of the step serves every position. The cache planes are
    updated in place (``update_fn`` and ``attn_fn`` replace the write and
    the attention; a paged cache passes its per-layer state in
    cache["k"])."""
    B, T = tokens.shape
    if defer_kv and (T != 1 or isinstance(cache["k"][0], QuantKV)):
        raise ValueError("defer_kv is a decode (T == 1) path over float caches")
    x = params["tok_emb"][tokens.long()]
    steps = torch.arange(T, dtype=torch.int32, device=x.device)
    if torch.is_tensor(offset):
        off = offset.to(device=x.device, dtype=torch.int32).reshape(-1)
        positions = off.expand(B).reshape(B, 1) + steps
    else:
        positions = offset + steps
    rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_variant)
    for i, lp in enumerate(params["layers"]):
        x = _block(cfg, x, lp, cache["k"][i], cache["v"][i], positions, offset,
                   rope_cs, defer_kv, update_fn, attn_fn)
    return apply_final_norm(params, cfg, x), cache


def apply_final_norm(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_head(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    """Hidden states (B, T, E) -> logits (B, T, V), always f32. The
    classifier runs in x's dtype with an f32 result (``wcls``), or in f32
    against the embedding table (tied embeddings)."""
    if params.get("wcls") is not None:
        return matmul(x, params["wcls"], out_dtype=torch.float32)
    return torch.matmul(x.float(), params["tok_emb"].float().t())


def decode_step(params: Params, cfg: LlamaConfig, token: torch.Tensor, cache: Cache,
                pos, defer_kv: bool = False) -> Tuple[torch.Tensor, Cache]:
    """One decode step: (B,) token ids at position ``pos`` (an int or a
    device tensor, as ``forward``'s offset) -> (B, V) logits."""
    x, cache = forward(params, cfg, token[:, None], cache, pos, defer_kv=defer_kv)
    return lm_head(params, cfg, x)[:, 0, :], cache


# -- loading -----------------------------------------------------------------

_LAYER_TENSORS = {
    "wq": "blk.{i}.attn_q.weight",
    "wk": "blk.{i}.attn_k.weight",
    "wv": "blk.{i}.attn_v.weight",
    "wo": "blk.{i}.attn_output.weight",
    "w1": "blk.{i}.ffn_gate.weight",
    "w3": "blk.{i}.ffn_up.weight",
    "w2": "blk.{i}.ffn_down.weight",
}


def config_from_gguf(gguf) -> LlamaConfig:
    """The config from GGUF metadata, for the ``llama`` architecture."""
    arch = gguf.hparam("general.architecture", default="llama")
    if arch != "llama":
        raise NotImplementedError(
            f"architecture {arch!r} is not in this slice of tpu_llm_torch "
            f"(ROADMAP.md queue 1: other model families)")
    g = lambda k, d=None: gguf.hparam(f"llama.{k}", default=d)  # noqa: E731
    unsupported = [k for k in ("expert_count", "rope.scaling.type",
                               "rope.scale_linear") if g(k) not in (None, 0, 1.0, "none")]
    if unsupported or "blk.0.attn_q.bias" in gguf:
        raise NotImplementedError(
            f"llama GGUF with {unsupported or ['attention biases']} is not in "
            f"this slice of tpu_llm_torch")
    n_heads = g("attention.head_count")
    return LlamaConfig(
        dim=g("embedding_length"),
        hidden_dim=g("feed_forward_length"),
        n_layers=g("block_count"),
        n_heads=n_heads,
        n_kv_heads=g("attention.head_count_kv", n_heads),
        vocab_size=len(gguf.metadata.get("tokenizer.ggml.tokens", []))
        or g("vocab_size", 32000),
        seq_len=g("context_length", 2048),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        norm_eps=float(g("attention.layer_norm_rms_epsilon",
                         g("attention.layer_norm_epsilon", 1e-5))),
        tie_embeddings="output.weight" not in gguf,
    )


def _load_weight(gguf, name: str, dtype_policy: str, device):
    """One 2D GGUF tensor (out, in) as an x @ W-oriented (in, out) weight:
    a QTensor (native block quants, legacy and K-quants) or a dense
    tensor."""
    from tpu_llm_torch.io import gguf as gg
    from tpu_llm_torch.quant.qtensor import qtensor_from_ggml

    t = gguf.tensors[name]
    if dtype_policy == "native" and t.ggml_type in gg.QUANT_CODECS:
        return qtensor_from_ggml(t.ggml_type, gguf.raw(name), t.shape[0],
                                 t.dims[0], device)
    if dtype_policy == "native" and t.ggml_type == gg.GGML_F16:
        w = gguf.array(name)
    else:
        w = gguf.dequantized(name, np.float32)
    out = torch.from_numpy(np.ascontiguousarray(w.T)).to(device)
    if dtype_policy == "bf16" or (dtype_policy == "native" and t.ggml_type
                                  not in (gg.GGML_F32, gg.GGML_F16)):
        out = out.bfloat16()
    return out


def load_gguf(path_or_gguf, dtype_policy: str = "f32", fuse: bool = True,
              device="cpu") -> Tuple[Params, LlamaConfig]:
    """Load llama weights from a GGUF file onto ``device``.

    dtype_policy: "f32" (everything dense f32), "bf16" (dense bf16 weights,
    f32 norms) or "native" (f16 stays f16, block-quantized tensors stay
    packed as QTensors; the embedding is bf16). ``fuse`` concatenates q|k|v
    and gate|up into single projections (a ValueError names the tensors
    where their kinds differ)."""
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    gguf = path_or_gguf if not isinstance(path_or_gguf, str) else GGUFFile(path_or_gguf)
    cfg = config_from_gguf(gguf)
    f32 = lambda name: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(gguf.dequantized(name, np.float32))).to(device)
    emb = f32("token_embd.weight")
    params: Params = {
        "tok_emb": emb.bfloat16() if dtype_policy in ("bf16", "native") else emb,
        "final_norm": f32("output_norm.weight"),
        "wcls": (_load_weight(gguf, "output.weight", dtype_policy, device)
                 if "output.weight" in gguf else None),
    }
    layers = []
    for i in range(cfg.n_layers):
        lp = {"attn_norm": f32(f"blk.{i}.attn_norm.weight"),
              "ffn_norm": f32(f"blk.{i}.ffn_norm.weight")}
        for key, pat in _LAYER_TENSORS.items():
            lp[key] = _load_weight(gguf, pat.format(i=i), dtype_policy, device)
        layers.append(lp)
    params["layers"] = (fuse_llama_layers(layers, lambda i, k: _LAYER_TENSORS[k].format(i=i))
                        if fuse else layers)
    return params, cfg


# -- weights carried across from the JAX package -----------------------------

def params_from_numpy(tree: Params, device="cpu") -> Params:
    """The JAX package's llama parameter pytree, with every array turned
    into numpy (a QTensor given as {"q", "scales", "kind", "mins"}), ->
    the port's parameters on ``device``. Stacked layers (a dict of (L, ...) arrays)
    are split into the per-layer list the port runs. q4_0i4 int4 planes
    (``unpack_params_int4``) are packed into the port's nibble layout;
    int16 f16-bit scale and mins planes carry across as they are."""
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, dict):
            return qtensor_from_numpy(v["q"], v["scales"], v["kind"], v.get("mins"), device)
        return plane_from_numpy(v, device)

    def index(v, i):
        if isinstance(v, dict):
            return {k: (a if k == "kind" or a is None else a[i]) for k, a in v.items()}
        return None if v is None else v[i]

    layers = tree["layers"]
    if isinstance(layers, dict):
        first = next(v for v in layers.values() if v is not None)
        n = len(first["q"] if isinstance(first, dict) else first)
        layers = [{k: index(v, i) for k, v in layers.items()} for i in range(n)]
    out = {k: leaf(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [{k: leaf(v) for k, v in lp.items()} for lp in layers]
    return out

