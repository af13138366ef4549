"""Llama-family transformer — the port of ``tpu_llm/models/llama.py``'s
per-layer (unstacked) path: llama (TinyLlama-1.1B, Llama-2), qwen2, gemma,
phi-2 (loaded by ``models/phi2.py``) and Mixtral-style MoE.

``forward(params, cfg, tokens, cache, offset)`` serves prefill (T > 1)
and decode (T = 1). Per layer: norm -> fused wqkv (+ bias) -> RoPE ->
attention with the KV cache -> wo (+ bias) -> norm -> the MLP (SwiGLU,
GeGLU, phi-2's plain GELU MLP with biases, or the MoE FFN); then the
final norm and ``lm_head``. Numerics follow the reference: rmsnorm with
eps inside the sqrt (LayerNorm with bias for phi-2), GQA kv head h // G,
an f32 classifier. The config's switches are the JAX package's:
``parallel_block`` (attention and MLP read one norm output, phi-2),
``use_layernorm``, biases (``bqkv`` / ``bq`` ``bk`` ``bv``, ``bo``,
``b3``, ``b2``, ``bcls``; f32, so they promote bf16 activations to f32
as JAX's type promotion does), ``act`` / ``gated_mlp``, ``emb_scale``
(gemma's sqrt(dim), multiplied in f32), partial and scaled RoPE
(``rope_dims``, ``rope_scaling``), ``n_experts``.

Projections go through quant/linear.matmul (packed QTensors of every
kind -> the qmatmul kernel). With ``TPU_LLM_NORM_FOLD`` set the rmsnorm
weights ride the qkv and w13 projections as their ``row_scale``; with
``TPU_LLM_FFN_MEGAKERNEL`` set a decode FFN (<= 8 bf16 rows, SiLU-gated,
q4_0/q8_0 w13 and w2) is one ffn_fused launch (K7) — the JAX package's
switches, read at the same points (``llama._norm_folded``,
``llama._use_ffn_megakernel``). Attention routes as
``tpu_llm.models.llama._attend`` does: decode to the flash decode kernel
(K2), prefill to the flash prefill kernel (K4) once the einsum path's
(B, T, H, S) scores would pass 64 MB, else to the plain einsum path;
``defer_kv=True`` decode goes to the fused attention + append kernel (K3).
A head width the kernels do not take (``kernel_head_dim``: gemma's 256)
attends on the plain path, decode and prefill alike.

The MoE FFN (``_moe_ffn``) keeps the JAX package's three strategies: the
k selected experts gathered by device index at one token, the union of
the selected experts (a fixed B*T*k of them) when B*T*k < n_experts, and
every expert masked by the gate matrix otherwise. No strategy reads a
device value on the host, so a captured decode step holds it. A gathered
expert's planes are copied out of the stacked (Ex, K, N) planes before
K1 reads them.

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
from tpu_llm_torch.ops.activations import gelu, silu
from tpu_llm_torch.ops.attention import gqa_attention, update_kv_cache
from tpu_llm_torch.ops.flash_attention import (flash_decode_attention,
                                               flash_decode_fused,
                                               flash_gqa_attention, kernel_head_dim)
from tpu_llm_torch.ops.kv_cache import QuantKV, dequantize_kv
from tpu_llm_torch.ops.norms import layernorm, rmsnorm
from tpu_llm_torch.ops.rope import rope_angles, rotate
from tpu_llm_torch.quant.ffn import MAX_ROWS, ffn_fused, ffn_ok
from tpu_llm_torch.quant.linear import matmul
from tpu_llm_torch.quant.qtensor import (QTensor, plane_from_numpy, qmap,
                                         qtensor_from_numpy)

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
    # a head width the kernels refuse attends on the plain path (the JAX
    # package's route for its kernels' refused widths)
    kernel = kernel_head_dim(q.shape[3])
    if T == 1:
        # int8 planes decode on the plain path, as XLA runs them in the
        # JAX package (its decode kernel takes float caches only)
        return flash_decode_attention(q, kc, vc, positions) if kernel and not quant \
            else gqa_attention(q, kc, vc, positions)
    if (kernel and not torch.is_tensor(offset)
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


def _norm(cfg: LlamaConfig, x, lp, prefix: str):
    if cfg.use_layernorm:
        return layernorm(x, lp[f"{prefix}_norm"], lp[f"{prefix}_norm_b"], cfg.norm_eps)
    return rmsnorm(x, lp[f"{prefix}_norm"], cfg.norm_eps)


def _norm_folded(cfg: LlamaConfig, x, lp, prefix: str):
    """(the normed x, None), or, with TPU_LLM_NORM_FOLD set on an rmsnorm
    model without a parallel block, (the weightless rmsnorm, w): the
    weight then multiplies x inside the next projection as its
    row_scale. A parallel block keeps the weighted norm, which attention
    and MLP share."""
    if (cfg.use_layernorm or cfg.parallel_block
            or not os.environ.get("TPU_LLM_NORM_FOLD")):
        return _norm(cfg, x, lp, prefix), None
    return rmsnorm(x, None, cfg.norm_eps), lp[f"{prefix}_norm"]


def _use_ffn_megakernel(cfg: LlamaConfig, x, lp) -> bool:
    """The opt-in one-launch FFN (quant/ffn.py): TPU_LLM_FFN_MEGAKERNEL set,
    a SiLU-gated MLP (the kernel's gate is SiLU), bf16 activations, at most
    8 rows, fused q4_0/q8_0 w13 and w2."""
    if not os.environ.get("TPU_LLM_FFN_MEGAKERNEL") or x.dtype != torch.bfloat16:
        return False
    if cfg.act != "silu" or not cfg.gated_mlp:
        return False
    B, T, _ = x.shape
    return B * T <= MAX_ROWS and "w13" in lp and ffn_ok(lp["w13"], lp.get("w2"))


def _take_plane(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p[idx[0]] for a stacked (Ex, ...) plane and a one-element device
    index, copied without a host read: gathered as 8-byte words where the
    plane allows (index_select moves a few bytes an element at a fraction
    of the card's copy rate; the words cut its element count by 8 / the
    element size)."""
    flat = p.reshape(p.shape[0], -1)
    nbytes = flat.shape[1] * p.element_size()
    if (p.element_size() < 8 and nbytes % 8 == 0 and flat.is_contiguous()
            and (flat.storage_offset() * p.element_size()) % 8 == 0):
        words = flat.view(torch.uint8).view(torch.int64)
        return words.index_select(0, idx)[0].view(torch.uint8).view(p.dtype) \
            .reshape(p.shape[1:])
    return p.index_select(0, idx)[0]


def _expert_slice(w, e):
    """Expert ``e``'s (K, N) weight of the stacked (Ex, K, N) planes: a
    view for a python int, a copy for a device index (one element)."""
    if isinstance(e, int):
        take = lambda p: p[e]  # noqa: E731
    else:
        idx = e.reshape(1).long()
        take = lambda p: _take_plane(p, idx)  # noqa: E731
    return qmap(take, w) if isinstance(w, QTensor) else take(w)


def _moe_ffn(cfg: LlamaConfig, x, lp, rs=None):
    """Mixture-of-experts FFN (``tpu_llm.models.llama._moe_ffn``). Router:
    softmax over the experts, top-k, the k weights renormalized to sum 1.
    One token gathers its k experts; 1 < B*T with B*T*k < n_experts
    gathers the union of the selected experts, a fixed B*T*k of them (the
    used ids first, the rest carry zero gates); otherwise every expert runs
    every token, masked by the (B, T, Ex) gate matrix. Every index stays
    on the device."""
    B, T, E = x.shape
    k = cfg.n_experts_used
    act = gelu if cfg.act == "gelu" else silu
    logits = matmul(x, lp["router"], out_dtype=torch.float32, row_scale=rs)
    topw, topi = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    topw = topw / torch.sum(topw, dim=-1, keepdim=True)

    def expert(e):
        g = matmul(x, _expert_slice(lp["w1e"], e), row_scale=rs)
        u = matmul(x, _expert_slice(lp["w3e"], e), row_scale=rs)
        return matmul(act(g) * u, _expert_slice(lp["w2e"], e)).float()

    out = torch.zeros((B, T, E), dtype=torch.float32, device=x.device)
    if B * T == 1:
        for j in range(k):
            out = out + expert(topi.reshape(-1)[j]) * topw.reshape(-1)[j]
        return out.to(x.dtype)
    gates = torch.zeros((B, T, cfg.n_experts), dtype=torch.float32,
                        device=x.device).scatter_add_(-1, topi, topw)
    if B * T * k < cfg.n_experts:
        used = torch.zeros(cfg.n_experts, dtype=torch.uint8, device=x.device)
        used.index_fill_(0, topi.reshape(-1), 1)
        order = torch.argsort(1 - used, stable=True)      # used ids first
        for u in range(B * T * k):
            e = order[u]
            out = out + expert(e) * gates.index_select(-1, e.reshape(1))
        return out.to(x.dtype)
    for e in range(cfg.n_experts):
        out = out + expert(e) * gates[..., e:e + 1]
    return out.to(x.dtype)


def _block(cfg: LlamaConfig, x, lp, kc, vc, positions, offset, rope_cs,
           defer_kv: bool, update_fn=None, attn_fn=None, reduce_fn=None,
           seq_gather=None):
    # ``reduce_fn`` (tensor parallelism): the sum of the ranks' partial
    # results of the row-parallel projections, applied after wo and after
    # w2 / the MoE combine (or once on a parallel block's sum), before the
    # replicated bo / b2 are added once; cfg is then the rank's LOCAL view
    # (its heads and ffn columns, parallel/serving._tp_local_cfg). wo's and
    # w2's partials stay f32 through the sum and are rounded once, to the
    # dtype the unsharded projection gives; the FFN megakernel (K7) writes
    # bf16 only, so on that path each rank's FFN partial is rounded to
    # bf16 before the f32 sum and rounded again after it.
    # ``seq_gather`` (sequence parallelism): x holds this rank's rows of
    # the sequence; each norm's output is gathered to every row before the
    # column-parallel projections, and ``reduce_fn`` is then the
    # reduce-scatter that hands each rank its rows of wo's and w2's sums.
    part = None if reduce_fn is None else torch.float32
    h, rs = _norm_folded(cfg, x, lp, "attn")
    if seq_gather is not None:
        h = seq_gather(h)
    B, T, _ = h.shape
    if "wqkv" in lp:
        Q, KV = cfg.q_dim, cfg.kv_dim
        qkv = matmul(h, lp["wqkv"], row_scale=rs)
        if "bqkv" in lp:
            qkv = qkv + lp["bqkv"]
        q, k, v = qkv[..., :Q], qkv[..., Q:Q + KV], qkv[..., Q + KV:]
    else:
        q, k, v = (matmul(h, lp[n], row_scale=rs) for n in ("wq", "wk", "wv"))
        if "bq" in lp:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    cos, sin = rope_cs
    q = rotate(q, cos, sin, cfg.rope_variant, cfg.rope_dims)
    k = rotate(k, cos, sin, cfg.rope_variant, cfg.rope_dims)

    if defer_kv and kernel_head_dim(cfg.head_dim):
        # attend the STALE cache plus this step's k/v; the kernel stores
        # them at row pos itself
        attn, kc, vc = flash_decode_fused(q, kc, vc, k.reshape(B, T, cfg.kv_dim),
                                          v.reshape(B, T, cfg.kv_dim), positions)
    else:
        kc, vc = (update_fn or update_kv_cache)(kc, vc, k, v, offset)
        attn = (attn_fn or _attend)(q, kc, vc, positions, offset)
    attn_out = matmul(attn.reshape(B, T, cfg.q_dim), lp["wo"], out_dtype=part)
    if reduce_fn is not None and not cfg.parallel_block:
        attn_out = reduce_fn(attn_out).to(attn.dtype)
    if "bo" in lp and (reduce_fn is None or not cfg.parallel_block):
        attn_out = attn_out + lp["bo"]

    if cfg.parallel_block:
        mlp_in, rs = h, None            # attention and MLP share the input norm
    else:
        x = x + attn_out
        mlp_in, rs = _norm_folded(cfg, x, lp, "ffn")
        if seq_gather is not None:
            mlp_in = seq_gather(mlp_in)
    if cfg.n_experts:
        mlp_out = _moe_ffn(cfg, mlp_in, lp, rs)
        out_dt = mlp_out.dtype
    elif _use_ffn_megakernel(cfg, mlp_in, lp):
        if rs is not None:       # the megakernel takes the weighted input
            mlp_in = (mlp_in.float() * rs).to(mlp_in.dtype)
        mlp_out = ffn_fused(mlp_in, lp["w13"], lp["w2"])
        out_dt = mlp_out.dtype
    else:
        act = gelu if cfg.act == "gelu" else silu
        if cfg.gated_mlp and "w13" in lp:
            F = cfg.hidden_dim
            h13 = matmul(mlp_in, lp["w13"], row_scale=rs)
            mid = act(h13[..., :F]) * h13[..., F:]
        elif cfg.gated_mlp:
            mid = act(matmul(mlp_in, lp["w1"], row_scale=rs)) \
                * matmul(mlp_in, lp["w3"], row_scale=rs)
        else:
            mid = matmul(mlp_in, lp["w3"], row_scale=rs)
            if "b3" in lp:
                mid = mid + lp["b3"]
            mid = act(mid)
        mlp_out = matmul(mid, lp["w2"], out_dtype=part)
        out_dt = mid.dtype
    if reduce_fn is not None and cfg.parallel_block:
        # one reduce of the block's partial sum, then both biases once
        out = reduce_fn(attn_out.float() + mlp_out.float()).to(
            torch.promote_types(attn.dtype, out_dt))
        for b in ("bo", "b2"):
            if b in lp:
                out = out + lp[b]
        return x + out
    if reduce_fn is not None:
        mlp_out = reduce_fn(mlp_out).to(out_dt)
    if "b2" in lp:
        mlp_out = mlp_out + lp["b2"]
    if cfg.parallel_block:
        return x + attn_out + mlp_out
    return x + mlp_out


def embed(params: Params, cfg: LlamaConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids (B, T) -> the embedded rows (B, T, E) (gemma's sqrt(dim)
    scale applied, in f32)."""
    x = params["tok_emb"][tokens.long()]
    if cfg.emb_scale != 1.0:
        x = (x.float() * cfg.emb_scale).to(x.dtype)
    return x


def positions_for(offset, B: int, T: int, device) -> torch.Tensor:
    """The positions of T rows from ``offset`` (``forward``'s forms): (T,)
    for an int, (B, T) for a device tensor."""
    steps = torch.arange(T, dtype=torch.int32, device=device)
    if torch.is_tensor(offset):
        off = offset.to(device=device, dtype=torch.int32).reshape(-1)
        return off.expand(B).reshape(B, 1) + steps
    return offset + steps


def run_layers(layers, cfg: LlamaConfig, x: torch.Tensor, kcs, vcs, positions, offset,
               defer_kv: bool = False, update_fn=None, attn_fn=None, reduce_fn=None,
               seq_gather=None) -> torch.Tensor:
    """Run a list of layers (any contiguous range of ``params["layers"]``,
    a pipeline stage's) on the hidden state x at ``positions`` over their
    own cache planes ``kcs`` / ``vcs`` (one a layer, written in place);
    returns x. The hooks are ``_block``'s. ``forward`` runs the whole stack
    through it."""
    rope_cs = rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.rope_variant,
                          cfg.rope_dims, cfg.rope_scaling)
    for i, lp in enumerate(layers):
        x = _block(cfg, x, lp, kcs[i], vcs[i], positions, offset, rope_cs, defer_kv,
                   update_fn, attn_fn, reduce_fn, seq_gather)
    return x


def forward(params: Params, cfg: LlamaConfig, tokens: torch.Tensor, cache: Cache,
            offset, defer_kv: bool = False, update_fn=None,
            attn_fn=None, reduce_fn=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B, T) at positions [offset, offset + T) -> (final-normed
    hidden (B, T, E), cache). ``offset`` is an int, or a device tensor: (B,)
    per-row positions, or one element for every row. With a tensor offset
    nothing of the step reads the position on the host, so one captured
    CUDA graph of the step serves every position. The cache planes are
    updated in place (``update_fn`` and ``attn_fn`` replace the write and
    the attention; a paged cache passes its per-layer state in
    cache["k"]). ``reduce_fn`` sums the tensor-parallel ranks' partial
    results (``_block``)."""
    B, T = tokens.shape
    if defer_kv and (T != 1 or isinstance(cache["k"][0], QuantKV)):
        raise ValueError("defer_kv is a decode (T == 1) path over float caches")
    x = embed(params, cfg, tokens)
    positions = positions_for(offset, B, T, x.device)
    x = run_layers(params["layers"], cfg, x, cache["k"], cache["v"], positions, offset,
                   defer_kv, update_fn, attn_fn, reduce_fn)
    return apply_final_norm(params, cfg, x), cache


def apply_final_norm(params: Params, cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layernorm:
        return layernorm(x, params["final_norm"], params["final_norm_b"], cfg.norm_eps)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def lm_head(params: Params, cfg: LlamaConfig, x: torch.Tensor,
            gather_fn=None) -> torch.Tensor:
    """Hidden states (B, T, E) -> logits (B, T, V), always f32. The
    classifier runs in x's dtype with an f32 result (``wcls``), or in f32
    against the embedding table (tied embeddings); plus ``bcls`` (phi-2).
    Under tensor parallelism ``wcls`` / ``bcls`` hold this rank's vocab
    columns and ``gather_fn`` tiles the ranks' (B, T, V / tp) logits; the
    replicated embedding table gives every rank the whole vocabulary."""
    if params.get("wcls") is not None:
        logits = matmul(x, params["wcls"], out_dtype=torch.float32)
    else:
        logits = torch.matmul(x.float(), params["tok_emb"].float().t())
    if params.get("bcls") is not None:
        logits = logits + params["bcls"]
    if gather_fn is not None and params.get("wcls") is not None:
        logits = gather_fn(logits)
    return logits


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
    """The config from GGUF metadata for the llama-family architectures
    that share the blk.N.* layout: "llama" (with rope scaling and
    experts), "qwen2" (neox rope, QKV biases) and "gemma*" (explicit
    head_dim, GeGLU, sqrt(dim)-scaled embeddings, neox rope). phi-2 loads
    through ``models/phi2.py``."""
    arch = gguf.hparam("general.architecture", default="llama")
    gemma = arch.startswith("gemma")
    if arch not in ("llama", "qwen2") and not gemma:
        raise NotImplementedError(
            f"architecture {arch!r} is not in tpu_llm_torch's llama family "
            f"(phi2 loads through models/phi2.py)")
    g = lambda k, d=None: gguf.hparam(f"{arch}.{k}", default=d)  # noqa: E731
    n_heads = g("attention.head_count")
    dim = g("embedding_length")
    head_dim = g("attention.key_length") if gemma else None
    if head_dim is not None and head_dim == dim // n_heads:
        head_dim = None
    # RoPE context extension: <arch>.rope.scaling.*, or the legacy
    # <arch>.rope.scale_linear
    scaling_type = g("rope.scaling.type", "none") or "none"
    scaling_factor = float(g("rope.scaling.factor", 1.0))
    orig_ctx = int(g("rope.scaling.original_context_length", 0) or 0)
    legacy_linear = g("rope.scale_linear")
    if scaling_type == "none" and legacy_linear is not None \
            and float(legacy_linear) != 1.0:
        scaling_type, scaling_factor = "linear", float(legacy_linear)
    if scaling_type not in ("none", "linear", "yarn"):
        raise ValueError(f"unsupported rope scaling type {scaling_type!r} in {arch} GGUF")
    n_experts = int(g("expert_count", 0) or 0)
    return LlamaConfig(
        dim=dim,
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
        rope_variant="neox" if (arch == "qwen2" or gemma) else "interleaved",
        use_bias="blk.0.attn_q.bias" in gguf,
        tie_embeddings="output.weight" not in gguf,
        act="gelu" if gemma else "silu",
        head_dim_=head_dim,
        emb_scale=float(dim) ** 0.5 if gemma else 1.0,
        rope_scaling_type=scaling_type,
        rope_scaling_factor=scaling_factor,
        rope_orig_ctx=orig_ctx,
        n_experts=n_experts,
        n_experts_used=int(g("expert_used_count", 2) or 2) if n_experts else 2,
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


def _load_expert_weight(gguf, name: str, dtype_policy: str, device):
    """A stacked expert tensor ``blk.N.ffn_*_exps.weight`` (ggml 3D, one 2D
    weight an expert, expert-major) -> an (Ex, K, N) tensor or a QTensor
    with a leading expert axis; or, without it, the legacy per-expert
    tensors ``blk.N.ffn_*.{e}.weight`` stacked."""
    from tpu_llm_torch.io import gguf as gg
    from tpu_llm_torch.quant.qtensor import qtensor_from_ggml

    stack = lambda ws: (qmap(lambda *ps: torch.stack(ps), *ws)  # noqa: E731
                        if isinstance(ws[0], QTensor) else torch.stack(ws))
    if name in gguf:
        t = gguf.tensors[name]
        n_exp, rows, row_len = t.shape          # (Ex, N_out, K)
        if dtype_policy == "native" and t.ggml_type in gg.QUANT_CODECS:
            raw = gguf.raw(name).reshape(n_exp, -1)
            return stack([qtensor_from_ggml(t.ggml_type, raw[e], rows, row_len, device)
                          for e in range(n_exp)])
        w = gguf.dequantized(name, np.float32)                  # (Ex, N, K)
        out = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))).to(device)
        return out.bfloat16() if dtype_policy in ("bf16", "native") else out
    base = name.replace("_exps.weight", "")
    parts, e = [], 0
    while f"{base}.{e}.weight" in gguf:
        parts.append(_load_weight(gguf, f"{base}.{e}.weight", dtype_policy, device))
        e += 1
    if not parts:
        raise KeyError(f"missing expert tensor {name}")
    return stack(parts)


def load_gguf(path_or_gguf, dtype_policy: str = "f32", fuse: bool = True,
              device="cpu") -> Tuple[Params, LlamaConfig]:
    """Load llama-family weights (llama, qwen2, gemma, MoE) from a GGUF file
    onto ``device``.

    dtype_policy: "f32" (everything dense f32), "bf16" (dense bf16 weights,
    f32 norms) or "native" (f16 stays f16, block-quantized tensors stay
    packed as QTensors; the embedding is bf16). Norms and biases stay
    f32; gemma's norm weights load as 1 + w (the file stores w - 1).
    ``fuse`` concatenates q|k|v (and their biases) and gate|up into single
    projections (a ValueError names the tensors where their kinds
    differ); the stacked expert planes stay as they are."""
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    gguf = path_or_gguf if not isinstance(path_or_gguf, str) else GGUFFile(path_or_gguf)
    cfg = config_from_gguf(gguf)
    arch = gguf.hparam("general.architecture", default="llama")
    norm_off = 1.0 if arch.startswith("gemma") else 0.0
    f32 = lambda name: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(gguf.dequantized(name, np.float32))).to(device)
    emb = f32("token_embd.weight")
    params: Params = {
        "tok_emb": emb.bfloat16() if dtype_policy in ("bf16", "native") else emb,
        "final_norm": norm_off + f32("output_norm.weight"),
        "wcls": (_load_weight(gguf, "output.weight", dtype_policy, device)
                 if "output.weight" in gguf else None),
    }
    tensor_map = dict(_LAYER_TENSORS)
    if cfg.n_experts:
        # the router and the stacked experts replace gate / up / down
        for k in ("w1", "w3", "w2"):
            tensor_map.pop(k)
    layers = []
    for i in range(cfg.n_layers):
        lp = {"attn_norm": norm_off + f32(f"blk.{i}.attn_norm.weight"),
              "ffn_norm": norm_off + f32(f"blk.{i}.ffn_norm.weight")}
        for key, pat in tensor_map.items():
            lp[key] = _load_weight(gguf, pat.format(i=i), dtype_policy, device)
        if cfg.n_experts:
            lp["router"] = _load_weight(gguf, f"blk.{i}.ffn_gate_inp.weight",
                                        dtype_policy, device)
            for key, part in (("w1e", "gate"), ("w3e", "up"), ("w2e", "down")):
                lp[key] = _load_expert_weight(gguf, f"blk.{i}.ffn_{part}_exps.weight",
                                              dtype_policy, device)
        if f"blk.{i}.attn_q.bias" in gguf:      # qwen2's QKV biases
            for bk, part in (("bq", "q"), ("bk", "k"), ("bv", "v")):
                lp[bk] = f32(f"blk.{i}.attn_{part}.bias")
        layers.append(lp)
    params["layers"] = (fuse_llama_layers(layers, lambda i, k: _LAYER_TENSORS[k].format(i=i))
                        if fuse else layers)
    return params, cfg


def load_model(gguf, dtype_policy: str = "f32", device="cpu", lora=None,
               verbose: bool = False) -> Tuple[Params, LlamaConfig]:
    """Load any llama-family GGUF by its ``general.architecture``: phi2
    through ``models/phi2.py``, llama / qwen2 / gemma (and MoE) here. The
    CLIs' loader (``tpu_llm/runtime/cli.py``'s routing). ``lora`` (an
    adapter GGUF, llama family only: ValueError otherwise) loads the
    layers unfused, merges the adapter (io/lora.py) and then fuses them."""
    arch = gguf.hparam("general.architecture", default="llama")
    if lora and arch == "phi2":
        raise ValueError("--lora supports the llama family")
    if arch == "phi2":
        from tpu_llm_torch.models import phi2

        return phi2.load_gguf(gguf, dtype_policy=dtype_policy, device=device)
    if not lora:
        return load_gguf(gguf, dtype_policy=dtype_policy, device=device)
    from tpu_llm_torch.io.lora import apply_lora
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    params, cfg = load_gguf(gguf, dtype_policy=dtype_policy, fuse=False, device=device)
    params = apply_lora(params, lora, verbose=verbose)
    layers = fuse_llama_layers(params["layers"], lambda i, k: _LAYER_TENSORS[k].format(i=i))
    return dict(params, layers=layers), cfg


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

