"""GQA attention against a preallocated dense KV cache (``tpu_llm/ops/
attention.py``, the f32/bf16 flat-cache paths).

These are XLA code in the JAX package, so they are plain torch here: the
einsum formulation for prefill (T > 1, causal) and decode (T = 1). They
also serve as the plain twins of the decode kernels in
ops/flash_attention.py. Query head h reads kv head h // G. Cache slot s
is visible to a query at position p iff s <= p.

Numerics follow the reference: everything in f32, except that when q and
both caches are bf16 the softmax weights are rounded to bf16 before the
AV product (the reference contracts bf16 operands with f32 accumulation).

Cache planes are flat (B, S, Hkv*D); ``update_kv_cache`` writes them IN
PLACE (the JAX version returns new arrays): a decode step then touches one
row instead of copying the plane. A (B,) offset vector writes each batch
row at its own position (continuous batching). The dense int8 cache is a
``QuantKV`` pair a plane: the new rows are quantized on the way in
(``quantize_kv``) and their scales written beside them
(``_update_scales_flat``, or ``_update_scales`` for 4D planes).

``kv_lengths`` (B,) additionally hides slots s >= kv_lengths[b] (the paged
cache's gathered view, whose unmapped blocks hold garbage). int8 caches
(``QuantKV``) are contracted without dequantizing: the K scale multiplies
the score matrix, the V scale the softmax weights; with bf16 q the
weights are rounded to bf16 after the V scale (``_gqa_attention_int8``).
"""

from __future__ import annotations

import torch

from tpu_llm_torch.ops.kv_cache import QuantKV, quantize_kv

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _write_rows(dst: torch.Tensor, src: torch.Tensor, offset, axis: int = 1):
    """Write ``src`` into ``dst`` at [offset, offset + T) along ``axis``
    (1 or 2; batch is axis 0), in place. ``offset`` is an int, or a (B,)
    tensor of per-row starts clamped to [0, S - T] as
    ``dynamic_update_slice`` clamps them."""
    if axis == 2:           # (B, H, S) planes: write the (B, S, H) view
        dst, src = dst.transpose(1, 2), src.transpose(1, 2)
    B, T = src.shape[:2]
    src = src.to(dst.dtype)
    if not torch.is_tensor(offset):
        dst[:, offset:offset + T] = src
        return
    dev = dst.device
    start = offset.reshape(-1).to(device=dev, dtype=torch.long).expand(B)
    cols = (start.clamp(0, dst.shape[1] - T)[:, None]
            + torch.arange(T, device=dev)[None, :])
    dst[torch.arange(B, device=dev)[:, None], cols] = src


def update_kv_cache(k_cache, v_cache, k_new: torch.Tensor, v_new: torch.Tensor,
                    offset):
    """Write k_new/v_new (B, T, Hkv, D) at rows [offset, offset+T) of the
    caches, in place: flat (B, S, Hkv*D) or 4D (B, S, Hkv, D) planes, or
    ``QuantKV`` pairs (the rows quantized by ``quantize_kv``, their scales
    written beside them). ``offset`` is an int, or a (B,) tensor of
    per-row positions whose start clamps to [0, S - T] as
    ``dynamic_update_slice`` clamps it. Returns the caches."""
    B, T = k_new.shape[:2]
    if isinstance(k_cache, QuantKV):
        kq, ks = quantize_kv(k_new)             # (B, T, Hkv, D), (B, T, Hkv)
        vq, vs = quantize_kv(v_new)
        update_kv_cache(k_cache.q, v_cache.q, kq, vq, offset)
        if k_cache.q.dim() == 3:                # flat planes, (B, Hkv, S) scales
            _update_scales_flat(k_cache.s, v_cache.s, ks.transpose(1, 2),
                                vs.transpose(1, 2), offset)
        else:
            _update_scales(k_cache.s, v_cache.s, ks, vs, offset)
        return k_cache, v_cache
    _write_rows(k_cache, k_new.reshape(B, T, *k_cache.shape[2:]), offset)
    _write_rows(v_cache, v_new.reshape(B, T, *v_cache.shape[2:]), offset)
    return k_cache, v_cache


def _update_scales_flat(ks_c, vs_c, ks, vs, offset):
    """Write (B, Hkv, T) scale slabs into (B, Hkv, S) planes at column
    ``offset``, in place."""
    _write_rows(ks_c, ks, offset, axis=2)
    _write_rows(vs_c, vs, offset, axis=2)
    return ks_c, vs_c


def _update_scales(ks_c, vs_c, ks, vs, offset):
    """Write (B, T, Hkv) scale rows into (B, S, Hkv) planes, in place."""
    _write_rows(ks_c, ks, offset)
    _write_rows(vs_c, vs, offset)
    return ks_c, vs_c


def _bf16_inputs(q, k_cache, v_cache) -> bool:
    return (q.dtype == torch.bfloat16 and k_cache.dtype == torch.bfloat16
            and v_cache.dtype == torch.bfloat16)


def _grouped(q, k_cache, v_cache):
    """(B,T,H,D) q and flat or 4D caches -> f32 (B,T,Hkv,G,D) q and
    (B,S,Hkv,D) caches."""
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    k4 = k_cache.reshape(B, S, -1, D).float()
    v4 = v_cache.reshape(B, S, -1, D).float()
    Hkv = k4.shape[2]
    return q.float().reshape(B, T, Hkv, H // Hkv, D), k4, v4


def _causal_mask(scores: torch.Tensor, q_positions: torch.Tensor, S: int,
                 kv_lengths) -> torch.Tensor:
    """Mask (B, T, Hkv, G, S) scores to slots s <= q_position (and s <
    kv_lengths[b] when given)."""
    T = scores.shape[1]
    qp = q_positions.reshape(1, T) if q_positions.dim() == 1 else q_positions
    s_idx = torch.arange(S, device=scores.device)
    visible = s_idx[None, None, :] <= qp[:, :, None]              # (B|1, T, S)
    if kv_lengths is not None:
        visible = visible & (s_idx[None, None, :]
                             < kv_lengths.reshape(-1)[:, None, None])
    # a Python scalar fill: no host-to-device copy, so a CUDA graph captures it
    return scores.masked_fill(~visible[:, :, None, None, :], NEG_INF)


def gqa_attention(q: torch.Tensor, k_cache, v_cache, q_positions: torch.Tensor,
                  kv_lengths=None) -> torch.Tensor:
    """Scaled dot-product GQA attention. q (B, T, H, D); caches flat
    (B, S, Hkv*D) or (B, S, Hkv, D), or ``QuantKV`` pairs; q_positions
    (T,) or (B, T) absolute positions; kv_lengths None or (B,). Returns
    (B, T, H, D) in q's dtype."""
    if isinstance(k_cache, QuantKV):
        if k_cache.q.dim() == 3:
            return _gqa_attention_int8_flat(q, k_cache, v_cache, q_positions,
                                            kv_lengths)
        return _gqa_attention_int8(q, k_cache, v_cache, q_positions, kv_lengths)
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    qg, k4, v4 = _grouped(q, k_cache, v_cache)
    scores = torch.einsum("bthgd,bshd->bthgs", qg, k4) * (1.0 / float(D) ** 0.5)
    scores = _causal_mask(scores, q_positions, S, kv_lengths)
    att = torch.softmax(scores, dim=-1)
    if _bf16_inputs(q, k_cache, v_cache):
        att = att.bfloat16().float()
    out = torch.einsum("bthgs,bshd->bthgd", att, v4)
    return out.reshape(B, T, H, D).to(q.dtype)


def _gqa_attention_int8(q, k_cache: QuantKV, v_cache: QuantKV, q_positions,
                        kv_lengths):
    """int8 planes (B, S, Hkv, D) with (B, S, Hkv) scales. Scores are
    (q . k) * (ks * scale) with the int8 values exact; the softmax weights
    take the V scale and, for bf16 q, are rounded to bf16 before the AV
    product (the reference's bf16 compute dtype; f32 q stays f32)."""
    B, T, H, D = q.shape
    S, Hkv = k_cache.q.shape[1], k_cache.q.shape[2]
    qg = q.float().reshape(B, T, Hkv, H // Hkv, D)
    scores = torch.einsum("bthgd,bshd->bthgs", qg, k_cache.q.float())
    ks = (k_cache.s * (1.0 / float(D) ** 0.5)).transpose(1, 2)    # (B, Hkv, S)
    scores = scores * ks[:, None, :, None, :]
    scores = _causal_mask(scores, q_positions, S, kv_lengths)
    att = torch.softmax(scores, dim=-1)
    att = att * v_cache.s.transpose(1, 2)[:, None, :, None, :]
    if q.dtype == torch.bfloat16:
        att = att.bfloat16().float()
    out = torch.einsum("bthgs,bshd->bthgd", att, v_cache.q.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def _gqa_attention_int8_flat(q, k_cache: QuantKV, v_cache: QuantKV, q_positions,
                             kv_lengths):
    """Flat int8 planes (B, S, Hkv*D) with kv-head-major (B, Hkv, S)
    scales: the same function as the 4D form (the reference's
    block-diagonal contraction adds only exact zeros)."""
    D = q.shape[-1]

    def four_d(kv: QuantKV) -> QuantKV:
        B, S, hkvd = kv.q.shape
        return QuantKV(kv.q.reshape(B, S, hkvd // D, D), kv.s.transpose(1, 2))

    return _gqa_attention_int8(q, four_d(k_cache), four_d(v_cache), q_positions,
                               kv_lengths)


def gqa_attention_deferred(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_cur: torch.Tensor,
                           v_cur: torch.Tensor,
                           q_positions: torch.Tensor) -> torch.Tensor:
    """Decode attention with the cache write DEFERRED: attend the STALE
    flat cache (slots < pos) plus this step's k_cur/v_cur (B, 1, Hkv*D)
    as slot pos — the same math as write-then-attend. q (B, 1, H, D);
    q_positions (1,) or (B, 1). The insertion slot clamps at S-1."""
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    qg, k4, v4 = _grouped(q, k_cache, v_cache)
    Hkv = k4.shape[2]
    kc4 = k_cur.reshape(B, T, Hkv, D).float()
    vc4 = v_cur.reshape(B, T, Hkv, D).float()
    scale = 1.0 / float(D) ** 0.5
    scores = torch.einsum("bthgd,bshd->bthgs", qg, k4) * scale
    score_cur = torch.einsum("bthgd,bthd->bthg", qg, kc4) * scale
    qp = q_positions.reshape(1, T) if q_positions.dim() == 1 else q_positions
    s_idx = torch.arange(S, device=q.device)
    is_cur = (s_idx[None, None, :] == torch.clamp(qp, max=S - 1)[:, :, None])
    visible = s_idx[None, None, :] <= qp[:, :, None]
    is_cur5 = is_cur[:, :, None, None, :]
    scores = torch.where(is_cur5, score_cur[..., None], scores)
    scores = scores.masked_fill(~visible[:, :, None, None, :], NEG_INF)
    att = torch.softmax(scores, dim=-1)
    att_cur = torch.sum(att * is_cur5, dim=-1)                    # (B,T,Hkv,G)
    att_cache = att * ~is_cur5
    if _bf16_inputs(q, k_cache, v_cache):
        att_cache = att_cache.bfloat16().float()
    out = (torch.einsum("bthgs,bshd->bthgd", att_cache, v4)
           + att_cur[..., None] * vc4[:, :, :, None, :])
    return out.reshape(B, T, H, D).to(q.dtype)
