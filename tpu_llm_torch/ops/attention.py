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
row instead of copying the plane.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, offset: int):
    """Write k_new/v_new (B, T, Hkv, D) at rows [offset, offset+T) of the
    flat (B, S, Hkv*D) planes, in place. Returns the planes."""
    B, T = k_new.shape[:2]
    k_cache[:, offset:offset + T] = k_new.reshape(B, T, -1).to(k_cache.dtype)
    v_cache[:, offset:offset + T] = v_new.reshape(B, T, -1).to(v_cache.dtype)
    return k_cache, v_cache


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


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  q_positions: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product GQA attention. q (B, T, H, D); caches flat
    (B, S, Hkv*D) or (B, S, Hkv, D); q_positions (T,) or (B, T) absolute
    positions. Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    qg, k4, v4 = _grouped(q, k_cache, v_cache)
    scores = torch.einsum("bthgd,bshd->bthgs", qg, k4) * (1.0 / float(D) ** 0.5)
    qp = q_positions.reshape(1, T) if q_positions.dim() == 1 else q_positions
    s_idx = torch.arange(S, device=q.device)
    visible = s_idx[None, None, :] <= qp[:, :, None]              # (B|1, T, S)
    scores = torch.where(visible[:, :, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    att = torch.softmax(scores, dim=-1)
    if _bf16_inputs(q, k_cache, v_cache):
        att = att.bfloat16().float()
    out = torch.einsum("bthgs,bshd->bthgd", att, v4)
    return out.reshape(B, T, H, D).to(q.dtype)


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
    scores = torch.where(visible[:, :, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    att = torch.softmax(scores, dim=-1)
    att_cur = torch.sum(att * is_cur5, dim=-1)                    # (B,T,Hkv,G)
    att_cache = att * ~is_cur5
    if _bf16_inputs(q, k_cache, v_cache):
        att_cache = att_cache.bfloat16().float()
    out = (torch.einsum("bthgs,bshd->bthgd", att_cache, v4)
           + att_cur[..., None] * vc4[:, :, :, None, :])
    return out.reshape(B, T, H, D).to(q.dtype)
