"""Ring attention and sequence-sharded decode: context parallelism (CP)
(``tpu_llm/parallel/ring.py``).

The sequence is sharded over the mesh's model group with contiguous
ownership: rank r (its model index) holds rows [r * Sl, (r + 1) * Sl) of
the tokens and of every layer's KV planes, so each rank keeps 1/n of the
cache. Weights are replicated over the model group; batch rows split over
the data group (``sharding.data_rows``: the caller passes this rank's
rows).

- Prefill (``prefill_context_parallel``): each rank runs its T / n rows
  through the layers, writing its cache shard from row 0, while RoPE
  takes the rows' absolute positions. Attention is ``ring_gqa_attention``:
  the (k, v) shard travels around the ring, n - 1 shifts a layer (k and v
  in one ``ppermute``), while every rank folds each block into a
  blockwise online softmax for its resident queries. The positions of the
  block a rank holds at ring step j follow from the step, ((r - j) mod n)
  * Sl + arange(Sl), so no positions travel (the JAX version rotates them
  with k and v). A block wholly in the queries' causal future adds exactly
  zero to the softmax state, so it is skipped.
- Decode (``decode_step_context_parallel``): the query is replicated;
  each rank scores it against its resident shard, and
  ``cp_decode_attention`` combines the partial softmax states with two
  all-reduces a layer: the max, then one f32 sum of [l | acc] (the JAX
  version: a pmax and two psums). Only the rank that owns row ``pos``
  writes it.

The ring block and the decode combine are plain PyTorch in f32, as the
JAX package computes them in einsums outside any Pallas kernel; the
projections and the FFN go through the quantized matmul kernel (K1) as on
every path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.ops.attention import NEG_INF, update_kv_cache
from tpu_llm_torch.parallel.sharding import data_rows


def init_cp_cache(cfg: LlamaConfig, mesh, batch: int, max_seq: int,
                  dtype=torch.float32):
    """This rank's sequence shard of a dense cache: per layer flat
    (batch rows of ``data_rows``, max_seq / n, Hkv * D) planes."""
    from tpu_llm_torch.models import llama as M

    if max_seq % mesh.model:
        raise ValueError(f"max_seq={max_seq} not divisible by the sequence axis "
                         f"({mesh.model} ranks)")
    rows = data_rows(mesh, batch)
    return M.init_cache(cfg, rows.stop - rows.start, max_seq // mesh.model, dtype,
                        mesh.device)


def ring_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       q_offset: int, mesh) -> torch.Tensor:
    """Causal GQA attention with the KV shards ring-rotated over the
    model group. q (B, Tq, H, D): this rank's queries at absolute positions
    [q_offset, q_offset + Tq); k, v: its shard (B, Sl, Hkv * D) (or
    (B, Sl, Hkv, D)) at positions [r * Sl, (r + 1) * Sl). Returns
    (B, Tq, H, D) in q's dtype."""
    n, r = mesh.model, mesh.model_index
    B, Tq, H, D = q.shape
    Sl = k.shape[1]
    scale = 1.0 / float(D) ** 0.5
    kv = torch.stack((k.reshape(B, Sl, -1), v.reshape(B, Sl, -1)))
    Hkv = kv.shape[-1] // D
    qf = q.float().reshape(B, Tq, Hkv, H // Hkv, D)
    m = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = q_offset + torch.arange(Tq, device=q.device)
    for j in range(n):
        first = ((r - j) % n) * Sl
        if first <= q_offset + Tq - 1:
            kf, vf = kv.reshape(2, B, Sl, Hkv, D).float().unbind(0)
            s = torch.einsum("bthgd,bshd->bthgs", qf, kf) * scale
            visible = (first + torch.arange(Sl, device=q.device))[None, :] <= q_pos[:, None]
            s = s.masked_fill(~visible[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bthgs,bshd->bthgd", p, vf)
            m = m_new
        if j < n - 1:
            kv = mesh.ppermute(kv, mesh.model_group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Tq, H, D).to(q.dtype)


def _check_seq(T: int, n: int) -> int:
    if T % n:
        raise ValueError(f"T={T} not divisible by the sequence axis ({n} ranks)")
    return T // n


def prefill_context_parallel(params, cfg: LlamaConfig, tokens: torch.Tensor, cache,
                             mesh) -> Tuple[torch.Tensor, dict]:
    """Context-parallel llama prefill. tokens (B, T): this rank's batch rows,
    the whole sequence (T divisible by the model group's size); cache: its
    sequence shard (``init_cp_cache`` at max_seq T). Returns (this rank's
    final-normed hidden rows (B, T / n, E), cache), the rows of the
    single-rank ``forward`` at [r * T / n, (r + 1) * T / n)."""
    from tpu_llm_torch.models import llama as M

    Tl = _check_seq(tokens.shape[1], mesh.model)
    if cache["k"][0].shape[1] != Tl:
        raise ValueError("CP prefill expects each rank's cache to hold its T / n rows "
                         "(the prefill region)")
    first = mesh.model_index * Tl

    def write(kc, vc, k, v, offset):
        return update_kv_cache(kc, vc, k, v, 0)

    def attend(q, kc, vc, positions, offset):
        return ring_gqa_attention(q, kc, vc, first, mesh)

    return M.forward(params, cfg, tokens[:, first:first + Tl], cache, first,
                     update_fn=write, attn_fn=attend)


def cp_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
                        mesh) -> torch.Tensor:
    """One query row (B, 1, H, D), replicated over the model group, at
    absolute position ``pos`` against the sequence-sharded cache: this
    rank's shard (B, Sl, Hkv * D) holds positions [r * Sl, (r + 1) * Sl).
    The global max, then [l | acc] summed in f32. Returns (B, 1, H, D) in
    q's dtype."""
    B, T, H, D = q.shape
    Sl = k.shape[1]
    k4 = k.reshape(B, Sl, -1, D).float()
    v4 = v.reshape(B, Sl, -1, D).float()
    qf = q.float().reshape(B, T, k4.shape[2], H // k4.shape[2], D)
    s = torch.einsum("bthgd,bshd->bthgs", qf, k4) * (1.0 / float(D) ** 0.5)
    visible = mesh.model_index * Sl + torch.arange(Sl, device=q.device) <= pos
    s = s.masked_fill(~visible, NEG_INF)
    m = mesh.reduce_model(s.amax(dim=-1), "max")
    p = torch.exp(s - m[..., None])
    la = torch.cat((p.sum(dim=-1)[..., None], torch.einsum("bthgs,bshd->bthgd", p, v4)), -1)
    la = mesh.reduce_model(la)
    out = la[..., 1:] / torch.clamp(la[..., :1], min=1e-30)
    return out.reshape(B, T, H, D).to(q.dtype)


def decode_step_context_parallel(params, cfg: LlamaConfig, token: torch.Tensor, cache,
                                 pos: int, mesh) -> Tuple[torch.Tensor, dict]:
    """One decode step over the sequence-sharded cache (``init_cp_cache``):
    token (B,) this rank's batch rows at the int position ``pos``. Returns
    ((B, V) f32 logits, cache), the single-rank ``decode_step``'s."""
    from tpu_llm_torch.models import llama as M

    Sl = cache["k"][0].shape[1]
    if not 0 <= pos < Sl * mesh.model:
        raise ValueError(f"pos={pos} outside the sharded cache ({Sl * mesh.model} rows)")
    local = pos - mesh.model_index * Sl

    def write(kc, vc, k, v, offset):
        if 0 <= local < Sl:            # only the owner of row pos writes it
            update_kv_cache(kc, vc, k, v, local)
        return kc, vc

    def attend(q, kc, vc, positions, offset):
        return cp_decode_attention(q, kc, vc, pos, mesh)

    x, cache = M.forward(params, cfg, token[:, None], cache, pos, update_fn=write,
                         attn_fn=attend)
    return M.lm_head(params, cfg, x)[:, 0, :], cache
