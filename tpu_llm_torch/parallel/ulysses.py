"""Ulysses attention: head <-> sequence all-to-all context parallelism
(``tpu_llm/parallel/ulysses.py``).

The other long-context layout beside ring attention: activations stay
sequence-sharded over the model group through the projections; one
tiled all-to-all a side of attention scatters heads and gathers the
sequence, so each rank attends the WHOLE sequence for H / n of the heads,
and a second switches back. A layer costs three all-to-alls (q, the k and
v shards together, the output back) instead of ring's n - 1 shifts, but
the degree n must divide n_kv_heads (a contiguous chunk of H / n query
heads then keeps its kv group): TinyLlama's 4 kv heads cap it at 4. A
wider degree raises ValueError naming ring attention, before any
collective.

Attention over the gathered (B, T, H / n, D) goes through the model's own
route (``models.llama._attend``): the flash prefill kernel (K4) once the
scores pass its 64 MB gate, the plain path below it (the JAX version
always takes the plain ``gqa_attention``; K4 matches it within the
kernel's tolerances).

Decode (``decode_ulysses``) keeps the cache HEAD-sharded: each rank holds
the whole sequence for its Hkv / n kv heads (``reshard_cache_for_decode``
switches a prefill's sequence-sharded cache over, one all-to-all for
every layer's planes). A step runs the replicated projections, attends
the rank's head group over its cache with the flash decode kernel (K2),
writes its kv-head columns of the new row, and gathers the (B, 1, H / n,
D) outputs (one tiled gather a layer). Batch rows split over the data
group as in ``parallel/ring.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.ops.attention import update_kv_cache


def _check_degree(cfg: LlamaConfig, n: int) -> None:
    if cfg.n_kv_heads % n:
        raise ValueError(f"Ulysses degree {n} must divide n_kv_heads={cfg.n_kv_heads} "
                         "(use ring attention instead)")


def ulysses_gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh) -> torch.Tensor:
    """Causal GQA attention over the whole sequence, sharded over the model
    group in contiguous blocks in rank order. q (B, Tl, H, D): this rank's
    rows; k, v (B, Sl, Hkv * D) (or (B, Sl, Hkv, D)): its rows of the
    cache, S == T (prefill). Returns (B, Tl, H, D) in q's dtype."""
    from tpu_llm_torch.models.llama import _attend

    g = mesh.model_group
    B, Sl, D = k.shape[0], k.shape[1], q.shape[3]
    kv = torch.stack((k.reshape(B, Sl, -1, D), v.reshape(B, Sl, -1, D)))
    qg = mesh.all_to_all(q, 2, 1, g)            # (B, T, H / n, D)
    kvg = mesh.all_to_all(kv, 3, 2, g)          # (2, B, T, Hkv / n, D)
    T = qg.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=q.device)
    out = _attend(qg, kvg[0], kvg[1], positions, 0)
    return mesh.all_to_all(out, 1, 2, g)       # (B, Tl, H, D)


def prefill_ulysses(params, cfg: LlamaConfig, tokens: torch.Tensor, cache,
                    mesh) -> Tuple[torch.Tensor, dict]:
    """Ulysses llama prefill. tokens (B, T): this rank's batch rows, the
    whole sequence; cache: its sequence shard (``ring.init_cp_cache`` at
    max_seq T). Returns (this rank's final-normed hidden rows (B, T / n,
    E), cache), as ``ring.prefill_context_parallel``."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.ring import _check_seq

    n = mesh.model
    Tl = _check_seq(tokens.shape[1], n)
    _check_degree(cfg, n)
    if cache["k"][0].shape[1] != Tl:
        raise ValueError("Ulysses prefill expects each rank's cache to hold its T / n "
                         "rows (the prefill region)")
    first = mesh.model_index * Tl

    def write(kc, vc, k, v, offset):
        return update_kv_cache(kc, vc, k, v, 0)

    def attend(q, kc, vc, positions, offset):
        return ulysses_gqa_attention(q, kc, vc, mesh)

    return M.forward(params, cfg, tokens[:, first:first + Tl], cache, first,
                     update_fn=write, attn_fn=attend)


def reshard_cache_for_decode(cache, max_seq: int, mesh):
    """A Ulysses prefill's sequence-sharded cache (per layer (B, T / n,
    Hkv * D)) -> the decode layout: per layer (B, max_seq, Hkv / n * D),
    this rank's kv heads over the whole sequence, zero past T. One
    all-to-all for every layer's planes."""
    L = len(cache["k"])
    B, Tl, W = cache["k"][0].shape
    T = Tl * mesh.model
    if max_seq < T:
        raise ValueError(f"max_seq={max_seq} < prefill T={T}")
    planes = mesh.all_to_all(torch.stack(cache["k"] + cache["v"]), 3, 2, mesh.model_group)
    out = torch.zeros((2 * L, B, max_seq, planes.shape[-1]), dtype=planes.dtype,
                      device=planes.device)
    out[:, :, :T] = planes
    return {"k": list(out[:L].unbind(0)), "v": list(out[L:].unbind(0))}


def decode_ulysses(params, cfg: LlamaConfig, token: torch.Tensor, cache, pos,
                   mesh) -> Tuple[torch.Tensor, dict]:
    """One Ulysses decode step over the head-sharded cache
    (``reshard_cache_for_decode``): token (B,) this rank's batch rows at
    ``pos`` (an int or a device tensor, as ``forward``'s offset). Returns
    ((B, V) f32 logits, cache), the single-rank ``decode_step``'s."""
    from tpu_llm_torch.models import llama as M

    n = mesh.model
    _check_degree(cfg, n)
    r = mesh.model_index
    Hl, Hkvl = cfg.n_heads // n, cfg.n_kv_heads // n

    def write(kc, vc, k, v, offset):
        return update_kv_cache(kc, vc, k[:, :, r * Hkvl:(r + 1) * Hkvl],
                               v[:, :, r * Hkvl:(r + 1) * Hkvl], offset)

    def attend(q, kc, vc, positions, offset):
        out = M._attend(q[:, :, r * Hl:(r + 1) * Hl].contiguous(), kc, vc, positions,
                        offset)
        return mesh.gather_model(out, 2)

    x, cache = M.forward(params, cfg, token[:, None], cache, pos, update_fn=write,
                         attn_fn=attend)
    return M.lm_head(params, cfg, x)[:, 0, :], cache
