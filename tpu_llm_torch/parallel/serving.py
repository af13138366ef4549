"""The engines on a mesh of ranks (``tpu_llm/parallel/serving.py``).

Every rank runs the engine's host loop on identical inputs, and the model
calls the collectives (SPMD): nothing of the loop changes but where the
weights and the KV state live and what the adapter's forward does.

- ``make_tp_llama_adapter``: a ``ModelAdapter`` whose forward runs the
  llama model on the rank's LOCAL view (``_tp_local_cfg``: heads, kv heads
  and ffn columns / tp) with an all-reduce after the row-parallel
  projections (``models.llama.forward(reduce_fn=...)``) and the
  classifier's vocab shards gathered (``lm_head(gather_fn=...)``). So K1
  runs on each rank's shard of every projection, and K2-K4 on its heads,
  exactly as on one card. Under "data" the dense batch rows split: a
  rank keeps batch / dp rows of the cache and decodes them, and the
  forward's last hidden rows are gathered over the data group, so the
  classifier gives every rank every row's logits, every rank samples
  every row with generators seeded alike and its host state stays
  identical (the hidden rows are gathered rather than the tokens: the
  filters, penalties, bias and logprobs then need nothing more; and
  rather than the logits: E bf16 values a row against V f32). A slot's prefill
  runs on the data rank that owns its rows, and its last logits are
  broadcast to the others (``local_row`` / ``share_row``). A batch that
  does not divide by dp (the single-stream engine's batch 1) runs on
  every data rank alike, as the JAX adapter replicates it.
- ``shard_engine``: places a ``BatchEngine`` or ``PagedEngine`` (and a
  two-model draft) on the mesh with the JAX package's validations and
  messages. The paged engine cuts its pools by kv head and keeps its block
  table, allocator and prefix cache identical on every rank; its batch
  is not split over "data". Unlike the JAX GSPMD fallback (which turns
  the Pallas kernels off for these engines), every engine and cache dtype
  keeps its kernels per shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from tpu_llm_torch.config import LlamaConfig


def _tp_local_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The per-shard view of the model: heads / kv heads / ffn divided by
    tp, head_dim pinned (dim stays global, so the derived head_dim would
    be wrong), everything else unchanged."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                               n_kv_heads=cfg.n_kv_heads // tp,
                               hidden_dim=cfg.hidden_dim // tp, head_dim_=cfg.head_dim)


def shard_llama_params(params, cfg: LlamaConfig, mesh):
    """This rank's shards of llama-family params (fused layers repacked for
    the model axis first)."""
    from tpu_llm_torch.parallel.sharding import llama_param_specs, shard_params
    from tpu_llm_torch.parallel.tp_decode import repack_fused_for_tp

    lp0 = params["layers"][0]
    fused = "wqkv" in lp0 or "w13" in lp0
    if fused and mesh.model > 1:
        params = dict(params, layers=repack_fused_for_tp(params["layers"], cfg, mesh.model))
    return shard_params(params, llama_param_specs(cfg, params=params, fused=fused), mesh)


def make_tp_llama_adapter(cfg: LlamaConfig, mesh, cache_dtype=torch.float32,
                          bos_id: int = 1):
    """A ModelAdapter running the llama model on this rank's shards (params
    from ``shard_llama_params``), its state the rank's local cache."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.engine import ModelAdapter

    dp = mesh.data
    lcfg = _tp_local_cfg(cfg, mesh.model)

    def splits(B: int) -> bool:
        return dp > 1 and B >= dp and B % dp == 0

    def rows(x, B: int):
        b = B // dp
        return x.narrow(0, mesh.data_index * b, b)

    def apply(params, tokens, state, offset, length=None):
        B = tokens.shape[0]
        if not splits(B):
            return M.forward(params, lcfg, tokens, state, offset, reduce_fn=mesh.reduce_model)
        tokens = rows(tokens, B)
        if torch.is_tensor(offset) and offset.numel() == B:
            offset = rows(offset.reshape(-1), B)
        hidden, state = M.forward(params, lcfg, tokens, state, offset,
                                  reduce_fn=mesh.reduce_model)
        return mesh.gather_data(hidden, 0), state

    def lm_head(params, hidden):
        return M.lm_head(params, lcfg, hidden, gather_fn=mesh.gather_model)

    def init_state(batch, max_seq):
        return M.init_cache(lcfg, batch // dp if splits(batch) else batch, max_seq,
                            cache_dtype, mesh.device)

    def local_row(idx: int, batch: int) -> Optional[int]:
        if not splits(batch):
            return idx
        b = batch // dp
        return idx - mesh.data_index * b if idx // b == mesh.data_index else None

    def share_row(logits, idx: int, batch: int):
        return mesh.broadcast_data(logits, idx // (batch // dp)) if splits(batch) else logits

    return ModelAdapter(apply=apply, lm_head=lm_head, init_state=init_state, bos_id=bos_id,
                        vocab_size=cfg.vocab_size, local_row=local_row, share_row=share_row)


def _cache_dtype(state):
    from tpu_llm_torch.ops.kv_cache import QuantKV

    first = state["k"][0]
    return "int8" if isinstance(first, QuantKV) else first.dtype


def shard_engine(eng: Any, cfg: LlamaConfig, mesh, draft_cfg: Optional[LlamaConfig] = None):
    """Place a BatchEngine / PagedEngine's params and KV state on ``mesh``:
    right after construction, before the first step. Batch rows ride
    "data" (dense cache), heads / ffn columns / vocab "model"; the paged
    pools cut their Hkv * D axis. Two-model speculation: pass the draft's
    config, ``draft_cfg``; the draft gets its own shards and state."""
    from tpu_llm_torch.config import MambaConfig

    tp, dp = mesh.model, mesh.data
    if tp > 1 and cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} (the KV cache shards "
            f"whole kv heads; use Ulysses/CP for wider degrees)")
    if dp > 1 and eng.batch % dp:
        raise ValueError(f"dp={dp} must divide engine batch={eng.batch}")
    if isinstance(cfg, MambaConfig) or not isinstance(getattr(eng, "state", None), dict):
        raise NotImplementedError("mesh serving supports llama-family KV states only")
    if eng._draft is not None:
        if draft_cfg is None:
            raise NotImplementedError(
                "two-model speculation under a serving mesh needs shard_engine(..., "
                "draft_cfg=<draft LlamaConfig>) so the draft's params/state get their "
                "own placement")
        if tp > 1 and draft_cfg.n_kv_heads % tp:
            raise ValueError(f"tp={tp} must divide the draft model's "
                             f"n_kv_heads={draft_cfg.n_kv_heads}")
        dparams, dadapter = eng._draft
        eng._draft = (shard_llama_params(dparams, draft_cfg, mesh),
                      make_tp_llama_adapter(draft_cfg, mesh, _cache_dtype(eng._draft_state),
                                            bos_id=dadapter.bos_id))
    eng.params = shard_llama_params(eng.params, cfg, mesh)
    eng.device = mesh.device
    if "table" in eng.state:                     # PagedEngine: pools cut by kv head
        eng.cfg = _tp_local_cfg(cfg, tp)
        eng._reduce, eng._gather = mesh.reduce_model, mesh.gather_model
        eng.state = eng._fresh_state()
        eng._reset_blocks()
    else:
        eng.adapter = make_tp_llama_adapter(cfg, mesh, _cache_dtype(eng.state),
                                            bos_id=eng.adapter.bos_id)
        eng.state = eng.adapter.init_state(eng.batch, eng.max_seq)
    eng._reset_common()
    eng.mesh = mesh
    return eng
