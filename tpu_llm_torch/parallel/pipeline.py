"""Pipeline parallelism (PP): layer ranges over the mesh's pipe axis
(``tpu_llm/parallel/pipeline.py``).

Stage s (the rank's pipe index, of n) owns layers [s * L / n, (s + 1) *
L / n) and their KV planes (``stage_params``, ``init_stage_cache``); the
embedding, final norm and classifier are kept on every stage. The hidden
rows hop from stage to stage point to point over the pipe group:

- decode (``decode_step_pipelined``): stage 0 embeds the token, each stage
  runs its layers and sends the row on (n - 1 hops), and the last stage
  broadcasts the finished row, so every rank computes the logits;
- prefill (``prefill_pipelined``): the prompt is cut into sequence chunks
  that stream through the stages, so after the fill every stage works on
  a different chunk; a chunk's attention sees the earlier chunks' rows in
  its own stage's cache. The last stage broadcasts the whole hidden state.
- PP x TP (``decode_step_pp_tp``): the same stage ring, each stage's
  layers also cut over the model group (``stage_params`` on a mesh with
  model > 1), the model's own blocks all-reducing after wo and w2
  (``reduce_fn``) and the vocab-split classifier's logits gathered.

The JAX package runs every stage at every tick and masks the results
(one SPMD program); the port computes the same function with real sends.
Batch rows split over the data group as in ``parallel/ring.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_llm_torch.config import LlamaConfig


def _check(cfg: LlamaConfig, mesh) -> None:
    if cfg.n_layers % mesh.pipe:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pipe={mesh.pipe}")


def stage_layers(cfg: LlamaConfig, mesh) -> range:
    """The layer indices this rank's stage owns."""
    _check(cfg, mesh)
    per = cfg.n_layers // mesh.pipe
    return range(mesh.pipe_index * per, (mesh.pipe_index + 1) * per)


def stage_params(params, cfg: LlamaConfig, mesh):
    """This rank's stage of ``params`` on its device: its layers (cut over
    the model group too when mesh.model > 1, as ``serving.shard_llama_params``
    cuts them) and the top-level tensors."""
    from tpu_llm_torch.parallel.serving import shard_llama_params

    own = stage_layers(cfg, mesh)
    return shard_llama_params(dict(params, layers=params["layers"][own.start:own.stop]),
                              cfg, mesh)


def init_stage_cache(cfg: LlamaConfig, mesh, batch: int, max_seq: int,
                     dtype=torch.float32):
    """This rank's KV planes: one (batch / dp, max_seq, Hkv / tp * D) pair a
    layer of its stage."""
    from tpu_llm_torch.parallel.sharding import llama_cache_spec

    shape = llama_cache_spec(cfg, mesh, batch, max_seq)["kv"]
    n = len(stage_layers(cfg, mesh))
    mk = lambda: torch.zeros(shape, dtype=dtype, device=mesh.device)  # noqa: E731
    return {"k": [mk() for _ in range(n)], "v": [mk() for _ in range(n)]}


def _hidden_dtype(params) -> torch.dtype:
    """The residual stream's dtype between layers: the embedding's,
    widened to f32 where the layers add f32 biases to it."""
    lp = params["layers"][0]
    dt = params["tok_emb"].dtype
    return torch.promote_types(dt, torch.float32) if "bo" in lp or "b2" in lp else dt


def _stage(params, cfg: LlamaConfig, mesh, tokens: torch.Tensor, cache, offset: int):
    """Receive the rows (or embed ``tokens`` on stage 0), run this stage's
    layers at [offset, offset + T), send them on; returns them."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.serving import _tp_local_cfg

    s, g = mesh.pipe_index, mesh.pipe_group
    B, T = tokens.shape
    if s == 0:
        x = M.embed(params, cfg, tokens)
    else:
        x = mesh.recv((B, T, cfg.dim), _hidden_dtype(params), s - 1, g)
    tp = mesh.model
    x = M.run_layers(params["layers"], _tp_local_cfg(cfg, tp), x, cache["k"], cache["v"],
                     M.positions_for(offset, B, T, x.device), offset,
                     reduce_fn=mesh.reduce_model if tp > 1 else None)
    if s < mesh.pipe - 1:
        mesh.send(x, s + 1, g)
    return x


def _from_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """The last stage's ``x`` on every stage (``x`` gives the shape and
    dtype elsewhere)."""
    last = mesh.pipe - 1
    buf = x if mesh.pipe_index == last else torch.empty_like(x)
    return mesh.broadcast(buf, last, mesh.pipe_group)


def decode_step_pipelined(params, cfg: LlamaConfig, token: torch.Tensor, cache, pos: int,
                          mesh) -> Tuple[torch.Tensor, dict]:
    """One pipelined decode step: token (B,) this rank's batch rows at the
    int position ``pos``, over its stage's params (``stage_params``) and
    cache (``init_stage_cache``). Returns ((B, V) f32 logits, cache) on
    every stage, the single-rank ``decode_step``'s."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.serving import _tp_local_cfg

    _check(cfg, mesh)
    x = _from_last(_stage(params, cfg, mesh, token[:, None], cache, pos), mesh)
    lcfg = _tp_local_cfg(cfg, mesh.model)
    x = M.apply_final_norm(params, lcfg, x)
    return M.lm_head(params, lcfg, x, gather_fn=mesh.gather_model)[:, 0, :], cache


def decode_step_pp_tp(params, cfg: LlamaConfig, token: torch.Tensor, cache, pos: int,
                      mesh) -> Tuple[torch.Tensor, dict]:
    """PP x TP decode step: ``decode_step_pipelined`` on a (pipe, data,
    model) mesh, each stage's layers and the classifier cut over the model
    group (``stage_params``; the cache from ``init_stage_cache``)."""
    _check(cfg, mesh)
    tp = mesh.model
    if cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.hidden_dim % tp:
        raise ValueError(f"tp={tp} must divide n_heads={cfg.n_heads}, "
                         f"n_kv_heads={cfg.n_kv_heads} and hidden_dim={cfg.hidden_dim}")
    return decode_step_pipelined(params, cfg, token, cache, pos, mesh)


def prefill_pipelined(params, cfg: LlamaConfig, tokens: torch.Tensor, cache, mesh,
                      microbatches: int = 0) -> Tuple[torch.Tensor, dict]:
    """Pipelined prefill from position 0 over ``microbatches`` sequence
    chunks (0: one a stage). tokens (B, T): this rank's batch rows.
    Returns (final-normed hidden (B, T, E) on every stage, cache), the
    single-rank ``forward``'s."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.serving import _tp_local_cfg

    _check(cfg, mesh)
    B, T = tokens.shape
    nmb = microbatches or mesh.pipe
    if T % nmb:
        raise ValueError(f"T={T} not divisible by microbatches={nmb}")
    C = T // nmb
    chunks = [_stage(params, cfg, mesh, tokens[:, c * C:(c + 1) * C], cache, c * C)
              for c in range(nmb)]
    hidden = _from_last(torch.cat(chunks, 1), mesh)
    return M.apply_final_norm(params, _tp_local_cfg(cfg, mesh.model), hidden), cache
