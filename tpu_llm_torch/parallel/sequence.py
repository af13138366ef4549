"""Sequence parallelism (SP) for prefill: Megatron-SP over the tensor-parallel
ranks (``tpu_llm/parallel/sequence.py``).

Under plain tensor parallelism the residual stream is replicated: every
rank runs the norms and residual adds over every row. SP holds it as each
rank's (B, T / tp, E) rows of the sequence instead, so those run over
1/tp of the rows, and moves the collectives to where Megatron-LM puts
them: each norm's output is gathered to every row before the
column-parallel projections (wq / wk / wv, w1 / w3: the rank's heads and
ffn columns over the whole sequence), and the row-parallel outputs (wo,
w2) are reduce-scattered, each rank keeping the sum over its own rows,
where TP all-reduces them. A layer moves two gathers and two
reduce-scatters against TP's two all-reduces.

The JAX package expresses this as a sharding constraint on the residual
stream (``sp_constraint``) and lets XLA place the collectives. The port
has no counterpart of that function: the hooks of
``models.llama.run_layers`` (``seq_gather``, and ``reduce_fn`` as the
reduce-scatter) are the mechanism.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tpu_llm_torch.config import LlamaConfig


def prefill_sequence_parallel(params, cfg: LlamaConfig, tokens: torch.Tensor, cache,
                              mesh) -> Tuple[torch.Tensor, dict]:
    """Sequence-parallel llama prefill from position 0. params: this rank's
    TP shards (``serving.shard_llama_params``); cache: its TP planes
    (``tp_decode.init_tp_cache``); tokens (B, T): this rank's batch rows
    (``sharding.data_rows``), the whole sequence, T divisible by tp.
    Returns (this rank's final-normed hidden rows (B, T / tp, E), cache):
    the ranks' rows, tiled in model-rank order, are the single-rank
    prefill's."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.ring import _check_seq
    from tpu_llm_torch.parallel.serving import _tp_local_cfg

    B, T = tokens.shape
    Tl = _check_seq(T, mesh.model)
    lcfg = _tp_local_cfg(cfg, mesh.model)
    first = mesh.model_index * Tl
    x = M.embed(params, lcfg, tokens[:, first:first + Tl])
    x = M.run_layers(params["layers"], lcfg, x, cache["k"], cache["v"],
                     M.positions_for(0, B, T, x.device), 0,
                     reduce_fn=lambda y: mesh.reduce_scatter_model(y, 1),
                     seq_gather=lambda y: mesh.gather_model(y, 1))
    return M.apply_final_norm(params, lcfg, x), cache
