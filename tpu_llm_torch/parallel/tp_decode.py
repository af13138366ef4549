"""Explicit tensor-parallel decode step (``tpu_llm/parallel/tp_decode.py``).

Each rank holds its shard of the per-layer weights and of the KV cache
and runs the llama decode step at LOCAL shapes: every projection is K1
on the rank's columns or rows, every attention K2 / K3 on its heads.
The collectives are explicit and Megatron-placed: one all-reduce after
``wo``, one after ``w2`` (two a layer) and one tiled gather of the
(B, V / tp) logits.

Layout (tp = the mesh's model size, tp | n_kv_heads):
  wq / wk / wv column-parallel -> local heads H / tp, kv heads Hkv / tp;
  wo row-parallel; w1 / w3 column-parallel; w2 row-parallel;
  KV cache flat (B / dp, S, Hkv / tp * D) local planes; wcls (E, V / tp).

Fused QKV / gate-up layouts compose with TP after a one-time column
permutation (``repack_fused_for_tp``): shard s owns columns
[q_s | k_s | v_s] (and [w1_s | w3_s]), so the fused projection stays one
K1 call a layer a shard and the in-shard split recovers q / k / v.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.parallel.sharding import COL, ROW, shard_params
from tpu_llm_torch.quant.qtensor import QTensor, qmap


def _gather_cols(w, idx: np.ndarray):
    """Permute the output (N) axis of a dense or QTensor weight (or a
    fused bias)."""
    idx = torch.from_numpy(idx).to(w.device)
    if isinstance(w, QTensor):
        return qmap(lambda p: p.index_select(-1, idx), w)
    return w.index_select(-1, idx)


def repack_fused_for_tp(layers, cfg: LlamaConfig, tp: int):
    """Permute fused wqkv / bqkv / w13 columns so each TP shard's column
    block is [q_s | k_s | v_s] (and [w1_s | w3_s]). Run once at load."""
    E, KV, F = cfg.q_dim, cfg.kv_dim, cfg.hidden_dim
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    assert F % tp == 0

    def seg(start, size, parts):
        return np.split(np.arange(start, start + size), parts)

    qs, ks, vs = seg(0, E, tp), seg(E, KV, tp), seg(E + KV, KV, tp)
    qkv_idx = np.concatenate([np.concatenate([qs[s], ks[s], vs[s]]) for s in range(tp)])
    w1s, w3s = seg(0, F, tp), seg(F, F, tp)
    w13_idx = np.concatenate([np.concatenate([w1s[s], w3s[s]]) for s in range(tp)])

    def one(lp):
        out = dict(lp)
        for key, idx in (("wqkv", qkv_idx), ("bqkv", qkv_idx), ("w13", w13_idx)):
            if key in lp:
                out[key] = _gather_cols(lp[key], idx)
        return out

    return [one(lp) for lp in layers]


def tp_param_specs(layers_keys, fused: bool) -> Dict[str, Any]:
    """The per-layer spec dict of the explicit TP step (one dict for every
    layer)."""
    specs = {"attn_norm": None, "ffn_norm": None, "wo": ROW, "w2": ROW}
    if fused:
        specs.update(wqkv=COL, w13=COL)
    else:
        specs.update(wq=COL, wk=COL, wv=COL, w1=COL, w3=COL)
    unsupported = [k for k in layers_keys if k not in specs]
    if unsupported:
        raise NotImplementedError(
            f"the explicit TP decode step takes the unbiased llama layout; "
            f"layer params {unsupported} (biased / phi-2 families) shard through "
            f"the serving adapter (parallel.sharding.llama_param_specs)")
    return {k: specs[k] for k in layers_keys}


def make_tp_decode_step(cfg: LlamaConfig, mesh):
    """step(params, token (B / dp,), cache, pos) -> (logits (B / dp, V)
    f32, cache), on this rank's shards (``shard_tp_params``, fused or
    not, and ``init_tp_cache``); the cache planes are written in place.
    ``pos`` an int or a one-element device tensor (a captured step)."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.serving import _tp_local_cfg

    tp = mesh.model
    assert cfg.n_heads % tp == 0, (cfg.n_heads, tp)
    assert cfg.n_kv_heads % tp == 0, \
        f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} (head-aligned TP)"
    assert cfg.hidden_dim % tp == 0 and cfg.vocab_size % tp == 0
    lcfg = _tp_local_cfg(cfg, tp)

    def step(params, token, cache, pos):
        x, cache = M.forward(params, lcfg, token[:, None], cache, pos,
                             reduce_fn=mesh.reduce_model)
        return M.lm_head(params, lcfg, x, gather_fn=mesh.gather_model)[:, 0, :], cache

    return step


def shard_tp_params(params, cfg: LlamaConfig, mesh, fused: bool = False):
    """This rank's shards of per-layer params under the TP layout (the
    module docstring's specs). Fused layouts must already be repacked
    with ``repack_fused_for_tp``."""
    layers = params["layers"]
    lspec = tp_param_specs(tuple(layers[0].keys()), fused)
    specs = {"tok_emb": None, "final_norm": None, "wcls": COL, "layers": lspec}
    return shard_params({k: params[k] for k in ("tok_emb", "final_norm", "wcls", "layers")},
                        specs, mesh)


def init_tp_cache(cfg: LlamaConfig, mesh, batch: int, max_seq: int, dtype=torch.bfloat16):
    """This rank's flat KV planes: (batch / dp, max_seq, Hkv / tp * D)."""
    from tpu_llm_torch.parallel.sharding import llama_cache_spec

    shape = llama_cache_spec(cfg, mesh, batch, max_seq)["kv"]
    mk = lambda: torch.zeros(shape, dtype=dtype, device=mesh.device)  # noqa: E731
    return {"k": [mk() for _ in range(cfg.n_layers)],
            "v": [mk() for _ in range(cfg.n_layers)]}
