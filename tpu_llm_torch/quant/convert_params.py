"""Parameter transforms (``tpu_llm/quant/convert_params.py``): quantize
dense projections to packed QTensors, fuse q|k|v and gate|up, and fold the
interleaved-RoPE pairing into the wq/wk columns.

Parameters are a dict: ``tok_emb``, ``final_norm``, ``wcls`` (QTensor,
tensor or None for tied embeddings) and ``layers``, a list of per-layer
dicts (the port always runs the per-layer loop).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from tpu_llm_torch.quant.qtensor import QTensor, quantize_tensor

LLAMA_PROJ_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _map_planes(fn, *ws):
    """Apply ``fn`` to dense tensors, or to each plane of same-kind
    QTensors (q and scales share the N-axis layout)."""
    if isinstance(ws[0], QTensor):
        return QTensor(fn(*[w.q for w in ws]), fn(*[w.scales for w in ws]),
                       ws[0].kind)
    return fn(*ws)


def quantize_llama_params(params: Dict, kind: str = "q4_0",
                          layer_keys: Sequence[str] = LLAMA_PROJ_KEYS,
                          quantize_cls: bool = True, fuse: bool = False) -> Dict:
    """Replace dense projection weights with packed QTensors on the same
    device. Norms and the embedding stay dense."""
    def q(w):
        if isinstance(w, QTensor):
            return w
        return quantize_tensor(w.float().cpu().numpy(), kind, device=w.device)

    out = dict(params)
    out["layers"] = [{k: (q(v) if k in layer_keys else v) for k, v in lp.items()}
                     for lp in params["layers"]]
    if quantize_cls and params.get("wcls") is not None:
        out["wcls"] = q(params["wcls"])
    if fuse:
        out["layers"] = fuse_llama_layers(out["layers"])
    return out


def fuse_llama_layers(layers: List[Dict]) -> List[Dict]:
    """wq|wk|wv -> wqkv, w1|w3 -> w13, concatenated along the output (N)
    axis — packing is per column, so QTensor planes concatenate directly."""
    cat = lambda *ws: _map_planes(lambda *ps: torch.cat(ps, dim=-1), *ws)  # noqa: E731
    out = []
    for lp in layers:
        lp = dict(lp)
        if "wq" in lp:
            lp["wqkv"] = cat(lp.pop("wq"), lp.pop("wk"), lp.pop("wv"))
        if "w1" in lp:
            lp["w13"] = cat(lp.pop("w1"), lp.pop("w3"))
        out.append(lp)
    return out


def fold_rope_interleave(params: Dict, cfg):
    """Fold the interleaved-RoPE pairing into the wq/wk column order.

    Permuting each head's wq/wk output columns to [evens, odds] makes the
    interleaved rotation the neox half-split form with the same angles;
    q.k is invariant under the shared permutation and v/wo are untouched,
    so logits are unchanged up to f32 summation order. Cache contents
    become head-dim-permuted. Returns (params', cfg') with
    cfg'.rope_variant == "neox"; a no-op for other variants."""
    if cfg.rope_variant != "interleaved":
        return params, cfg
    D = cfg.head_dim
    base = np.concatenate([np.arange(0, D, 2), np.arange(1, D, 2)])

    def head_perm(n_heads):
        return (np.arange(n_heads)[:, None] * D + base[None, :]).reshape(-1)

    qperm, kperm = head_perm(cfg.n_heads), head_perm(cfg.n_kv_heads)
    E, KV = cfg.q_dim, cfg.kv_dim

    def permute(w, perm):
        idx = torch.as_tensor(perm, dtype=torch.long)
        return _map_planes(lambda p: p.index_select(-1, idx.to(p.device)), w)

    def fold_layer(lp):
        lp = dict(lp)
        if "wqkv" in lp:
            full = np.concatenate([qperm, E + kperm, E + KV + np.arange(KV)])
            lp["wqkv"] = permute(lp["wqkv"], full)
        else:
            lp["wq"] = permute(lp["wq"], qperm)
            lp["wk"] = permute(lp["wk"], kperm)
        return lp

    out = dict(params)
    out["layers"] = [fold_layer(lp) for lp in params["layers"]]
    return out, dataclasses.replace(cfg, rope_variant="neox")
