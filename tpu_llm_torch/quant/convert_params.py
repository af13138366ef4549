"""Parameter transforms (``tpu_llm/quant/convert_params.py``): quantize
dense projections to packed QTensors, fuse q|k|v and gate|up, fold the
interleaved-RoPE pairing into the wq/wk columns, fold the rmsnorm
weights into the projections that follow them (``--fold-norms``), and
turn the q4 family into the ``--scan`` program's int4-plane weights
(``unpack_params_int4``).

Parameters are a dict: ``tok_emb``, ``final_norm``, ``wcls`` (QTensor,
tensor or None for tied embeddings) and ``layers``, a list of per-layer
dicts (the port always runs the per-layer loop).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from tpu_llm_torch.quant.qtensor import (QTensor, dequantize, pack_q6_k,
                                         pack_scales_bf16, pack_scales_f16, qmap,
                                         quantize_tensor, to_int4)

LLAMA_PROJ_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _map_planes(fn, *ws):
    """Apply ``fn`` to dense tensors, or to each plane of same-kind
    QTensors (q, scales and mins share the N-axis layout; so does q6_kp's
    qh plane in the mins slot)."""
    if isinstance(ws[0], QTensor):
        return qmap(fn, *ws)
    return fn(*ws)


def _concat_n(names, ws):
    """Concatenate weights along the output (N) axis. QTensors must share
    one kind and plane dtype: the JAX package cannot fuse (or stack) mixed
    kinds either, so a file that mixes them under one fused projection is
    refused by name."""
    if any(isinstance(w, QTensor) for w in ws):
        sig = [(w.kind, w.scales.dtype) if isinstance(w, QTensor) else ("dense", w.dtype)
               for w in ws]
        if len(set(sig)) > 1:
            raise ValueError(
                "cannot fuse projections of mixed kinds: " + ", ".join(
                    f"{n} is {k} ({str(d).replace('torch.', '')})"
                    for n, (k, d) in zip(names, sig)))
    return _map_planes(lambda *ps: torch.cat(ps, dim=-1), *ws)


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


def unpack_params_int4(params: Dict, pack_scales=False) -> Dict:
    """The decode weight transform of the ``--scan`` program: every 2-D
    q4_0 / q4_1 / q2_kp / q3_kp QTensor -> q4_0i4 (``qtensor.to_int4``;
    the value planes are shared where the bytes do not change, so the
    original parameters stay usable for prefill at no extra memory).

    ``pack_scales`` halves the scale (and mins) bytes of the q4_0i4
    results only: "f16" (or True) -> f16 bits in int16 planes (exact for
    f16-valued scales), "bf16" -> bf16 planes; q8_0 and the other kinds
    keep their planes, as in the JAX package. Its K padding for TPU tile
    sizes (``maybe_pad_k``) is not copied: K-padded weights carried across
    still run (``quant/linear.py`` pads x)."""
    if pack_scales not in (False, None, True, "f16", "bf16"):
        raise ValueError(f"pack_scales={pack_scales!r}")

    def leaf(w):
        if not isinstance(w, QTensor) or w.q.ndim != 2:
            return w
        w = to_int4(w)
        if w.kind != "q4_0i4":
            return w
        if pack_scales in (True, "f16"):
            return pack_scales_f16(w)
        if pack_scales == "bf16":
            return pack_scales_bf16(w)
        return w

    out = {k: leaf(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: leaf(v) for k, v in lp.items()} for lp in params["layers"]]
    return out


def fuse_llama_layers(layers: List[Dict], name=lambda i, key: f"layer {i} {key}"
                      ) -> List[Dict]:
    """wq|wk|wv -> wqkv (and bq|bk|bv -> bqkv), w1|w3 -> w13, concatenated
    along the output (N) axis — packing is per column, so QTensor planes
    concatenate directly. The JAX package leaves biased layers unfused;
    here the biases fuse with their projection (a bias add commutes with
    the split). Stacked expert planes (w1e, w3e, w2e) stay as they are.
    ``name(i, key)`` names a tensor in the error for mixed kinds."""
    out = []
    for i, lp in enumerate(layers):
        lp = dict(lp)
        for fused, parts in (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3"))):
            if parts[0] in lp:
                lp[fused] = _concat_n([name(i, p) for p in parts],
                                      [lp.pop(p) for p in parts])
        if "bq" in lp and "wqkv" in lp:
            lp["bqkv"] = torch.cat([lp.pop("bq"), lp.pop("bk"), lp.pop("bv")])
        out.append(lp)
    return out


def fold_rope_interleave(params: Dict, cfg):
    """Fold the interleaved-RoPE pairing into the wq/wk column order.

    Permuting each head's wq/wk output columns to [evens, odds] makes the
    interleaved rotation the neox half-split form with the same angles;
    q.k is invariant under the shared permutation and v/wo are untouched,
    so logits are unchanged up to f32 summation order. Cache contents
    become head-dim-permuted. Returns (params', cfg') with
    cfg'.rope_variant == "neox"; a no-op for other variants and for
    partial RoPE. Biases (bqkv, or bq / bk) take the same permutation."""
    if cfg.rope_variant != "interleaved" or cfg.rope_dims is not None:
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
            if "bqkv" in lp:
                lp["bqkv"] = permute(lp["bqkv"], full)
        else:
            lp["wq"] = permute(lp["wq"], qperm)
            lp["wk"] = permute(lp["wk"], kperm)
            if "bq" in lp:
                lp["bq"] = permute(lp["bq"], qperm)
                lp["bk"] = permute(lp["bk"], kperm)
        return lp

    out = dict(params)
    out["layers"] = [fold_layer(lp) for lp in params["layers"]]
    return out, dataclasses.replace(cfg, rope_variant="neox")


# the codec that requantizes each device kind (the JAX package's map)
_REQUANT_KIND = {"q4_0": "q4_0", "q8_0": "q8_0", "q4_1": "q4_1", "q5_0": "q5_0",
                 "q5_1": "q5_1", "q2_k": "q2_k", "q2_kp": "q2_k", "q3_k": "q3_k",
                 "q3_kp": "q3_k", "q6_k": "q6_k", "q6_kp": "q6_k"}


def _requant_row_scaled(qt: QTensor, w: np.ndarray) -> QTensor:
    """diag(w) @ dequantize(qt), requantized in qt's own kind: one extra
    quantization rounding."""
    kind = _REQUANT_KIND.get(qt.kind)
    if kind is None:
        raise NotImplementedError(f"norm fold for kind {qt.kind}")
    dense = dequantize(qt, torch.float32).cpu().numpy()
    out = quantize_tensor(dense * w[:, None], kind, device=qt.device)
    if qt.kind == "q6_kp" and out.kind == "q6_k":
        out = pack_q6_k(out)
    return out


def fold_norms_requant(params: Dict, cfg) -> Dict:
    """Fold the per-layer rmsnorm weights into the projections that follow
    them: rmsnorm(x, w) @ W == rmsnorm(x, None) @ (diag(w) W). Dense weights
    fold exactly; QTensors are dequantized, row-scaled and requantized in
    their own kind (one extra rounding: ``llm --fold-norms`` opts in). The
    folded norm entries become None (a weightless rmsnorm); final_norm
    folds into an untied classifier. The rmsnorm llama family only: no
    LayerNorm, no parallel block's shared norm, no MoE router."""
    if cfg.use_layernorm or cfg.parallel_block or cfg.n_experts:
        raise NotImplementedError("norm folding supports the rmsnorm llama family")
    def fold_into(w, weight):
        nw = w.float().cpu().numpy()
        if isinstance(weight, QTensor):
            return _requant_row_scaled(weight, nw)
        return (weight.float() * w.float()[:, None]).to(weight.dtype)

    def fold_layer(lp):
        out = dict(lp)
        for norm, keys in (("attn_norm", ("wqkv", "wq", "wk", "wv")),
                           ("ffn_norm", ("w13", "w1", "w3"))):
            for k in keys:
                if k in out:
                    out[k] = fold_into(lp[norm], out[k])
            out[norm] = None
        return out

    out = dict(params)
    out["layers"] = [fold_layer(lp) for lp in params["layers"]]
    if params.get("wcls") is not None and params.get("final_norm") is not None:
        out["wcls"] = fold_into(params["final_norm"], params["wcls"])
        out["final_norm"] = None
    return out
