"""LoRA adapters in llama.cpp's GGUF adapter format (``tpu_llm/io/lora.py``).

Adapters exported by ``convert_lora_to_gguf.py`` are GGUF files with
``general.type = "adapter"``, ``adapter.type = "lora"``,
``adapter.lora.alpha`` and, per base tensor, the pair ``<name>.lora_a`` /
``<name>.lora_b``. The merged delta of a base weight is
``(B @ A) * alpha / r`` with A (r, in) and B (out, r) in numpy
(reversed-ggml) shapes: the chain ``B @ (A @ x)`` collapsed.

The merge happens at load time against the port's UNFUSED per-layer
parameter list (load with ``fuse=False``, fuse after merging). Dense
weights take the delta exactly (in f32, rounded to their dtype once);
a packed ``QTensor`` is dequantized, merged and requantized to its kind
with ``quantize_tensor`` (the standard merge-into-quantized trade-off).
An adapter tensor that matches no parameter raises: silently dropping
trained deltas would be a correctness trap. The embedding table
(``token_embd.weight``, stored (V, E) as gathered, not as x @ W) takes
the delta in its own orientation.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import numpy as np
import torch

# GGUF base-tensor name -> per-layer key, or a top-level key
_LAYER_KEYS = {
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_gate.weight": "w1",
    "ffn_up.weight": "w3",
    "ffn_down.weight": "w2",
}
_TOP_KEYS = {
    "output.weight": "wcls",
    "token_embd.weight": "tok_emb",
}


def read_lora(path: str) -> Tuple[Dict[str, np.ndarray], float]:
    """An adapter GGUF -> ({base tensor name: delta (out, in)}, alpha),
    each delta already scaled by alpha / r (1 without an alpha)."""
    from tpu_llm_torch.io.gguf import GGUFFile

    g = GGUFFile(path)
    gtype = g.metadata.get("general.type")
    atype = g.metadata.get("adapter.type")
    if gtype not in (None, "adapter") or atype not in (None, "lora"):
        raise ValueError(f"{path}: not a LoRA adapter GGUF "
                         f"(general.type={gtype!r}, adapter.type={atype!r})")
    alpha = float(g.metadata.get("adapter.lora.alpha", 0.0))
    pairs: Dict[str, Dict[str, np.ndarray]] = {}
    for name in g.tensors:
        for suffix in (".lora_a", ".lora_b"):
            if name.endswith(suffix):
                pairs.setdefault(name[:-len(suffix)], {})[suffix[1:]] = \
                    g.dequantized(name, np.float32)
    deltas: Dict[str, np.ndarray] = {}
    for base, ab in pairs.items():
        if "lora_a" not in ab or "lora_b" not in ab:
            raise ValueError(f"{path}: incomplete LoRA pair for {base!r}")
        a, b = ab["lora_a"], ab["lora_b"]           # (r, in), (out, r)
        r = a.shape[0]
        if b.shape[-1] != r:
            raise ValueError(f"{path}: rank mismatch for {base!r}: A {a.shape} B {b.shape}")
        deltas[base] = (b @ a) * ((alpha / r) if alpha > 0 else 1.0)   # (out, in)
    if not deltas:
        raise ValueError(f"{path}: no .lora_a/.lora_b tensor pairs")
    return deltas, alpha


def _merge(w, delta: np.ndarray):
    """``w`` + ``delta`` (w's orientation): a dense tensor in f32 rounded to
    its dtype, a QTensor dequantized, merged and requantized to its kind."""
    from tpu_llm_torch.quant.qtensor import QTensor, dequantize, quantize_tensor

    if isinstance(w, QTensor):
        dense = dequantize(w, torch.float32).cpu().numpy()
        return quantize_tensor((dense + delta).astype(np.float32), w.kind, device=w.device)
    return (w.float() + torch.from_numpy(delta).to(w.device)).to(w.dtype)


def apply_lora(params: Dict, path: str, verbose: bool = False) -> Dict:
    """Merge a LoRA adapter into unfused per-layer llama params: a new
    params dict (the layer dicts copied); unmatched adapter tensors raise."""
    deltas, alpha = read_lora(path)
    layers = params["layers"]
    if not isinstance(layers, (list, tuple)):
        raise ValueError("apply_lora needs the per-layer params list")
    if any("wqkv" in lp or "w13" in lp for lp in layers):
        raise ValueError("apply_lora needs unfused params (load with fuse=False, "
                         "fuse after merging)")
    out = dict(params)
    new_layers = [dict(lp) for lp in layers]
    for base, delta in deltas.items():
        if base in _TOP_KEYS:
            key = _TOP_KEYS[base]
            if out.get(key) is None:
                raise ValueError(f"adapter targets {base!r} but the model has no such tensor")
            d = delta if key == "tok_emb" else np.ascontiguousarray(delta.T)
            out[key] = _merge(out[key], d)
            continue
        if not base.startswith("blk."):
            raise ValueError(f"unsupported LoRA target {base!r}")
        _, idx, rest = base.split(".", 2)
        key = _LAYER_KEYS.get(rest)
        i = int(idx)
        if key is None or i >= len(new_layers) or key not in new_layers[i]:
            raise ValueError(f"unsupported LoRA target {base!r}")
        # the delta arrives (out, in); the weights are x @ W-oriented (in, out)
        new_layers[i][key] = _merge(new_layers[i][key], np.ascontiguousarray(delta.T))
    out["layers"] = new_layers
    if verbose:
        print(f"lora: merged {len(deltas)} tensors (alpha={alpha})", file=sys.stderr)
    return out
