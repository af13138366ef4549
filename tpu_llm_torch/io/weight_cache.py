"""Fast-reload weight cache (the port of ``tpu_llm/io/weight_cache.py``,
in its format: a cache written by either package loads in both).

After one GGUF parse and repack (dtype policy applied, quants in the
device layout), the finished parameter tree is kept as one ``.npz`` and
reloaded with no GGUF parsing.

Format: numpy .npz (zip of .npy). Tree paths become array names
("layers.0.wqkv.q"); a QTensor leaf stores its q / scales (/ mins) planes
under its path and its kind in the meta; a "__meta__" JSON entry carries
the magic, the LlamaConfig and the tree hints: ``lists`` (path -> length
of a list node: the port's per-layer list), ``nones`` (paths of None
leaves), ``qtensors`` (path -> kind) and ``bf16`` (array names stored as
uint16 bits; numpy has no bfloat16).

The JAX package's caches hold stacked layers (a dict of (L, ...) arrays,
QTensor planes with a leading L axis) or, from its unstacked trees, a
per-layer list; both load here as the port's per-layer list, the planes
unchanged (``qtensor_from_numpy``), q|k|v and gate|up fused.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.quant.convert_params import fuse_llama_layers
from tpu_llm_torch.quant.qtensor import QTensor, plane_from_numpy, qtensor_from_numpy

MAGIC = "tpu_llm-weight-cache-v1"


def _store(key: str, t: torch.Tensor, out: Dict[str, Any], meta: Dict[str, Any]):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        meta.setdefault("bf16", []).append(key)
        t = t.view(torch.int16)
        out[key] = t.numpy().view(np.uint16)
        return
    out[key] = t.numpy()


def _flatten(prefix: str, node: Any, out: Dict[str, Any], meta: Dict[str, Any]):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}{k}.", v, out, meta)
        return
    if isinstance(node, (list, tuple)):
        meta.setdefault("lists", {})[prefix.rstrip(".")] = len(node)
        for i, v in enumerate(node):
            _flatten(f"{prefix}{i}.", v, out, meta)
        return
    key = prefix.rstrip(".")
    if node is None:
        meta.setdefault("nones", []).append(key)
        return
    if isinstance(node, QTensor):
        meta.setdefault("qtensors", {})[key] = node.kind
        _store(f"{key}.q", node.q, out, meta)
        _store(f"{key}.scales", node.scales, out, meta)
        if node.mins is not None:
            _store(f"{key}.mins", node.mins, out, meta)
        return
    _store(key, node, out, meta)


def save_weight_cache(path: str, params: Any, cfg: LlamaConfig):
    arrays: Dict[str, Any] = {}
    meta: Dict[str, Any] = {"magic": MAGIC, "config": dataclasses.asdict(cfg)}
    _flatten("", params, arrays, meta)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_weight_cache(path: str, device="cpu") -> Tuple[Any, LlamaConfig]:
    """-> (params, cfg): the port's parameters on ``device``, in the layout
    ``llama.load_gguf`` makes: unfused q|k|v and gate|up (as ``llm-load``
    writes them without --fuse) are concatenated, so the kernels run the
    launches and plans of the GGUF path."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        if meta.get("magic") != MAGIC:
            raise ValueError(f"not a tpu_llm weight cache: {path}")
        cfg = LlamaConfig(**meta["config"])
        bf16 = set(meta.get("bf16", []))
        qkinds = meta.get("qtensors", {})
        names = [n for n in z.files if n != "__meta__"]

        def arr(key):
            a = z[key]
            if key in bf16:
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
            return a

        tree: Dict[str, Any] = {}

        def insert(key: str, value):
            parts = key.split(".")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

        for q, kind in qkinds.items():
            insert(q, qtensor_from_numpy(arr(f"{q}.q"), arr(f"{q}.scales"), kind,
                                         arr(f"{q}.mins") if f"{q}.mins" in names else None,
                                         device))
        planes = {f"{q}.{p}" for q in qkinds for p in ("q", "scales", "mins")}
        for name in names:
            if name not in planes:
                a = arr(name)
                insert(name, a if isinstance(a, torch.Tensor) else plane_from_numpy(a, device))
    for key in meta.get("nones", []):
        insert(key, None)

    def fix_lists(node, prefix: str):
        for k, v in list(node.items()):
            if isinstance(v, dict):
                full = f"{prefix}{k}"
                fix_lists(v, full + ".")
                if full in meta.get("lists", {}):
                    node[k] = [v[str(i)] for i in range(meta["lists"][full])]
        return node

    params = fix_lists(tree, "")
    if isinstance(params["layers"], dict):
        params["layers"] = _unstack(params["layers"])
    params["layers"] = fuse_llama_layers(params["layers"])
    return params, cfg


def _unstack(layers: Dict[str, Any]) -> list:
    """Stacked (L, ...) layer leaves -> one dict a layer (views)."""
    def index(v, i):
        if isinstance(v, QTensor):
            return QTensor(v.q[i], v.scales[i], v.kind,
                           None if v.mins is None else v.mins[i])
        return None if v is None else v[i]

    first = next(v for v in layers.values() if v is not None)
    n = (first.q if isinstance(first, QTensor) else first).shape[0]
    return [{k: index(v, i) for k, v in layers.items()} for i in range(n)]
