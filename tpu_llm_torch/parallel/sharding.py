"""Sharding specs for the llama parameters and KV state
(``tpu_llm/parallel/sharding.py``), as data for the port's ranks.

Megatron-style tensor parallelism over the mesh's "model" axis:

- attention: wq / wk / wv (and qwen2's bq / bk / bv) split on their output
  axis (heads), wo on its input axis (the all-reduce follows it);
- MLP: w1 / w3 (and phi-2's b3) on their output axis, w2 on its input
  axis (the all-reduce follows it); Mixtral-style experts w1e / w3e / w2e
  the same way inside each expert (the JAX "expert" axis stays 1, as every
  JAX CLI builds it), the router replicated;
- classifier: ``wcls`` / ``bcls`` on the vocab axis, the logits gathered;
- norms, ``bo``, ``b2`` and ``tok_emb`` replicated.

A spec is ``COL`` (split the last axis, N), ``ROW`` (split the axis
before it, K) or None (replicated); one per-layer dict serves every layer
of the port's per-layer list. Parameters are replicated over "data".
``shard_params`` cuts this rank's slice of every tensor. A ``QTensor`` is
cut plane by plane along the same logical axis (its q, scales and mins /
qh planes share N; along K each plane keeps its rows-per-weight-row
ratio), as ``shard_pytree`` places it; a K cut must land on whole quant
blocks (32 rows, 256 for the K-quant kinds), else ValueError names the
tensor.

``llama_cache_spec`` / ``llama_paged_state_spec`` give the LOCAL state
shapes a rank holds: the dense cache's batch / dp rows and kv heads / tp,
the paged pools' Hkv * D / tp columns. The int8 pools' scale planes are
replicated in the JAX package (their rows interleave blocks and heads);
here each rank holds the scales of its own kv heads, which are the same
numbers cut by head.
"""

from __future__ import annotations

from typing import Any, Dict

from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.quant.qtensor import QTensor, qmap

COL, ROW = "col", "row"        # split the output (last) / the input axis

# the K-quant kinds (their ggml super-blocks are 256 rows)
_KQUANT_KINDS = ("q2_k", "q2_kp", "q3_k", "q3_kp", "q6_k", "q6_kp")


def quant_block_rows(kind: str) -> int:
    """Rows a K cut of a ``kind`` QTensor must be a multiple of."""
    return 256 if kind in _KQUANT_KINDS else 32


def llama_param_specs(cfg: LlamaConfig, params=None, fused: bool = False) -> Dict[str, Any]:
    """The spec tree of the port's llama parameters (``layers``: one dict
    for every layer). ``params`` prunes it to the keys the model has and
    raises NotImplementedError for a layer key with no spec; ``fused``
    adds the fused wqkv / bqkv / w13, which shard as COL only after
    ``tp_decode.repack_fused_for_tp``."""
    layers: Dict[str, Any] = {"attn_norm": None, "ffn_norm": None,
                              "wq": COL, "wk": COL, "wv": COL, "wo": ROW,
                              "w1": COL, "w3": COL, "w2": ROW}
    specs: Dict[str, Any] = {"tok_emb": None, "final_norm": None, "wcls": COL,
                             "layers": layers}
    if cfg.n_experts:
        for k in ("w1", "w3", "w2"):
            layers.pop(k)
        layers.update(router=None, w1e=COL, w3e=COL, w2e=ROW)
    if cfg.use_layernorm:
        specs["final_norm_b"] = None
        layers["attn_norm_b"] = None
        if not cfg.parallel_block:
            layers["ffn_norm_b"] = None
    if cfg.use_bias:
        layers.update(bq=COL, bk=COL, bv=COL, bo=None, b3=COL, b2=None)
        specs["bcls"] = COL
    if cfg.parallel_block:
        layers.pop("ffn_norm", None)
    if fused:
        layers.update(wqkv=COL, bqkv=COL, w13=COL)
    if params is not None:
        keys = set(params["layers"][0].keys())
        specs["layers"] = {k: v for k, v in layers.items() if k in keys}
        missing = keys - set(specs["layers"])
        if missing:
            raise NotImplementedError(
                f"no TP sharding spec for layer params {sorted(missing)}")
        specs = {k: v for k, v in specs.items() if k == "layers" or k in params}
    return specs


def _cut(name: str, t, spec, tp: int, idx: int, device):
    """Rank ``idx`` of ``tp``'s slice of one tensor or QTensor."""
    if t is None:
        return None
    if spec is None or tp == 1:
        return qmap(lambda p: p.to(device), t) if isinstance(t, QTensor) else t.to(device)
    shape = t.shape
    axis = len(shape) - 1 if spec == COL or len(shape) == 1 else len(shape) - 2
    n = shape[axis]
    if n % tp:
        raise ValueError(f"{name}: axis {axis} of {tuple(shape)} does not split by tp={tp}")
    w = n // tp
    if isinstance(t, QTensor) and spec == ROW:
        block = quant_block_rows(t.kind)
        if w % block:
            raise ValueError(
                f"{name}: a {t.kind} K cut of {w} rows (K={n}, tp={tp}) is not a "
                f"multiple of the {t.kind} block ({block} rows)")

        def plane(p):
            rows = p.shape[-2] * w // n          # this plane's rows for w weight rows
            return p.narrow(-2, idx * rows, rows).contiguous().to(device)

        return qmap(plane, t)
    if isinstance(t, QTensor):
        return qmap(lambda p: p.narrow(-1, idx * w, w).contiguous().to(device), t)
    return t.narrow(axis, idx * w, w).contiguous().to(device)


def shard_params(params, specs, mesh) -> Dict[str, Any]:
    """This rank's slice of every parameter under ``specs``, on the
    mesh's device (the model axis's index picks the slice)."""
    tp, idx, dev = mesh.model, mesh.model_index, mesh.device
    out = {k: _cut(k, v, specs.get(k), tp, idx, dev)
           for k, v in params.items() if k != "layers"}
    lspec = specs["layers"]
    out["layers"] = [{k: _cut(f"layers[{i}].{k}", v, lspec.get(k), tp, idx, dev)
                      for k, v in lp.items()} for i, lp in enumerate(params["layers"])]
    return out


def data_rows(mesh, batch: int) -> slice:
    """The batch rows this rank holds: batch / dp of them by its data index
    where the batch divides by dp, else all of them (a batch-1 state is
    replicated over "data", as the JAX adapter runs it)."""
    dp = mesh.data
    if dp > 1 and batch >= dp and batch % dp == 0:
        b = batch // dp
        return slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    return slice(0, batch)


def llama_cache_spec(cfg: LlamaConfig, mesh, batch: int, max_seq: int,
                     quant: bool = False) -> Dict[str, tuple]:
    """The local dense-cache plane shapes: (batch / dp rows, S, Hkv / tp *
    D), and for the int8 cache the kv-head-major scales (B / dp, Hkv / tp,
    S). Rows split as ``data_rows`` splits them."""
    rows = data_rows(mesh, batch)
    b = rows.stop - rows.start
    hkv = cfg.n_kv_heads // mesh.model
    out = {"kv": (b, max_seq, hkv * cfg.head_dim)}
    if quant:
        out["scales"] = (b, hkv, max_seq)
    return out


def llama_paged_state_spec(cfg: LlamaConfig, mesh, n_blocks: int, block_size: int,
                           quantized: bool = False) -> Dict[str, tuple]:
    """The local paged-pool shapes: (n_blocks, block_size, Hkv * D / tp);
    the int8 scale pools over this rank's kv heads (ops/paged_kv.py's 2-D
    layout with Hkv / tp heads a block). Table and lengths are replicated
    host-driven metadata."""
    from tpu_llm_torch.ops.paged_kv import scale_pool_width, scale_rows_per_block

    hkv = cfg.n_kv_heads // mesh.model
    out = {"pool": (n_blocks, block_size, hkv * cfg.head_dim)}
    if quantized:
        out["scales"] = (n_blocks * scale_rows_per_block(hkv), scale_pool_width(block_size))
    return out
