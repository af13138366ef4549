"""Per-phase decode timing: the reference's five buckets
(``tpu_llm/runtime/phase_timing.py``), measured on the card.

The reference prints per-token averages of five wall-clock accumulators
at exit (``llama2.f90:403-410``: qkv, rope, attention, wo + ffn,
classifier). A decode step's phases cannot be timed in place without
serializing it, so each bucket runs as its own loop at the real decode
shapes with the real weights, all layers a step, slope-timed
(runtime/timing.py). On the card each bucket's step is captured in a CUDA
graph (runtime/graphs.py) and replayed n times, so the host's launch cost
does not enter the bucket; on the CPU the step runs eagerly.

Each phase's output feeds the next step's input through the ``_MIX``
carry, so no step's work is dead. Buckets are measured in isolation: their
sum can differ from the fused step's time, which tokens/second reports.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from tpu_llm_torch.config import LlamaConfig

BUCKETS = ("qkv", "rope", "attention", "ffn", "classifier")

# carry mixing factor: every phase output feeds the next step's input
# while the rmsnorm at each phase entry keeps magnitudes bounded
_MIX = 0.01


def _qkv_out(cfg: LlamaConfig, h, lp, rs):
    from tpu_llm_torch.quant.linear import matmul

    if "wqkv" in lp:
        out = matmul(h, lp["wqkv"], row_scale=rs)
        Q, KV = cfg.q_dim, cfg.kv_dim
        return out[..., :Q], out[..., Q:Q + KV], out[..., Q + KV:]
    return tuple(matmul(h, lp[n], row_scale=rs) for n in ("wq", "wk", "wv"))


def _phase_bodies(cfg: LlamaConfig, params, batch: int, positions: torch.Tensor):
    """[(bucket, body(carry) -> new carry)] at decode shapes; the
    attention bucket's carry is x, its caches are updated in place."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.ops.activations import silu
    from tpu_llm_torch.ops.attention import update_kv_cache
    from tpu_llm_torch.ops.rope import apply_rope
    from tpu_llm_torch.quant.linear import matmul

    B, E = batch, cfg.dim
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layers = params["layers"]

    # 1. qkv: attn-norm + QKV projection per layer (llama2.f90:527-538)
    def qkv_body(x, _):
        acc = x
        for lp in layers:
            h, rs = M._norm_folded(cfg, acc, lp, "attn")
            q, _k, _v = _qkv_out(cfg, h, lp, rs)
            acc = acc + _MIX * q
        return acc

    # 2. rope: rotate q and k per layer (llama2.f90:543-561)
    def rope_body(x, _):
        q = x.reshape(B, 1, H, D)
        for _lp in layers:
            qr = apply_rope(q, positions, cfg.rope_theta, cfg.rope_variant)
            kr = apply_rope(qr[:, :, :Hkv], positions, cfg.rope_theta, cfg.rope_variant)
            q = torch.cat([qr[:, :, :Hkv] + _MIX * kr, qr[:, :, Hkv:]], dim=2)
        return q.reshape(B, 1, E)

    # 3. attention: cache write + GQA decode attention per layer
    #    (llama2.f90:564-599)
    def attn_body(x, caches):
        q = x.reshape(B, 1, H, D)
        for kc, vc in caches:
            k = q[:, :, :Hkv]
            kc, vc = update_kv_cache(kc, vc, k, k, positions)
            q = q + _MIX * M._attend(q, kc, vc, positions.reshape(1, 1).expand(B, 1),
                                     positions)
        return q.reshape(B, 1, E)

    # 4. wo + ffn: output projection, residual, ffn-norm, gated MLP
    #    (llama2.f90:603-622)
    def ffn_body(x, _):
        acc = x
        for lp in layers:
            h = acc + matmul(acc, lp["wo"])
            m, rs = M._norm_folded(cfg, h, lp, "ffn")
            if "w13" in lp:
                F = cfg.hidden_dim
                h13 = matmul(m, lp["w13"], row_scale=rs)
                mid = silu(h13[..., :F]) * h13[..., F:]
            else:
                mid = silu(matmul(m, lp["w1"], row_scale=rs)) * matmul(m, lp["w3"], row_scale=rs)
            acc = _MIX * (h + matmul(mid, lp["w2"])) + x
        return acc

    # 5. classifier: final norm + full-vocab logits (llama2.f90:627-638)
    def cls_body(x, _):
        logits = M.lm_head(params, cfg, M.apply_final_norm(params, cfg, x))
        m = min(E, logits.shape[-1])
        mixed = x[..., :m] + (_MIX * torch.tanh(logits[..., :m])).to(x.dtype)
        return torch.cat([mixed, x[..., m:]], dim=-1)

    return [("qkv", qkv_body), ("rope", rope_body), ("attention", attn_body),
            ("ffn", ffn_body), ("classifier", cls_body)]


def measure_phase_times(
    params: Any,
    cfg: LlamaConfig,
    *,
    batch: int = 1,
    pos: int = 128,
    max_seq: int = 256,
    n1: int = 16,
    n2: int = 144,
    int4: bool = False,
) -> Dict[str, float]:
    """Per-token ms for each of the reference's five buckets at decode
    shapes (B x 1) with the loaded weights, attention at cache position
    ``pos``, on the weights' device. ``int4=True``
    converts the q4 family to int4-plane weights first (the graph loop's
    weights). Returns {bucket: ms_per_token}."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.graphs import CapturedStep
    from tpu_llm_torch.runtime.timing import slope_time_s

    if int4:
        from tpu_llm_torch.quant.convert_params import unpack_params_int4

        params = unpack_params_int4(params)
    emb = params["tok_emb"]
    dev = emb.device
    pos = min(pos, max_seq - 2)
    positions = torch.full((1,), pos, dtype=torch.int32, device=dev)
    cache = M.init_cache(cfg, batch, max_seq, dtype=emb.dtype, device=dev)
    caches = list(zip(cache["k"], cache["v"]))

    out = {}
    with torch.inference_mode():
        for name, body in _phase_bodies(cfg, params, batch, positions):
            carry = torch.full((batch, 1, cfg.dim), 0.02, dtype=emb.dtype, device=dev)

            def step(body=body, carry=carry):
                carry.copy_(body(carry, caches))

            captured = CapturedStep(step, dev, warmup=1)

            def make(n, captured=captured, carry=carry):
                def thunk():
                    for _ in range(n):
                        captured()
                    carry.reshape(-1)[0].item()          # sync by fetch
                return thunk

            out[name] = slope_time_s(make, n1, n2) * 1000.0
    return out


def format_report(phase_times: Dict[str, float]) -> str:
    """The reference's exit report shape (llama2.f90:407-410): bucket index
    + per-token average, one line each."""
    lines = [" Timings (ms/token, per-phase on-device)"]
    for i, name in enumerate(BUCKETS, start=1):
        lines.append(f" {i:4d}  {name:<11s}{phase_times.get(name, float('nan')):10.4f}")
    return "\n".join(lines)
