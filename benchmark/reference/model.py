"""The plain reference: a llama-family decoder (Qwen2, Mixtral) in float32
PyTorch, written from the models' published descriptions, one layer at a
time so that Mixtral's 29 GB of planes never lie dequantized at once.

It reads the benchmark's raw weights (``benchmark/weights.py``: q4_0 planes
and f32 / bf16 tensors) with its own q4_0 decoder, and token ids; it uses no
cache and no batching: every sequence runs whole, with causal attention.

Per layer: RMSNorm (eps inside the square root, then the weight) -> the
fused q|k|v projection (+ the f32 bias for Qwen2) -> RoPE (``neox``:
pairs (j, j + D/2); ``interleaved``: pairs (2j, 2j + 1); angle
pos * theta^(-2j/D)) -> grouped-query attention, softmax(q k / sqrt(D))
over positions <= the query's -> the output projection -> residual ->
RMSNorm -> SwiGLU, silu(x W_gate) * (x W_up) W_down, or the mixture of
experts: softmax over the router's logits, the top k renormalised to sum
1, the selected experts' SwiGLU outputs summed with those weights ->
residual. Then the final RMSNorm and the classifier, in f32.

``routes`` (optional, for a mixture of experts): the experts and their
gate weights to use at every layer and position of each sequence, an
(experts, weights) pair of (layers, positions, k) tensors a sequence, as
the program's router gave them. With routes every layer sums those
experts with those weights; without them it takes its own top k, as
above. ``router_logits``, a list, receives each layer's own router logits
(every sequence's positions in order), for the router's own check.

``act`` rounds every projection's input: "f32" (the reference), "bf16",
or "fp8" (float8 e4m3 with one scale a row, the step below bf16 that a
later change could take). TF32 stays off throughout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0                    # float8 e4m3's largest finite value
ATTN_BLOCK = 512                   # query rows an attention block


def dequant_q4_0(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A (K // 2, N) q4_0 nibble plane and its (K // 32, N) scales -> the
    (K, N) f32 weight: byte (16 b + j, n) holds row 32 b + j in its low
    nibble and row 32 b + 16 + j in its high one, each value nibble - 8."""
    q, s = w["q"], w["s"]
    K2, N = q.shape
    nb = K2 // 16
    blk = q.reshape(nb, 16, N)
    lo = (blk & 15).to(torch.int16) - 8
    hi = (blk >> 4).to(torch.int16) - 8
    vals = torch.cat([lo, hi], dim=1).float()              # (nb, 32, N)
    return (vals * s.float().reshape(nb, 1, N)).reshape(nb * 32, N)


def round_act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "f32":
        return x
    if act == "bf16":
        return x.bfloat16().float()
    if act == "fp8":
        amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
        scale = amax / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown act {act!r}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float, layout: str) -> torch.Tensor:
    """x (T, heads, D) at positions 0..T-1."""
    T, _, D = x.shape
    j = torch.arange(D // 2, dtype=torch.float64, device=x.device)
    freq = theta ** (-2.0 * j / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * freq
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    if layout == "neox":
        a, b = x[..., :D // 2], x[..., D // 2:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def attention(q, k, v, D: int) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: q (T, H, D), k and v
    (T, Hkv, D) -> (T, H * D), in blocks of query rows."""
    T, H, _ = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, T, D)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
    for r0 in range(0, T, ATTN_BLOCK):
        r1 = min(T, r0 + ATTN_BLOCK)
        qb = q[r0:r1].transpose(0, 1)                        # (H, b, D)
        s = torch.matmul(qb, k[:, :r1].transpose(1, 2)) / D ** 0.5
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(torch.arange(r1, device=q.device)[None, :] > rows, float("-inf"))
        out[r0:r1] = torch.matmul(torch.softmax(s, dim=-1), v[:, :r1]).transpose(0, 1)
    return out.reshape(T, H * D)


def _mlp(x, w_gate, w_up, w_down, act):
    xr = round_act(x, act)
    mid = torch.nn.functional.silu(xr @ w_gate) * (xr @ w_up)
    return round_act(mid, act) @ w_down


def _moe(x, lp, n_exp: int, k: int, act: str, chosen=None, router_logits=None):
    logits = round_act(x, act) @ lp["router"].float()
    if router_logits is not None:
        router_logits.append(logits)
    if chosen is None:
        topw, topi = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
        topw = topw / topw.sum(dim=-1, keepdim=True)
    else:
        topi, topw = chosen
    out = torch.zeros_like(x)
    for e in range(n_exp):
        rows, slot = (topi == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        w = {n: dequant_q4_0({"q": lp[n]["q"][e], "s": lp[n]["s"][e]})
             for n in ("w1e", "w3e", "w2e")}
        y = _mlp(x[rows], w["w1e"], w["w3e"], w["w2e"], act)
        out.index_add_(0, rows, y * topw[rows, slot][:, None])
    return out


@torch.no_grad()
def logits_at(cfg: dict, raw: dict, seqs: Sequence[Sequence[int]],
              spans: Sequence[tuple], act: str = "f32", routes=None,
              router_logits: Optional[list] = None) -> List[torch.Tensor]:
    """For each token sequence (BOS and prompt and served tokens) the f32
    logits (n, V) at the positions [a, b) of its span: position p's logits
    predict token p + 1."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(cfg, raw, seqs, spans, act, routes, router_logits)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _logits_at(cfg, raw, seqs, spans, act, routes, router_logits):
    E = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    Hkv = cfg.get("num_key_value_heads", H)
    D = E // H
    F = cfg["intermediate_size"]
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    layout = "neox" if cfg["model_type"] == "qwen2" else "interleaved"
    n_exp, k = cfg.get("num_local_experts", 0), cfg.get("num_experts_per_tok", 0)
    emb = raw["tok_emb"]
    xs = [emb[torch.as_tensor(list(s), device=emb.device)].float() for s in seqs]
    for li, lp in enumerate(raw["layers"]):
        wqkv = dequant_q4_0(lp["wqkv"])
        wo = dequant_q4_0(lp["wo"])
        for i, x in enumerate(xs):
            T = x.shape[0]
            h = round_act(rmsnorm(x, lp["attn_norm"], eps), act)
            qkv = h @ wqkv
            if "bqkv" in lp:
                qkv = qkv + lp["bqkv"].float()
            q = rope(qkv[:, :H * D].reshape(T, H, D), theta, layout)
            kk = rope(qkv[:, H * D:(H + Hkv) * D].reshape(T, Hkv, D), theta, layout)
            vv = qkv[:, (H + Hkv) * D:].reshape(T, Hkv, D)
            xs[i] = x + round_act(attention(q, kk, vv, D), act) @ wo
        del wqkv, wo
        # the FFN works a row at a time: every sequence's rows at once
        lens = [x.shape[0] for x in xs]
        x = torch.cat(xs)
        h = rmsnorm(x, lp["ffn_norm"], eps)
        if n_exp:
            chosen = None if routes is None else tuple(
                torch.cat([r[j][li] for r in routes]).to(x.device) for j in (0, 1))
            x = x + _moe(h, lp, n_exp, k, act, chosen, router_logits)
        else:
            w13 = dequant_q4_0(lp["w13"])
            x = x + _mlp(h, w13[:, :F], w13[:, F:], dequant_q4_0(lp["w2"]), act)
            del w13
        xs = list(torch.split(x, lens))
        del x, h
    wcls = dequant_q4_0(raw["wcls"])
    out = []
    for x, (a, b) in zip(xs, spans):
        h = rmsnorm(x[a:b], raw["final_norm"], eps)
        out.append(round_act(h, act) @ wcls)
    return out
