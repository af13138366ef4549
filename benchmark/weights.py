"""Random weights of a configuration, drawn on the device from the run's seed.

The layout is the one the port's GGUF loader makes with ``--dtype native``
for a Q4_0 file: every projection packed as q4_0, i.e. a (K // 2, N) uint8
plane whose byte (16 b + j, n) holds W[32 b + j, n] in its low nibble and
W[32 b + 16 + j, n] in its high nibble (value = nibble - 8), and a
(K // 32, N) f32 plane of block scales; q | k | v fused into one ``wqkv``
(its bias ``bqkv`` f32), gate | up into one ``w13`` (columns [0, F) the
gate), the experts stacked as (experts, K // 2, N) planes beside an f32
router; f32 norms, a bf16 embedding and a q4_0 classifier.

The values are centred: a nibble drawn as 0 (value -8) is turned into 8
(value 0), so every weight has mean 0. Uniform nibbles over -8..7 have mean
-0.5: every matrix then carries a rank-one part that a constant-sign
residual stream feeds back into itself layer after layer, the residual
grows to ~1e5 and attention turns into an argmax over near-ties, where
rounding alone picks another row.

Everything is carved out of three buffers (the nibbles, the scales, the
dense f32 vectors), each drawn in one call on the card, so set-up costs a
few large kernels and not one small one a leaf. The tensors are the
benchmark's: the program receives them wrapped in its own weight type
(``port_params``), and the reference reads them as they are.
"""

from __future__ import annotations

import torch

ALIGN = 256                       # bytes: every plane starts on a 256-byte boundary
CHUNK = 1 << 28                   # bytes of nibbles centred a step
# nibble values are uniform over -7..7 with 0 taken twice (-8 folded onto 0):
# mean 0, variance 2 * (1 + 4 + ... + 49) / 16 = 17.5; scales in [0.2, 2.0]
# x this give weights of std ~0.025
SCALE_UNIT = 0.025 / 17.5 ** 0.5


def dims(cfg: dict) -> dict:
    """The sizes the benchmark uses, read from a Hugging Face config."""
    E = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    Hkv = cfg.get("num_key_value_heads", H)
    D = cfg.get("head_dim") or E // H
    return dict(E=E, F=cfg["intermediate_size"], L=cfg["num_hidden_layers"], H=H, Hkv=Hkv,
                D=D, V=cfg["vocab_size"], X=cfg.get("num_local_experts", 0),
                k=cfg.get("num_experts_per_tok", 0),
                bias=cfg.get("model_type") == "qwen2")


def _layout(d: dict):
    """(name, shape of the logical (K, N) weight, experts or 0) of every
    q4_0 plane, and (name, length, std or None for ones) of every f32
    vector, in drawing order."""
    E, F, H, Hkv, D, X = d["E"], d["F"], d["H"], d["Hkv"], d["D"], d["X"]
    qkv = (H + 2 * Hkv) * D
    planes, vecs = [], []
    for i in range(d["L"]):
        planes += [(f"{i}.wqkv", E, qkv, 0), (f"{i}.wo", H * D, E, 0)]
        if X:
            planes += [(f"{i}.w1e", E, F, X), (f"{i}.w3e", E, F, X), (f"{i}.w2e", F, E, X)]
            vecs.append((f"{i}.router", E * X, 0.05))
        else:
            planes += [(f"{i}.w13", E, 2 * F, 0), (f"{i}.w2", F, E, 0)]
        vecs += [(f"{i}.attn_norm", E, None), (f"{i}.ffn_norm", E, None)]
        if d["bias"]:
            vecs.append((f"{i}.bqkv", qkv, 0.02))
    planes.append(("wcls", E, d["V"], 0))
    vecs.append(("final_norm", E, None))
    return planes, vecs


def _round_up(n: int, a: int) -> int:
    return -(-n // a) * a


def draw(cfg: dict, seed: int, device) -> dict:
    """The raw weights of ``cfg`` for ``seed``: {"tok_emb", "final_norm",
    "wcls", "layers": [...]}, every q4_0 weight a {"q", "s"} pair of planes
    (stacked experts with a leading axis, each drawn on its own), every
    vector f32."""
    d = dims(cfg)
    planes, vecs = _layout(d)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    # offsets of every plane in the nibble (bytes) and scale (floats) buffers
    q_off, s_off, spans = 0, 0, []
    for name, K, N, X in planes:
        n_q, n_s = max(X, 1) * (K // 2) * N, max(X, 1) * (K // 32) * N
        spans.append((name, K, N, X, q_off, s_off))
        q_off = _round_up(q_off + n_q, ALIGN)
        s_off = _round_up(s_off + n_s, ALIGN // 4)
    nib = torch.randint(0, 256, (q_off,), generator=g, device=device, dtype=torch.uint8)
    for a in range(0, q_off, CHUNK):
        c = nib[a:a + CHUNK]
        c += ((c & 15) == 0).to(torch.uint8) * 8          # low nibble 0 -> 8
        c += ((c >> 4) == 0).to(torch.uint8) * 128        # high nibble 0 -> 8
    sc = torch.rand((s_off,), generator=g, device=device).mul_(1.8).add_(0.2).mul_(SCALE_UNIT)
    v_len = sum(_round_up(n, ALIGN // 4) for _, n, _ in vecs)
    dense = torch.randn((v_len,), generator=g, device=device)
    emb = torch.randn((d["V"], d["E"]), generator=g, device=device).mul_(0.02).bfloat16()

    out = {"layers": [dict() for _ in range(d["L"])], "tok_emb": emb}
    for name, K, N, X, qo, so in spans:
        lead = (X,) if X else ()
        n_q, n_s = max(X, 1) * (K // 2) * N, max(X, 1) * (K // 32) * N
        w = {"q": nib[qo:qo + n_q].view(*lead, K // 2, N),
             "s": sc[so:so + n_s].view(*lead, K // 32, N)}
        _put(out, name, w)
    off = 0
    for name, n, std in vecs:
        v = dense[off:off + n]
        if std is None:
            v.fill_(1.0)
        else:
            v.mul_(std)
        if name.endswith("router"):
            v = v.view(d["E"], d["X"])
        _put(out, name, v)
        off += _round_up(n, ALIGN // 4)
    return out


def _put(out: dict, name: str, value) -> None:
    if "." in name:
        i, key = name.split(".", 1)
        out["layers"][int(i)][key] = value
    else:
        out[name] = value


def port_params(raw: dict) -> dict:
    """The same tensors in the port's parameter layout (its QTensor for the
    q4_0 planes); nothing is copied."""
    from tpu_llm_torch.quant.qtensor import QTensor

    def leaf(w):
        return QTensor(w["q"], w["s"], "q4_0") if isinstance(w, dict) else w

    return {"tok_emb": raw["tok_emb"], "final_norm": raw["final_norm"],
            "wcls": leaf(raw["wcls"]),
            "layers": [{k: leaf(v) for k, v in lp.items()} for lp in raw["layers"]]}


def port_config(cfg: dict):
    """The port's model configuration for a Hugging Face config."""
    from tpu_llm_torch.config import LlamaConfig

    d = dims(cfg)
    return LlamaConfig(
        dim=d["E"], hidden_dim=d["F"], n_layers=d["L"], n_heads=d["H"],
        n_kv_heads=d["Hkv"], vocab_size=d["V"], seq_len=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=float(cfg["rms_norm_eps"]),
        rope_variant="neox" if cfg["model_type"] == "qwen2" else "interleaved",
        use_bias=d["bias"], n_experts=d["X"], n_experts_used=d["k"] or 2)
