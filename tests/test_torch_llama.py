"""The port's llama model against tpu_llm.models.llama on the CPU: the same
weights (carried across with params_from_numpy), the same tokens, f32
logits within 2e-4 (the tolerance of tests/test_llama.py)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.make_tiny_gguf import build as build_tiny_gguf
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as J
from tpu_llm.quant import qtensor as jq
from tpu_llm.quant.convert_params import fold_norms_requant as fold_norms_requant_j
from tpu_llm.quant.convert_params import quantize_llama_params
from tpu_llm.runtime import engine as jengine
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models import llama as T
from tpu_llm_torch.quant.convert_params import fold_norms_requant, fold_rope_interleave
from tpu_llm_torch.quant.convert_params import quantize_llama_params as quantize_llama_params_t
from tpu_llm_torch.quant.qtensor import QTensor
from tpu_llm_torch.runtime import engine as tengine

CFG = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
           vocab_size=96, seq_len=32)
TOL = dict(rtol=2e-4, atol=2e-4)


# K-quants need contraction dims of 256
CFG_K = dict(CFG, dim=256, hidden_dim=256)


def jax_params(weights: str, seed: int = 0, cfg=CFG):
    """Random tiny model in the JAX package's (stacked) layout."""
    rng = np.random.default_rng(seed)
    d, h, L, V = cfg["dim"], cfg["hidden_dim"], cfg["n_layers"], cfg["vocab_size"]
    kv = d // cfg["n_heads"] * cfg["n_kv_heads"]
    s = lambda *shape: jnp.asarray((rng.standard_normal(shape) * 0.08).astype(np.float32))  # noqa: E731
    params = {
        "tok_emb": s(V, d),
        "final_norm": 1.0 + 0.1 * s(d),
        "wcls": s(d, V),
        "layers": {
            "attn_norm": 1.0 + 0.1 * s(L, d), "ffn_norm": 1.0 + 0.1 * s(L, d),
            "wq": s(L, d, d), "wk": s(L, d, kv), "wv": s(L, d, kv), "wo": s(L, d, d),
            "w1": s(L, d, h), "w3": s(L, d, h), "w2": s(L, h, d),
        },
    }
    if weights != "dense":
        params = quantize_llama_params(params, weights, fuse=True)
    return params


def to_numpy(p):
    if isinstance(p, jq.QTensor):
        return {"q": np.asarray(p.q), "scales": np.asarray(p.scales), "kind": p.kind,
                "mins": None if p.mins is None else np.asarray(p.mins)}
    if isinstance(p, dict):
        return {k: to_numpy(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [to_numpy(v) for v in p]
    return None if p is None else np.asarray(p)


def both(weights: str, cfg=CFG):
    jp = jax_params(weights, cfg=cfg)
    return jp, T.params_from_numpy(to_numpy(jp))


def assert_same_params(a, b):
    """Port parameter dicts (per-layer lists) equal plane for plane."""
    for la, lb in zip(a["layers"] + [{k: v for k, v in a.items() if k != "layers"}],
                      b["layers"] + [{k: v for k, v in b.items() if k != "layers"}]):
        assert la.keys() == lb.keys()
        for k, x in la.items():
            y = lb[k]
            if isinstance(x, QTensor):
                assert x.kind == y.kind and torch.equal(x.q, y.q), k
                assert torch.equal(x.scales, y.scales), k
                assert (x.mins is None and y.mins is None) or torch.equal(x.mins, y.mins), k
            elif x is None:
                assert y is None, k
            else:
                assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("weights", ["dense", "q4_0", "q8_0"])
def test_decode_steps_match_jax(weights):
    jp, tp = both(weights)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jc = J.init_cache(jcfg, batch=2, max_seq=CFG["seq_len"])
    tc = T.init_cache(tcfg, batch=2, max_seq=CFG["seq_len"])
    for pos, tok in enumerate([1, 7, 3, 90, 12, 5]):
        toks = np.asarray([tok, (tok * 7) % 96], np.int32)
        jl, jc = J.decode_step(jp, jcfg, jnp.asarray(toks), jc, jnp.int32(pos))
        tl, tc = T.decode_step(tp, tcfg, torch.from_numpy(toks), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("weights", ["dense", "q4_0"])
@pytest.mark.parametrize("flash_prefill", [False, True])
def test_prefill_then_decode_matches_jax(weights, flash_prefill, monkeypatch):
    """Prompt forward (T > 1) then one decode step. ``flash_prefill``
    lowers the scores threshold so prefill takes the flash kernel's path."""
    if flash_prefill:
        monkeypatch.setattr(T, "FLASH_PREFILL_SCORES_BYTES", 0)
    jp, tp = both(weights)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    toks = np.asarray([[1, 4, 9, 16, 25, 36, 49, 64, 81, 3]], np.int32)
    jc = J.init_cache(jcfg, 1, CFG["seq_len"])
    tc = T.init_cache(tcfg, 1, CFG["seq_len"])
    jx, jc = J.forward(jp, jcfg, jnp.asarray(toks), jc, jnp.int32(0))
    tx, tc = T.forward(tp, tcfg, torch.from_numpy(toks), tc, 0)
    np.testing.assert_allclose(T.lm_head(tp, tcfg, tx).numpy(),
                               np.asarray(J.lm_head(jp, jcfg, jx)), **TOL)
    jl, _ = J.decode_step(jp, jcfg, jnp.asarray([5], jnp.int32), jc, jnp.int32(10))
    tl, _ = T.decode_step(tp, tcfg, torch.tensor([5]), tc, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("weights", ["dense", "q4_0"])
def test_defer_kv_matches_jax(weights):
    """decode_step(defer_kv=True): the fused attention + append path,
    against the JAX package's deferred path on per-layer planes."""
    jp, tp = both(weights)
    jp = J.unstack_layers(jp)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jc = J.init_cache(jcfg, 1, CFG["seq_len"], stacked=False)
    tc = T.init_cache(tcfg, 1, CFG["seq_len"])
    for pos, tok in enumerate([1, 30, 2, 77, 8]):
        jl, jc = J.decode_step(jp, jcfg, jnp.asarray([tok], jnp.int32), jc,
                               jnp.int32(pos), defer_kv=True)
        tl, tc = T.decode_step(tp, tcfg, torch.tensor([tok]), tc, pos, defer_kv=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(CFG["n_layers"]):
        np.testing.assert_allclose(tc["k"][i].numpy(), np.asarray(jc["k"][i]), **TOL)
        np.testing.assert_allclose(tc["v"][i].numpy(), np.asarray(jc["v"][i]), **TOL)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_quantize_llama_params_matches_jax(kind):
    """Quantizing the port's dense parameters (and fusing) gives the planes
    the JAX package's quantize_llama_params gives."""
    jp = jax_params("dense")
    tq = quantize_llama_params_t(T.params_from_numpy(to_numpy(jp)), kind, fuse=True)
    want = T.params_from_numpy(to_numpy(quantize_llama_params(jp, kind, fuse=True)))
    for lt, lw in zip(tq["layers"] + [{"wcls": tq["wcls"]}],
                      want["layers"] + [{"wcls": want["wcls"]}]):
        assert lt.keys() == lw.keys()
        for k, a in lt.items():
            b = lw[k]
            if isinstance(a, QTensor):
                assert a.kind == b.kind == kind
                assert torch.equal(a.q, b.q) and torch.equal(a.scales, b.scales), k
            else:
                assert torch.equal(a, b), k


def test_fold_rope_interleave_keeps_logits():
    jp, tp = both("q4_0")
    tcfg = TConfig(**CFG)
    fp, fcfg = fold_rope_interleave(tp, tcfg)
    assert fcfg.rope_variant == "neox"
    jcfg = JConfig(**CFG)
    toks = np.asarray([[3, 1, 4, 1, 5, 9]], np.int32)
    jx, _ = J.forward(jp, jcfg, jnp.asarray(toks), J.init_cache(jcfg, 1, 32), jnp.int32(0))
    fx, _ = T.forward(fp, fcfg, torch.from_numpy(toks), T.init_cache(fcfg, 1, 32), 0)
    np.testing.assert_allclose(T.lm_head(fp, fcfg, fx).numpy(),
                               np.asarray(J.lm_head(jp, jcfg, jx)), **TOL)


def test_tied_embeddings_lm_head():
    jp, tp = both("dense")
    jp, tp = dict(jp, wcls=None), dict(tp, wcls=None)
    cfg = dict(CFG)
    x = np.random.default_rng(0).standard_normal((1, 2, CFG["dim"])).astype(np.float32)
    np.testing.assert_allclose(
        T.lm_head(tp, TConfig(**cfg), torch.from_numpy(x)).numpy(),
        np.asarray(J.lm_head(jp, JConfig(**cfg), jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q4_0"])
def test_load_gguf_matches_jax(tmp_path, quant):
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=quant)
    policy = "native" if quant else "f32"
    jp, jcfg = J.load_gguf(path, dtype_policy=policy, fuse=True)
    tp, tcfg = T.load_gguf(path, dtype_policy=policy)
    for f in ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
              "seq_len", "rope_theta", "norm_eps", "rope_variant", "tie_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    carried = T.params_from_numpy(to_numpy(jp))
    for key in ("tok_emb", "final_norm"):
        assert torch.equal(tp[key], carried[key]), key
    for lt, lc in zip(tp["layers"] + [{"wcls": tp["wcls"]}],
                      carried["layers"] + [{"wcls": carried["wcls"]}]):
        assert lt.keys() == lc.keys()
        for k in lt:
            a, b = lt[k], lc[k]
            if isinstance(a, QTensor):
                assert a.kind == b.kind and torch.equal(a.q, b.q) and torch.equal(a.scales, b.scales)
            else:
                assert a.dtype == b.dtype and torch.equal(a, b), k
    toks = np.asarray([[1, 4, 5, 6, 7]], np.int32)
    jx, _ = J.forward(jp, jcfg, jnp.asarray(toks), J.init_cache(jcfg, 1, 32), jnp.int32(0))
    tx, _ = T.forward(tp, tcfg, torch.from_numpy(toks), T.init_cache(tcfg, 1, 32), 0)
    jl = np.asarray(J.lm_head(jp, jcfg, jx))
    tl = T.lm_head(tp, tcfg, tx).numpy()
    if quant:   # native: bf16 embedding and activations on both sides
        np.testing.assert_allclose(tl, jl, rtol=5e-2, atol=5e-2)
    else:
        np.testing.assert_allclose(tl, jl, **TOL)


def test_engine_generate_matches_jax_greedy_and_seeds_sampling():
    jp, tp = both("q4_0")
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    jeng = jengine.Engine(J.unstack_layers(jp),
                          jengine.ModelAdapter.llama(jcfg, stacked=False), max_seq=32)
    teng = tengine.Engine(tp, tengine.ModelAdapter.llama(tcfg, device="cpu"),
                          max_seq=32, device="cpu")
    prompt = [5, 9, 13]
    jr = jeng.generate(prompt, n_total=12)
    tr = teng.generate(prompt, n_total=12)
    assert tr.tokens == jr.tokens and tr.n_prompt == jr.n_prompt == 3
    assert [f.name for f in dataclasses.fields(tr)] == \
        [f.name for f in dataclasses.fields(jr)]
    a = teng.generate(prompt, n_total=12, temperature=0.9, seed=4).tokens
    b = teng.generate(prompt, n_total=12, temperature=0.9, seed=4).tokens
    assert a == b and len(a) == 12 and a[:3] == prompt


@pytest.mark.parametrize("weights", ["dense", "q4_0"])
def test_forward_with_offset_vector_matches_jax(weights):
    """forward(offset=(B,) tensor): each row at its own position through
    RoPE, the cache write and attention (continuous batching)."""
    jp, tp = both(weights)
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CFG["vocab_size"], (2, 9)).astype(np.int32)
    jc = J.init_cache(jcfg, 2, CFG["seq_len"])
    tc = T.init_cache(tcfg, 2, CFG["seq_len"])
    _, jc = J.forward(jp, jcfg, jnp.asarray(toks), jc, jnp.int32(0))
    T.forward(tp, tcfg, torch.from_numpy(toks), tc, 0)
    for offs in ([3, 8], [9, 5], [2, 2]):
        step = np.asarray([[7], [40]], np.int32)
        jx, jc = J.forward(jp, jcfg, jnp.asarray(step), jc, jnp.asarray(offs, jnp.int32))
        tx, tc = T.forward(tp, tcfg, torch.from_numpy(step), tc,
                           torch.tensor(offs, dtype=torch.int32))
        np.testing.assert_allclose(T.lm_head(tp, tcfg, tx).numpy(),
                                   np.asarray(J.lm_head(jp, jcfg, jx)), **TOL)
    for i in range(CFG["n_layers"]):
        np.testing.assert_allclose(tc["k"][i].numpy(),
                                   np.asarray(jc["k"][i]).reshape(tc["k"][i].shape), **TOL)


# -- K-quant and legacy-quant weights, norm folding --------------------------

def _logits(fwd_params, mod, cfg, toks, jax_side):
    if jax_side:
        x, _ = mod.forward(fwd_params, cfg, jnp.asarray(toks), mod.init_cache(cfg, 1, 32),
                           jnp.int32(0))
        return np.asarray(mod.lm_head(fwd_params, cfg, x))
    x, _ = mod.forward(fwd_params, cfg, torch.from_numpy(toks), mod.init_cache(cfg, 1, 32), 0)
    return mod.lm_head(fwd_params, cfg, x).numpy()


@pytest.mark.parametrize("ttype", ["Q4_K", "Q6_K", "Q5_0", "Q4_K_M-mix"])
def test_quant_gguf_native_matches_jax(tmp_path, ttype):
    """--dtype native on a K-quant or legacy-quant file: the port's loader
    gives the planes the JAX loader gives (carried with params_from_numpy),
    and the port's logits match JAX's forward at bf16 tolerance: top-1
    equal, error <= 5e-2 * max|logit| (the JAX CPU path rounds each
    dequantized weight to bf16, the port's kernel path does not; 2-4
    layers of bf16 activations). The mix is tests/make_tiny_gguf.build_kq
    (Q4_K, Q6_K for ffn_down and output)."""
    from tests.make_tiny_gguf import build_kq
    from tests.test_torch_kquant import build_quant_gguf
    from tpu_llm_torch.io import gguf as tgg

    path = str(tmp_path / "q.gguf")
    if ttype == "Q4_K_M-mix":
        build_kq(path)
    else:
        build_quant_gguf(path, getattr(tgg, f"GGML_{ttype}"))
    jp, jcfg = J.load_gguf(path, dtype_policy="native", fuse=True)
    tp, tcfg = T.load_gguf(path, dtype_policy="native")
    assert_same_params(tp, T.params_from_numpy(to_numpy(jp)))
    toks = np.asarray([[1, 4, 5, 6, 7, 9]], np.int32)
    got, want = _logits(tp, T, tcfg, toks, False), _logits(jp, J, jcfg, toks, True)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_mixed_kinds_under_fusion_raise(tmp_path):
    from tests.test_torch_kquant import build_quant_gguf
    from tpu_llm_torch.io import gguf as tgg

    path = str(tmp_path / "mixed.gguf")
    build_quant_gguf(path, tgg.GGML_Q4_K, mixed=True)
    with pytest.raises(ValueError, match="blk.0.attn_k.weight is q6_k"):
        T.load_gguf(path, dtype_policy="native")
    T.load_gguf(path, dtype_policy="native", fuse=False)     # unfused loads
    T.load_gguf(path, dtype_policy="f32")                    # dense fuses


@pytest.mark.parametrize("kind", ["q4_0", "q8_0", "q4_1", "q5_0", "q4_k", "q6_k",
                                  "q3_k", "q2_k"])
def test_fold_norms_requant_matches_jax(kind):
    """fold_norms_requant on the port's parameters gives the JAX package's
    planes (requantized in each kind), and the same logits."""
    jp = jax_params(kind, cfg=CFG_K)
    jcfg, tcfg = JConfig(**CFG_K), TConfig(**CFG_K)
    jf = fold_norms_requant_j(jp, jcfg)
    tf = fold_norms_requant(T.params_from_numpy(to_numpy(jp)), tcfg)
    assert tf["final_norm"] is None and all(lp["attn_norm"] is None for lp in tf["layers"])
    assert_same_params(tf, T.params_from_numpy(to_numpy(jf)))
    toks = np.asarray([[1, 4, 9, 16, 25]], np.int32)
    np.testing.assert_allclose(_logits(tf, T, tcfg, toks, False),
                               _logits(jf, J, jcfg, toks, True), **TOL)


@pytest.mark.parametrize("kind", ["q4_0", "q4_k", "q6_k", "q2_k"])
def test_norm_fold_row_scale_matches_jax(monkeypatch, kind):
    """TPU_LLM_NORM_FOLD: the norm weights ride the qkv and w13 matmuls as
    row_scale, in both packages."""
    monkeypatch.setenv("TPU_LLM_NORM_FOLD", "1")
    jp, tp = both(kind, cfg=CFG_K)
    jcfg, tcfg = JConfig(**CFG_K), TConfig(**CFG_K)
    toks = np.asarray([[3, 1, 4, 1, 5, 9, 2]], np.int32)
    np.testing.assert_allclose(_logits(tp, T, tcfg, toks, False),
                               _logits(jp, J, jcfg, toks, True), **TOL)
