"""The port's other llama-family architectures on the CPU, held against
the JAX package on the same seeded inputs at tiny sizes: qwen2 (neox
rope, QKV biases, tied embeddings, YaRN), gemma (explicit head_dim 24,
1 + w norms, GeGLU, sqrt(dim) embedding scale), phi-2 (parallel block,
LayerNorm, biases, GELU MLP, partial rope) and Mixtral-style MoE (stacked
and split expert tensors, f32 and q4_0, the three strategies of
``_moe_ffn``), through the model, the batch engines and the `llm` /
`llm-serve` CLIs; and the routing gates the new shapes need (the
attention kernels' head widths, K7's SiLU gate, the norm fold).

Tolerances are the JAX tests' own: rope 1e-6 (linear) / 1e-5 (YaRN),
f32 logits 2e-4 (tests/test_llama.py, tests/test_moe.py), phi-2 3e-4
(tests/test_phi2.py), ``_moe_ffn`` 2e-5 (tests/test_moe.py); native
(bf16 activations) logits 5e-2 as in tests/test_torch_llama.py.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.make_tiny_gguf import build_moe
from tpu_llm import config as jconfig
from tpu_llm.io import gguf as jgg
from tpu_llm.models import llama as J
from tpu_llm.models import phi2 as JP
from tpu_llm.ops import rope as jrope
from tpu_llm.runtime import cli as jcli
from tpu_llm.runtime import serve_cli as jserve
from tpu_llm_torch import config as tconfig
from tpu_llm_torch.models import llama as T
from tpu_llm_torch.models import phi2 as TP
from tpu_llm_torch.ops import rope as trope
from tpu_llm_torch.ops.flash_attention import kernel_head_dim
from tpu_llm_torch.runtime import cli as tcli
from tpu_llm_torch.runtime import serve_cli as tserve

F32 = dict(rtol=2e-4, atol=2e-4)
PHI2 = dict(rtol=3e-4, atol=3e-4)
MOE = dict(rtol=2e-5, atol=2e-5)

TOKENS = ["<unk>", "<s>", "</s>", "▁", "a", "b", "c", "▁ab", "ab", "bc", "▁abc"]


def _meta(arch, dim, hidden, L, H, KVH, V, **extra):
    m = {"general.architecture": arch, f"{arch}.block_count": L,
         f"{arch}.embedding_length": dim, f"{arch}.feed_forward_length": hidden,
         f"{arch}.attention.head_count": H, f"{arch}.attention.head_count_kv": KVH,
         f"{arch}.context_length": 128, f"{arch}.rope.freq_base": 10000.0,
         "tokenizer.ggml.tokens": TOKENS + [f"tok{i}" for i in range(V - len(TOKENS))],
         "tokenizer.ggml.scores": np.zeros(V, np.float32),
         "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    m.update({f"{arch}.{k}": v for k, v in extra.items()})
    return m


def write_family(path, arch, seed=0, q8=False):
    """A tiny GGUF of ``arch`` with a tokenizer: "qwen2" (random QKV biases,
    tied, YaRN factor 4 over an original context of 32), "gemma" (head_dim
    24, q width 96 != dim 64, tied), "phi2" (rope over 8 of 16 head dims),
    or "llama_linear" (a llama with the legacy rope.scale_linear 2).
    ``q8`` stores the projections and the classifier as Q8_0."""
    rng = np.random.default_rng(seed)
    s = lambda *sh: (rng.standard_normal(sh) * 0.08).astype(np.float32)  # noqa: E731
    w = (lambda a: (a, jgg.GGML_Q8_0)) if q8 else (lambda a: a)
    V = 40
    if arch == "phi2":
        d, h, L, H = 64, 96, 2, 4
        meta = _meta("phi2", d, h, L, H, H, V, **{"rope.dimension_count": 8,
                                                  "attention.layer_norm_epsilon": 1e-5})
        t = {"token_embd.weight": s(V, d), "output_norm.weight": 1.0 + 0.1 * s(d),
             "output_norm.bias": 0.1 * s(d), "output.weight": w(s(V, d)),
             "output.bias": 0.1 * s(V)}
        for i in range(L):
            t[f"blk.{i}.attn_norm.weight"] = 1.0 + 0.1 * s(d)
            t[f"blk.{i}.attn_norm.bias"] = 0.1 * s(d)
            t[f"blk.{i}.attn_qkv.weight"] = w(s(3 * d, d))
            t[f"blk.{i}.attn_qkv.bias"] = 0.1 * s(3 * d)
            t[f"blk.{i}.attn_output.weight"] = w(s(d, d))
            t[f"blk.{i}.attn_output.bias"] = 0.1 * s(d)
            t[f"blk.{i}.ffn_up.weight"] = w(s(h, d))
            t[f"blk.{i}.ffn_up.bias"] = 0.1 * s(h)
            t[f"blk.{i}.ffn_down.weight"] = w(s(d, h))
            t[f"blk.{i}.ffn_down.bias"] = 0.1 * s(d)
        jgg.write_gguf(path, meta, t)
        return
    gemma = arch == "gemma"
    d, h, L, H, KVH = (64, 64, 2, 4, 2) if gemma else (64, 96, 2, 4, 2)
    hd = 24 if gemma else d // H
    extra = {"attention.layer_norm_rms_epsilon": 1e-6 if gemma else 1e-5}
    if gemma:
        extra.update({"attention.key_length": hd, "attention.value_length": hd})
    elif arch == "qwen2":
        extra.update({"rope.scaling.type": "yarn", "rope.scaling.factor": 4.0,
                      "rope.scaling.original_context_length": 32})
    else:
        extra.update({"rope.scale_linear": 2.0})
    name = "llama" if arch == "llama_linear" else arch
    meta = _meta(name, d, h, L, H, KVH, V, **extra)
    t = {"token_embd.weight": s(V, d),
         "output_norm.weight": (0.1 if gemma else 1.0) + 0.1 * s(d)}
    if arch == "llama_linear":
        t["output.weight"] = w(s(V, d))
    for i in range(L):
        t[f"blk.{i}.attn_norm.weight"] = (0.1 if gemma else 1.0) + 0.1 * s(d)
        t[f"blk.{i}.ffn_norm.weight"] = (0.1 if gemma else 1.0) + 0.1 * s(d)
        t[f"blk.{i}.attn_q.weight"] = w(s(H * hd, d))
        t[f"blk.{i}.attn_k.weight"] = w(s(KVH * hd, d))
        t[f"blk.{i}.attn_v.weight"] = w(s(KVH * hd, d))
        t[f"blk.{i}.attn_output.weight"] = w(s(d, H * hd))
        t[f"blk.{i}.ffn_gate.weight"] = w(s(h, d))
        t[f"blk.{i}.ffn_up.weight"] = w(s(h, d))
        t[f"blk.{i}.ffn_down.weight"] = w(s(d, h))
        if arch == "qwen2":
            t[f"blk.{i}.attn_q.bias"] = s(H * hd)
            t[f"blk.{i}.attn_k.bias"] = s(KVH * hd)
            t[f"blk.{i}.attn_v.bias"] = s(KVH * hd)
    jgg.write_gguf(path, meta, t)


ARCHS = ["qwen2", "gemma", "phi2", "llama_linear", "moe"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for arch in ARCHS:
        for q8 in (False, True):
            p = str(d / f"{arch}{'_q8' if q8 else ''}.gguf")
            if arch == "moe":
                build_moe(p, quant=q8)
            else:
                write_family(p, arch, q8=q8)
            out[(arch, q8)] = p
    for quant in (False, True):
        p = str(d / f"moe_split{'_q4' if quant else ''}.gguf")
        build_moe(p, quant=quant, split_names=True)
        out[("moe_split", quant)] = p
    return out


def _jax_load(path, policy):
    gguf = jgg.GGUFFile(path)
    if gguf.hparam("general.architecture") == "phi2":
        return JP.load_gguf(gguf, dtype_policy=policy)
    return J.load_gguf(gguf, dtype_policy=policy)


def _logits_both(path, policy, toks):
    """Prefill logits of ``toks`` (B, T), then one decode step's, in both
    packages."""
    jp, jc = _jax_load(path, policy)
    # the JAX per-layer loop (its engines' path; a biased model with bf16
    # activations promotes to f32, which its stacked lax.scan refuses)
    jp = J.unstack_layers(jp)
    tp, tc = T.load_model(jgg.GGUFFile(path), dtype_policy=policy)
    if policy == "native":
        # f32 activations over the packed weights: with bf16 ones a
        # router's near-tie flips an expert on one side only (the two
        # packages round different sums), which is no fault of either
        jp = dict(jp, tok_emb=jp["tok_emb"].astype(jnp.float32))
        tp = dict(tp, tok_emb=tp["tok_emb"].float())
    B, n = len(toks), len(toks[0])
    jcache = J.init_cache(jc, B, 32, stacked=False)
    jh, jcache = J.forward(jp, jc, jnp.asarray(toks, jnp.int32), jcache, jnp.int32(0))
    jstep, _ = J.decode_step(jp, jc, jnp.asarray([5] * B, jnp.int32), jcache, jnp.int32(n))
    tcache = T.init_cache(tc, B, 32)
    th, tcache = T.forward(tp, tc, torch.tensor(toks), tcache, 0)
    tstep, _ = T.decode_step(tp, tc, torch.tensor([5] * B), tcache, n)
    return ((np.asarray(J.lm_head(jp, jc, jh)), np.asarray(jstep)),
            (T.lm_head(tp, tc, th).numpy(), tstep.numpy()), jc, tc)


CFG_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "vocab_size",
              "seq_len", "rope_theta", "norm_eps", "rope_variant", "rope_dims",
              "parallel_block", "use_layernorm", "use_bias", "act", "gated_mlp",
              "tie_embeddings", "head_dim", "q_dim", "kv_dim", "emb_scale",
              "rope_scaling", "n_experts", "n_experts_used")


@pytest.mark.parametrize("arch", ARCHS + ["moe_split"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "quant"])
def test_family_load_and_decode_match_jax(files, arch, quant):
    """The config, and the logits of a 3-token prefill (batch 2) and one
    decode step: f32 at the JAX tests' tolerance (phi-2's 3e-4, the
    others' 2e-4); Q8_0 / Q4_0 files under "native", with the embedding
    widened to f32 on both sides, at the native tolerance 5e-2 (the JAX
    CPU path rounds each dequantized weight to bf16, the port does not;
    phi-2's q / k / v dense)."""
    policy = "native" if quant else "f32"
    (jl, js), (tl, ts), jc, tc = _logits_both(files[(arch, quant)], policy,
                                              [[1, 4, 9], [1, 7, 6]])
    for f in CFG_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    tol = (dict(rtol=5e-2, atol=5e-2) if quant else PHI2 if arch == "phi2" else F32)
    np.testing.assert_allclose(tl, jl, **tol)
    np.testing.assert_allclose(ts, js, **tol)


def test_family_configs():
    """What each tiny file turns into (the switches the JAX tests assert)."""
    assert T.config_from_gguf  # the llama-family loader
    cases = {"qwen2": dict(rope_variant="neox", use_bias=True, tie_embeddings=True,
                           rope_scaling=("yarn", 4.0, 32)),
             "gemma": dict(head_dim=24, q_dim=96, act="gelu", rope_variant="neox",
                           emb_scale=64 ** 0.5, tie_embeddings=True),
             "phi2": dict(parallel_block=True, use_layernorm=True, rope_dims=8,
                          gated_mlp=False),
             "llama_linear": dict(rope_scaling=("linear", 2.0, 128),
                                  rope_variant="interleaved"),
             "moe": dict(n_experts=4, n_experts_used=2)}
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for arch, want in cases.items():
            p = f"{d}/{arch}.gguf"
            build_moe(p) if arch == "moe" else write_family(p, arch)
            _, cfg = T.load_model(jgg.GGUFFile(p))
            for k, v in want.items():
                assert getattr(cfg, k) == pytest.approx(v) if isinstance(v, float) \
                    else getattr(cfg, k) == v, (arch, k)


def test_gemma_norms_are_one_plus_w_once(files):
    """gemma's 1 + w lands at load; fold_norms is refused for none of the
    rmsnorm families but does not add the 1 again (the folded weights are
    diag(1 + w) W)."""
    path = files[("gemma", False)]
    tp, tc = T.load_model(jgg.GGUFFile(path))
    raw = jgg.GGUFFile(path).dequantized("blk.0.attn_norm.weight", np.float32)
    np.testing.assert_allclose(tp["layers"][0]["attn_norm"].numpy(), 1.0 + raw, rtol=1e-6)
    from tpu_llm_torch.quant.convert_params import fold_norms_requant

    folded = fold_norms_requant(tp, tc)
    want = torch.from_numpy(1.0 + raw)[:, None] * tp["layers"][0]["wqkv"]
    assert torch.allclose(folded["layers"][0]["wqkv"], want, rtol=1e-6)


@pytest.mark.parametrize("arch", ["phi2", "moe"])
def test_fold_norms_refused_for_shared_norms_and_moe(files, arch):
    from tpu_llm_torch.quant.convert_params import fold_norms_requant

    tp, tc = T.load_model(jgg.GGUFFile(files[(arch, False)]))
    with pytest.raises(NotImplementedError, match="rmsnorm llama family"):
        fold_norms_requant(tp, tc)


# -- rope --------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["interleaved", "neox"])
@pytest.mark.parametrize("scaling,rope_dims,tol", [
    (None, 16, 1e-6), (("linear", 4.0, 2048), None, 1e-6),
    (("linear", 2.0, 64), 16, 1e-6), (("yarn", 8.0, 4096), None, 1e-5),
    (("yarn", 4.0, 32768), 16, 1e-5)], ids=["partial", "linear", "linear_partial",
                                            "yarn", "yarn_partial"])
def test_rope_scaled_and_partial_match_jax(variant, scaling, rope_dims, tol):
    """rope_angles with linear / YaRN scaling and rope_dims, the table
    route, and the rotation of the first rope_dims dims (the rest pass
    through): the JAX package's values at test_ops.py's tolerances."""
    rng = np.random.default_rng(2)
    # positions inside test_ops.py's range (f32 angles past it differ in
    # their last bits between any two pow implementations)
    D, pos = 64, np.asarray([[0, 7, 100], [2047, 5, 1500]], np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), D, 1e6, variant, rope_dims, scaling)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), D, 1e6, variant, rope_dims, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=tol, atol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=tol, atol=tol)
    x = rng.standard_normal((2, 3, 4, D)).astype(np.float32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, variant, rope_dims,
                            scaling)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, variant,
                           rope_dims, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    rot = rope_dims or D
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])
    table = trope.rope_table(2048, D, 1e6, variant, rope_dims, scaling)
    via = trope.apply_rope_table(torch.from_numpy(x), table, torch.from_numpy(pos),
                                 variant, rope_dims)
    assert torch.equal(via, got)


# -- MoE ---------------------------------------------------------------------

def _moe_lp(quant, EX=8, E=64, F=96, seed=3):
    """One layer's router and stacked experts in both packages (q4_0 planes
    from the JAX codec, carried across)."""
    from tpu_llm.quant.qtensor import qmap as jqmap
    from tpu_llm.quant.qtensor import quantize_tensor

    rng = np.random.default_rng(seed)
    s = lambda *sh: (rng.standard_normal(sh) * 0.3).astype(np.float32)  # noqa: E731
    jlp = {"router": jnp.asarray(s(E, EX))}
    for k, (K, N) in (("w1e", (E, F)), ("w3e", (E, F)), ("w2e", (F, E))):
        w = s(EX, K, N)
        jlp[k] = (jqmap(lambda *ps: jnp.stack(ps), *[quantize_tensor(w[e], "q4_0")
                                                     for e in range(EX)])
                  if quant else jnp.asarray(w))

    def leaf(v):
        if hasattr(v, "kind"):
            return {"q": np.asarray(v.q), "scales": np.asarray(v.scales), "kind": v.kind,
                    "mins": None}
        return np.asarray(v)

    tlp = T.params_from_numpy({"layers": [{k: leaf(v) for k, v in jlp.items()}]})
    return jlp, tlp["layers"][0]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q4_0"])
@pytest.mark.parametrize("B,Tn,strategy", [(1, 1, "gather"), (2, 1, "union"),
                                           (1, 2, "union"), (8, 1, "dense"),
                                           (2, 4, "dense")])
def test_moe_ffn_strategies_match_jax(quant, B, Tn, strategy, monkeypatch):
    """_moe_ffn at one token (the k experts gathered by device index), 2
    tokens (the union of the selected experts: 2 x 2 < 8) and 8 tokens
    (every expert, masked), against the JAX package's _moe_ffn on the
    same inputs; the strategy is observed through the expert slices it
    takes (device indices or python ints)."""
    cfg_kw = dict(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=4,
                  vocab_size=8, n_experts=8, n_experts_used=2)
    jlp, tlp = _moe_lp(quant)
    x = np.random.default_rng(B * 10 + Tn).standard_normal((B, Tn, 64)).astype(np.float32)
    want = np.asarray(J._moe_ffn(jconfig.LlamaConfig(**cfg_kw), jnp.asarray(x), jlp))
    seen = []
    slice_ = T._expert_slice
    monkeypatch.setattr(T, "_expert_slice",
                        lambda w, e: seen.append(type(e).__name__) or slice_(w, e))
    got = T._moe_ffn(tconfig.LlamaConfig(**cfg_kw), torch.from_numpy(x), tlp).numpy()
    np.testing.assert_allclose(got, want, **MOE)
    n = {"gather": 2, "union": B * Tn * 2, "dense": 8}[strategy]
    assert len(seen) == 3 * n
    assert set(seen) == ({"int"} if strategy == "dense" else {"Tensor"})


def test_moe_strategies_read_nothing_on_the_host(monkeypatch):
    """No strategy turns a device value into a python number: the calls a
    captured graph cannot hold (.item(), .tolist(), int() / bool() of a
    tensor, nonzero without a size) are made to raise."""
    jlp, tlp = _moe_lp(False)
    cfg = tconfig.LlamaConfig(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=4,
                              vocab_size=8, n_experts=8, n_experts_used=2)

    def refuse(*a, **k):
        raise AssertionError("host read of a device value")

    for name in ("item", "tolist", "__int__", "__bool__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    for shape in ((1, 1), (2, 1), (8, 1)):
        out = T._moe_ffn(cfg, torch.randn(*shape, 64), tlp)
        assert out.shape == (*shape, 64)


def test_moe_serves_through_both_engines_like_jax(files):
    """MoE through the port's BatchEngine and PagedEngine: the JAX
    BatchEngine's tokens (tests/test_moe.py's requests)."""
    from tpu_llm.runtime import batching as jb
    from tpu_llm.runtime import engine as je
    from tpu_llm_torch.runtime import batching as tb
    from tpu_llm_torch.runtime import engine as te
    from tpu_llm_torch.runtime.paged_engine import PagedEngine

    path = files[("moe", False)]
    jp, jc = J.load_gguf(path)
    tp, tc = T.load_gguf(path)
    prompts = [([4, 7, 9], 5), ([5, 8], 6), ([4, 7, 3, 3], 4)]
    jeng = jb.BatchEngine(jp, je.ModelAdapter.llama(jc, bos_id=1), batch=2, max_seq=32)
    jr = [jeng.submit(jb.Request(prompt=p, max_new=n)) for p, n in prompts]
    jeng.run()
    want = [r.tokens for r in jr]
    teng = tb.BatchEngine(tp, te.ModelAdapter.llama(tc, bos_id=1, device="cpu"),
                          batch=2, max_seq=32)
    tr = [teng.submit(tb.Request(prompt=p, max_new=n)) for p, n in prompts]
    teng.run()
    peng = PagedEngine(tp, tc, batch=2, n_blocks=32, block_size=4, max_seq=32, bos_id=1,
                       device="cpu")
    pr = [peng.submit(tb.Request(prompt=p, max_new=n)) for p, n in prompts]
    peng.run()
    assert [r.tokens for r in tr] == want
    assert [r.tokens for r in pr] == want


# -- routing gates -----------------------------------------------------------

@pytest.mark.parametrize("D,kernel", [(16, True), (64, True), (80, True), (128, True),
                                      (24, False), (96 + 8, False), (144, False),
                                      (256, False)])
def test_attention_head_dim_gate(D, kernel, monkeypatch):
    """kernel_head_dim: multiples of 16 up to 128 (phi-2's 80 included,
    gemma's 256 not). _attend sends a decode, and a prefill past the 64 MB
    scores gate, to the kernels' wrappers only for those widths; other
    widths take the plain gqa_attention (here the wrappers are spies)."""
    assert kernel_head_dim(D) == kernel
    calls = []
    for name in ("flash_decode_attention", "flash_gqa_attention"):
        monkeypatch.setattr(T, name, lambda *a, _n=name: calls.append(_n) or "kernel")
    monkeypatch.setattr(T, "FLASH_PREFILL_SCORES_BYTES", 0)
    plain = []
    monkeypatch.setattr(T, "gqa_attention", lambda *a: plain.append(1) or "plain")
    kc = torch.zeros(1, 8, 2 * D)
    for Tn in (1, 4):
        q = torch.zeros(1, Tn, 4, D)
        got = T._attend(q, kc, kc, torch.arange(Tn), 0)
        assert got == ("kernel" if kernel else "plain")
    assert calls == (["flash_decode_attention", "flash_gqa_attention"] if kernel else [])


def test_gemma_decode_attends_on_the_plain_path(files, monkeypatch):
    """A head_dim-24 model (the tiny gemma; 256 at full width) never calls
    a decode kernel's wrapper: a wrapper that raises changes nothing."""
    def refuse(*a, **k):
        raise AssertionError("attention kernel called for an unsupported head_dim")

    for name in ("flash_decode_attention", "flash_decode_fused", "flash_gqa_attention"):
        monkeypatch.setattr(T, name, refuse)
    tp, tc = T.load_model(jgg.GGUFFile(files[("gemma", False)]))
    assert not kernel_head_dim(tc.head_dim)
    cache = T.init_cache(tc, 1, 16)
    _, cache = T.forward(tp, tc, torch.tensor([[1, 4, 5]]), cache, 0)
    T.decode_step(tp, tc, torch.tensor([6]), cache, 3, defer_kv=True)


@pytest.mark.parametrize("arch,takes_k7", [("gemma", False), ("llama_linear", True),
                                           ("phi2", False), ("moe", False)])
def test_megakernel_gate(files, arch, takes_k7, monkeypatch):
    """TPU_LLM_FFN_MEGAKERNEL set, bf16 activations over q8_0 weights: the
    SiLU-gated llama takes K7 (ffn_fused); GeGLU gemma, phi-2's GELU MLP
    and the MoE FFN never do (the JAX gate's cfg.act == "silu"). Gemma's
    logits with the switch equal its logits without it."""
    tp, tc = T.load_model(jgg.GGUFFile(files[(arch, True)]), dtype_policy="native")
    toks = torch.tensor([[1, 4, 5]])

    def logits():
        cache = T.init_cache(tc, 1, 16)
        _, cache = T.forward(tp, tc, toks, cache, 0)
        return T.decode_step(tp, tc, torch.tensor([6]), cache, 3)[0]

    off = logits()
    calls = []
    ffn = T.ffn_fused
    monkeypatch.setattr(T, "ffn_fused", lambda *a: calls.append(1) or ffn(*a))
    monkeypatch.setenv("TPU_LLM_FFN_MEGAKERNEL", "1")
    on = logits()
    assert bool(calls) == takes_k7
    assert T._use_ffn_megakernel(tc, torch.zeros(1, 1, tc.dim, dtype=torch.bfloat16),
                                 tp["layers"][0]) == takes_k7
    if not takes_k7:
        assert torch.equal(on, off)


@pytest.mark.parametrize("flags,folded", [
    (dict(), True), (dict(use_layernorm=True), False), (dict(parallel_block=True), False)])
def test_norm_fold_gate(flags, folded, monkeypatch):
    """TPU_LLM_NORM_FOLD set: an rmsnorm model hands its weight to the
    projection as row_scale; a LayerNorm model or a parallel block keeps
    the weighted norm (the JAX gate)."""
    monkeypatch.setenv("TPU_LLM_NORM_FOLD", "1")
    cfg = tconfig.LlamaConfig(dim=8, hidden_dim=8, n_layers=1, n_heads=2, n_kv_heads=2,
                              vocab_size=8, **flags)
    lp = {"attn_norm": torch.full((8,), 2.0), "attn_norm_b": torch.zeros(8)}
    h, rs = T._norm_folded(cfg, torch.randn(1, 1, 8), lp, "attn")
    assert (rs is not None) == folded
    monkeypatch.delenv("TPU_LLM_NORM_FOLD")
    assert T._norm_folded(cfg, torch.randn(1, 1, 8), lp, "attn")[1] is None


# -- the CLIs ----------------------------------------------------------------

CLI_ARCHS = ["qwen2", "gemma", "phi2", "moe"]


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_llm_cli_matches_jax(files, arch, capfdbinary):
    """`llm` on each tiny family file prints the JAX CLI's greedy text
    (f32), and the same with --scan."""
    args = ["-m", files[(arch, False)], "-p", "abc", "-n", "10", "--dtype", "f32"]
    capfdbinary.readouterr()
    assert jcli.main(args) == 0
    want = capfdbinary.readouterr().out.split(b"\n")[0]
    for extra in ([], ["--scan"]):
        assert tcli.main(args + extra + ["--device", "cpu"]) == 0
        got = capfdbinary.readouterr().out.split(b"\n")[0]
        assert got == want and got.startswith(b"abc") and len(got) > 3


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_llm_serve_matches_jax(files, arch, capsys):
    """`llm-serve` (dense, and --paged for the port) on each tiny family
    file: the JAX front end's completions."""
    def run(main, argv):
        capsys.readouterr()
        assert main(argv) == 0
        return [(r["prompt"], r["completion"], r["n_tokens"]) for r in
                (json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{"))]

    argv = ["-m", files[(arch, False)], "-p", "abc", "-p", "ab ab", "-p", "c", "-n", "5",
            "--batch", "2", "--dtype", "f32", "--cache-dtype", "f32"]
    want = run(jserve.main, argv)
    assert len(want) == 3
    assert run(tserve.main, argv + ["--device", "cpu"]) == want
    assert run(tserve.main, argv + ["--paged", "--block-size", "4", "--device", "cpu"]) == want


def test_phi2_load_keeps_qkv_dense(files):
    """phi-2's q / k / v load dense under "native" (fused with their biases
    into wqkv / bqkv), its other projections packed, as the reference's
    loader leaves them."""
    from tpu_llm_torch.quant.qtensor import QTensor

    tp, _ = TP.load_gguf(files[("phi2", True)], dtype_policy="native")
    lp = tp["layers"][0]
    assert not isinstance(lp["wqkv"], QTensor) and lp["wqkv"].dtype == torch.float32
    assert lp["bqkv"].shape == (3 * 64,)
    assert all(isinstance(lp[k], QTensor) for k in ("wo", "w3", "w2"))


@pytest.mark.parametrize("fuse", [True, False], ids=["bqkv", "bq_bk_bv"])
def test_rope_fold_permutes_the_biases(files, fuse):
    """fold_rope_interleave on a biased model (the tiny qwen2 run with the
    interleaved pairing): the biases take the columns' permutation, so the
    folded neox model gives the unfolded model's logits (f32, 2e-4); a
    partial-rope model is left as it is, as in the JAX package."""
    import dataclasses

    from tpu_llm_torch.quant.convert_params import fold_rope_interleave

    tp, tc = T.load_gguf(files[("qwen2", False)], fuse=fuse)
    tc = dataclasses.replace(tc, rope_variant="interleaved")
    fp, fc = fold_rope_interleave(tp, tc)
    assert fc.rope_variant == "neox"
    toks = torch.tensor([[1, 4, 9, 7]])
    want = T.lm_head(tp, tc, T.forward(tp, tc, toks, T.init_cache(tc, 1, 16), 0)[0])
    got = T.lm_head(fp, fc, T.forward(fp, fc, toks, T.init_cache(fc, 1, 16), 0)[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    pc = dataclasses.replace(tc, rope_dims=8)
    assert fold_rope_interleave(tp, pc) == (tp, pc)


@pytest.mark.parametrize("arch,timed", [("moe", False), ("phi2", False), ("gemma", False),
                                        ("qwen2", True)])
def test_llm_timings_by_layout(files, arch, timed, capfd):
    """`llm --timings` times the buckets of a dense llama-layout model
    (qwen2 here) and names the layouts it does not cover (MoE, a parallel
    block, a q width other than dim) instead of stopping."""
    capfd.readouterr()
    assert tcli.main(["-m", files[(arch, False)], "-p", "abc", "-n", "6", "--dtype", "f32",
                      "--timings", "--device", "cpu"]) == 0
    out = capfd.readouterr().out
    assert ("covers dense llama-layout models" in out) == (not timed)
    assert ("qkv" in out) == timed
