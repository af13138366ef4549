"""The port's ``--scan`` slice against the JAX package on the CPU: the
int4-plane weight transform (``to_int4``, ``pack_scales_f16``,
``pack_scales_bf16``, ``unpack_params_int4``), kernel 1's plain twin on
q4_0i4 weights against ``qmatmul_pallas(interpret=True)``, the graph
decode loop and every speculative mode of ``Engine.generate``, and the
phase-timing helpers."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.test_llama import CFG as JCFG
from tests.test_llama import make_weights, to_params
from tests.test_torch_llama import to_numpy
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.quant import convert_params as jconv
from tpu_llm.quant import qtensor as jq
from tpu_llm.quant.pallas_matmul import qmatmul_pallas
from tpu_llm.runtime import engine as jengine
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models import llama as T
from tpu_llm_torch.quant import convert_params as tconv
from tpu_llm_torch.quant import qmatmul as tqm
from tpu_llm_torch.quant import qtensor as tq
from tpu_llm_torch.runtime import engine as tengine

# source kind -> (codec, layout switch that yields it)
SOURCES = {"q4_0": ("q4_0", None), "q4_1": ("q4_1", None),
           "q2_kp": ("q2_k", None), "q3_kp": ("q3_k", None)}


def _from_jax(jqt) -> tq.QTensor:
    """A JAX QTensor (int4 value planes and int16 / bf16 planes included)
    as a port QTensor."""
    return tq.qtensor_from_numpy(
        np.asarray(jqt.q), np.asarray(jqt.scales), jqt.kind,
        None if jqt.mins is None else np.asarray(jqt.mins))


def _jax_source(monkeypatch, kind, planes, K=256, N=96, seed=5):
    """The JAX package's QTensor of ``kind`` with f32 or bf16 planes (K 256:
    the K-quant superblock), from a seeded normal weight."""
    codec, switch = SOURCES[kind]
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    with monkeypatch.context() as m:
        if switch:
            m.setenv(switch, "1")
        if planes == "f32":
            m.setenv("TPU_LLM_KQ_F32S", "1")
        jqt = jq.quantize_tensor(w, codec)
    if planes == "bf16":
        jqt = jq.pack_scales_bf16(jqt)
    assert jqt.kind == kind
    return jqt


def _deq(t: tq.QTensor) -> np.ndarray:
    return tq.dequantize(t, torch.float32).numpy()


def _jdeq(j) -> np.ndarray:
    return np.asarray(jq.dequantize(j, jnp.float32))


# -- the weight transform -------------------------------------------------------

@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", list(SOURCES))
def test_to_int4_matches_jax_bit_for_bit(monkeypatch, kind, planes):
    jqt = _jax_source(monkeypatch, kind, planes)
    ji = jax.jit(jq.to_int4)(jqt)
    ti = tq.to_int4(_from_jax(jqt))
    assert ti.kind == ji.kind == "q4_0i4" and ti.shape == tuple(ji.shape)
    assert ti.scales.dtype == tq.plane_from_numpy(np.asarray(ji.scales)).dtype
    assert (ti.mins is None) == (ji.mins is None)
    np.testing.assert_array_equal(_deq(ti), _jdeq(ji))
    # the port packs the JAX int4 plane into its nibble layout byte for byte
    assert torch.equal(_from_jax(ji).q, ti.q)


@pytest.mark.parametrize("packer", ["f16", "bf16"])
@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", list(SOURCES))
def test_pack_scales_match_jax_bit_for_bit(monkeypatch, kind, planes, packer):
    jqt = _jax_source(monkeypatch, kind, planes)
    jpack = getattr(jq, f"pack_scales_{packer}")
    tpack = getattr(tq, f"pack_scales_{packer}")
    ji = jax.jit(lambda q: jpack(jq.to_int4(q)))(jqt)
    ti = tpack(tq.to_int4(_from_jax(jqt)))
    assert ti.scales.dtype == {"f16": torch.int16, "bf16": torch.bfloat16}[packer]
    np.testing.assert_array_equal(_deq(ti), _jdeq(ji))
    np.testing.assert_array_equal(_deq(_from_jax(ji)), _deq(ti))
    # packing int16 planes again, in either form, is a no-op (JAX: the same)
    if packer == "f16":
        assert tq.pack_scales_bf16(ti) is ti and tq.pack_scales_f16(ti) is ti


def test_unpack_scales_f16_exact_on_subnormals():
    bits = np.asarray([0x0001, 0x03FF, 0x0400, 0x3C00, 0x8001, 0x7BFF], np.uint16)
    got = tq.unpack_scales_f16(torch.from_numpy(bits.view(np.int16)))
    want = np.asarray(jq.unpack_scales_f16(jnp.asarray(bits.view(np.int16))))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), bits.view(np.float16).astype(np.float32))


def _jax_tree(codec="q4_0"):
    w = np.random.default_rng(7).standard_normal((64, 128)).astype(np.float32)
    return {"tok_emb": jnp.ones((8, 64), jnp.float32), "final_norm": jnp.ones((64,)),
            "wcls": jq.quantize_tensor(w, codec),
            "layers": [{"wq": jq.quantize_tensor(w, codec), "w2": jq.quantize_tensor(w, "q8_0"),
                        "attn_norm": jnp.ones((64,), jnp.float32)}]}


def _port_tree(jtree):
    def leaf(v):
        if isinstance(v, jq.QTensor):
            return _from_jax(v)
        return tq.plane_from_numpy(np.asarray(v))
    out = {k: leaf(v) for k, v in jtree.items() if k != "layers"}
    out["layers"] = [{k: leaf(v) for k, v in lp.items()} for lp in jtree["layers"]]
    return out


@pytest.mark.parametrize("pack", [False, True, "f16", "bf16"])
@pytest.mark.parametrize("codec", ["q4_0", "q4_1"])
def test_unpack_params_int4_matches_jax(codec, pack):
    jtree = _jax_tree(codec)
    jout = jax.jit(lambda p: jconv.unpack_params_int4(p, pack_scales=pack))(jtree)
    tout = tconv.unpack_params_int4(_port_tree(jtree), pack_scales=pack)
    for jw, tw in ((jout["wcls"], tout["wcls"]), (jout["layers"][0]["wq"], tout["layers"][0]["wq"]),
                   (jout["layers"][0]["w2"], tout["layers"][0]["w2"])):
        assert tw.kind == jw.kind
        assert str(tw.scales.dtype).replace("torch.", "") == str(np.asarray(jw.scales).dtype)
        np.testing.assert_array_equal(_deq(tw), _jdeq(jw))
    assert tout["layers"][0]["w2"].kind == "q8_0"          # q8_0 is left as it is
    assert tout["layers"][0]["w2"].scales.dtype == torch.float32
    assert torch.equal(tout["tok_emb"], _port_tree(jtree)["tok_emb"])


def test_unpack_params_int4_shares_value_planes():
    """q4_0 -> q4_0i4 changes no byte: the int4 weights share the loaded
    value (and f32 scale) planes, so the graph loop keeps one copy."""
    tree = _port_tree(_jax_tree("q4_0"))
    out = tconv.unpack_params_int4(tree)
    assert out["wcls"].q is tree["wcls"].q and out["wcls"].scales is tree["wcls"].scales
    with pytest.raises(ValueError):
        tconv.unpack_params_int4(tree, pack_scales="f8")


@pytest.mark.parametrize("pack", [False, "f16", "bf16"])
def test_params_from_numpy_of_jax_int4_tree(pack):
    """The JAX package's unpack_params_int4 tree (int4 planes, int16 /
    bf16 scale planes), carried across with params_from_numpy, gives the
    port's own transform's dequantized weights."""
    from tests.test_torch_llama import jax_params
    from tpu_llm.models.llama import unstack_layers

    # per-layer (unstacked) planes: the JAX transform leaves stacked ones alone
    jp = unstack_layers(jax_params("q4_0"))
    jint4 = jax.jit(lambda p: jconv.unpack_params_int4(p, pack_scales=pack))(jp)
    got = T.params_from_numpy(to_numpy(jint4))
    want = tconv.unpack_params_int4(T.params_from_numpy(to_numpy(jp)), pack_scales=pack)
    for lg, lw in zip(got["layers"] + [got], want["layers"] + [want]):
        for k in ("wqkv", "wo", "w13", "w2", "wcls"):
            if k in lg:
                assert lg[k].kind == lw[k].kind == "q4_0i4"
                assert lg[k].scales.dtype == lw[k].scales.dtype
                np.testing.assert_array_equal(_deq(lg[k]), _deq(lw[k]))


# -- kernel 1's twin on q4_0i4 --------------------------------------------------

def _int4_pair(monkeypatch, kind, planes, subnormal=False):
    """(JAX q4_0i4, port q4_0i4) from ``kind``; ``planes`` f32, bf16 or
    int16 (f16 bits of the f32 planes); ``subnormal`` scales the first 32
    rows down to f16-subnormal scales."""
    jqt = _jax_source(monkeypatch, kind, "bf16" if planes == "bf16" else "f32")
    if subnormal:
        w = np.random.default_rng(5).standard_normal((256, 96)).astype(np.float32) * 0.05
        w[:32] *= 1e-7
        jqt = jq.quantize_tensor(w, "q4_0")
    ji = jax.jit(jq.to_int4)(jqt)
    if planes == "int16":
        ji = jax.jit(jq.pack_scales_f16)(ji)
        assert np.asarray(ji.scales).dtype == np.int16
    return ji, _from_jax(ji)


def _x_rs(rows, with_rs, seed=3):
    rng = np.random.default_rng(seed + rows)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    rs = (1.0 + 0.2 * rng.standard_normal(256)).astype(np.float32) if with_rs else None
    return x, rs


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("planes", ["f32", "bf16", "int16"])
@pytest.mark.parametrize("kind", list(SOURCES))
def test_int4_plain_matches_pallas_interpret_f32(monkeypatch, kind, planes, rows, with_rs):
    ji, ti = _int4_pair(monkeypatch, kind, planes)
    x, rs = _x_rs(rows, with_rs)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), ji, interpret=True,
                                     row_scale=None if rs is None else jnp.asarray(rs)))
    got = tqm.qmatmul(torch.from_numpy(x), ti,
                      row_scale=None if rs is None else torch.from_numpy(rs))
    assert got.dtype == torch.float32 and tqm.qmatmul.launches == 0
    # the tolerance tests/test_torch_qmatmul.py uses for the same kinds
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("planes", ["f32", "bf16", "int16"])
@pytest.mark.parametrize("kind", list(SOURCES))
def test_int4_plain_matches_pallas_interpret_bf16(monkeypatch, kind, planes, rows, with_rs):
    """bf16 activations: one bf16 rounding of sums that may differ by the
    f32 tolerance (tests/test_torch_qmatmul.py)."""
    ji, ti = _int4_pair(monkeypatch, kind, planes)
    x, rs = _x_rs(rows, with_rs)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(qmatmul_pallas(xb, ji, interpret=True,
                                     row_scale=None if rs is None else jnp.asarray(rs))
                      .astype(jnp.float32))
    got = tqm.qmatmul(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(), ti,
                      row_scale=None if rs is None else torch.from_numpy(rs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2e-4)


@pytest.mark.parametrize("rows", [1, 8])
def test_int4_f16_bit_planes_subnormal_scales_exact(monkeypatch, rows):
    """f16-subnormal scales (near-zero blocks) through int16 planes: the
    twin equals the Pallas kernel on the same planes, and equals the f32
    planes' result exactly (the bits decode exactly)."""
    ji, ti = _int4_pair(monkeypatch, "q4_0", "int16", subnormal=True)
    sbits = np.asarray(ji.scales).view(np.uint16)
    assert ((sbits & 0x7C00) == 0).any() and (sbits & 0x03FF).any()   # subnormals present
    x, _ = _x_rs(rows, False)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), ji, interpret=True))
    got = tqm.qmatmul(torch.from_numpy(x), ti)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    f32 = tq.QTensor(ti.q, tq.unpack_scales_f16(ti.scales), "q4_0i4")
    assert torch.equal(got, tqm.qmatmul(torch.from_numpy(x), f32))


# -- the engine: graph loop and speculation ------------------------------------

def _engines(seed=0, weights="dense"):
    """The JAX engine and the port's CPU engine on tests/test_llama.py's
    tiny model (seq_len 16: the speculative loops reach the tail), or, for
    packed weights, tests/test_torch_llama.py's (contraction dims of 32s)."""
    if weights == "dense":
        cfg, jp = JCFG, to_params(make_weights(seed))
    else:
        from tests.test_torch_llama import CFG, jax_params

        cfg, jp = CFG, jax_params(weights, seed=seed)
    je = jengine.Engine(jp, jengine.ModelAdapter.llama(JConfig(**cfg), bos_id=1),
                        max_seq=cfg["seq_len"])
    te = tengine.Engine(T.params_from_numpy(to_numpy(jp)),
                        tengine.ModelAdapter.llama(TConfig(**cfg), bos_id=1, device="cpu"),
                        max_seq=cfg["seq_len"], device="cpu")
    return je, te


PROMPTS = ([5, 11], [4, 7, 4, 7, 4, 7])


@pytest.mark.parametrize("weights", ["dense", "q4_0"])
def test_scan_greedy_matches_jax_and_step_loop(weights):
    je, te = _engines(weights=weights)
    for prompt in PROMPTS:
        want = je.generate(prompt, n_new=10, use_scan=True).tokens
        assert want == je.generate(prompt, n_new=10).tokens
        assert te.generate(prompt, n_new=10, use_scan=True).tokens == want
        assert te.generate(prompt, n_new=10).tokens == want
    # the captured step (eager here) and its buffers serve a later call
    assert len(te._graphs) == 1
    assert te.generate(PROMPTS[0], n_new=10, use_scan=True).tokens == \
        je.generate(PROMPTS[0], n_new=10).tokens


def test_scan_sampling_is_deterministic_per_seed():
    _, te = _engines(seed=1)
    a = te.generate([4], n_new=10, temperature=0.9, seed=42, use_scan=True).tokens
    b = te.generate([4], n_new=10, temperature=0.9, seed=42, use_scan=True).tokens
    c = te.generate([4], n_new=10, temperature=0.9, seed=43, use_scan=True).tokens
    assert a == b and len(a) == 11 and all(0 <= t < JCFG["vocab_size"] for t in a)
    assert a != c


@pytest.mark.parametrize("mode", ["host", "device", "draft_same", "draft_other"])
def test_speculation_equals_plain_greedy(mode):
    """Every speculative mode emits exactly the plain greedy stream, on
    repetitive prompts (drafts accept) and others (drafts reject), with the
    plain-step tail near the end of the 16-token window."""
    je, te = _engines()
    draft = None
    if mode.startswith("draft"):
        _, draft = _engines(seed=0 if mode == "draft_same" else 3)
    for prompt in PROMPTS:
        base = je.generate(prompt, n_new=10).tokens
        got = te.generate(prompt, n_new=10, speculative_k=3, use_scan=mode == "device",
                          draft=draft)
        assert got.tokens == base, (mode, prompt)
    if mode == "device":
        want = je.generate(PROMPTS[1], n_new=10, use_scan=True, speculative_k=3)
        assert want.tokens == base
        assert te.stats["spec_forwards"] > 0
        assert te.stats["spec_tokens"] >= te.stats["spec_forwards"]
        # one read of the loop's condition a verify forward
        assert te.stats["spec_host_syncs"] == te.stats["spec_forwards"]
    else:
        assert te.stats["spec_forwards"] == 0


def test_speculation_with_k1_and_k6_matches_plain():
    je, te = _engines()
    prompt = [5, 11, 5, 11, 5]
    for k in (1, 6):
        for scan in (False, True):
            assert te.generate(prompt, n_new=9, speculative_k=k, use_scan=scan).tokens == \
                je.generate(prompt, n_new=9).tokens, (k, scan)


def test_scan_with_draft_runs_the_plain_graph_loop():
    """The JAX routing: use_scan with a draft engine is the graph loop
    (device speculation is prompt lookup only)."""
    je, te = _engines()
    _, draft = _engines(seed=3)
    got = te.generate([5, 11], n_new=10, use_scan=True, speculative_k=3, draft=draft)
    assert got.tokens == je.generate([5, 11], n_new=10).tokens
    assert te.stats["spec_forwards"] == 0 and ("decode", 0.0) in te._graphs


def test_draft_vocab_mismatch_is_refused():
    _, te = _engines()
    cfg2 = dataclasses.replace(TConfig(**JCFG), vocab_size=JCFG["vocab_size"] + 8)
    bad = tengine.Engine(te.params, tengine.ModelAdapter.llama(cfg2, bos_id=1, device="cpu"),
                         max_seq=JCFG["seq_len"], device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        te.generate([5], n_new=4, speculative_k=2, draft=bad)


def test_lookup_draft_matches_jax():
    ctx = [1, 5, 7, 8, 2, 5, 7]
    for k in (0, 1, 2, 5):
        assert tengine._lookup_draft(ctx, k) == jengine._lookup_draft(ctx, k)
    assert tengine._lookup_draft([1, 2, 3], 2) == jengine._lookup_draft([1, 2, 3], 2) == []
    assert tengine._lookup_draft([1], 3) == []


def test_adapter_fields_match_jax():
    ta = tengine.ModelAdapter.llama(TConfig(**JCFG), device="cpu")
    ja = jengine.ModelAdapter.llama(JConfig(**JCFG))
    assert ta.positional_state is ja.positional_state is True
    assert ta.vocab_size == ja.vocab_size == JCFG["vocab_size"]


# -- timing helpers --------------------------------------------------------------

def test_phase_timing_buckets_finite(monkeypatch):
    from tpu_llm.runtime import phase_timing as jpt
    from tpu_llm_torch.quant import linear
    from tpu_llm_torch.runtime import phase_timing as tpt

    assert tpt.BUCKETS == jpt.BUCKETS
    from tests.test_torch_llama import CFG

    kinds = set()
    matmul = linear.matmul

    def spy(x, w, *a, **kw):
        kinds.add(getattr(w, "kind", None))
        return matmul(x, w, *a, **kw)

    monkeypatch.setattr(linear, "matmul", spy)
    _, te = _engines(weights="q4_0")
    for int4 in (False, True):
        kinds.clear()
        times = tpt.measure_phase_times(te.params, TConfig(**CFG), pos=6,
                                        max_seq=CFG["seq_len"], n1=2, n2=5, int4=int4)
        # int4=True times the graph loop's weights: the q4 family as q4_0i4
        assert kinds == ({"q4_0i4"} if int4 else {"q4_0"})
        assert set(times) == set(tpt.BUCKETS)
        assert all(np.isfinite(v) for v in times.values())
        report = tpt.format_report(times).splitlines()
        assert report == jpt.format_report(times).splitlines() and len(report) == 6


def test_slope_time_cancels_the_constant(monkeypatch):
    from tpu_llm_torch.runtime import timing

    clock = {"t": 0.0}

    def make(n):
        def run():
            clock["t"] += 0.5 + 0.01 * n          # fixed cost + per-step cost
        return run

    monkeypatch.setattr(timing.time, "perf_counter", lambda: clock["t"])
    assert timing.slope_time_s(make, 4, 20) == pytest.approx(0.01)
