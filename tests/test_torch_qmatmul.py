"""The plain twin of the port's qmatmul kernel against the Pallas kernel it
replaces (tpu_llm.quant.pallas_matmul.qmatmul_pallas, interpret mode) on
the same packed weights — every kind but q4_0i4, f32 and bf16 planes, with
and without row_scale — and the linear dispatch (row_scale, K-padded
weights) against tpu_llm's."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tpu_llm.quant import linear as jlinear
from tpu_llm.quant import qtensor as jq
from tpu_llm.quant.pallas_matmul import qmatmul_pallas
from tpu_llm_torch.quant import linear as tlinear
from tpu_llm_torch.quant import qmatmul as tqm
from tpu_llm_torch.quant import qtensor as tq
from tests.test_torch_kquant import to_torch


def _pair(kind, K, N, seed):
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    return jq.quantize_tensor(w, kind), tq.quantize_tensor(w, kind)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows", [1, 3, 8, 37])
def test_plain_matches_pallas_interpret_f32(kind, rows):
    jqt, tqt = _pair(kind, 128, 256, 3)
    x = np.random.default_rng(rows).standard_normal((rows, 128)).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, interpret=True))
    got = tqm.qmatmul(torch.from_numpy(x), tqt)
    assert got.dtype == torch.float32 and tqm.qmatmul.launches == 0
    # the tolerance of tests/test_quant.py for the same kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows", [1, 3, 8, 37])
def test_plain_matches_pallas_interpret_bf16(kind, rows):
    """bf16 activations: both accumulate in f32 (the interpret-mode kernel
    computes its dot in f32 on the CPU) and round the output to bf16, so
    they may differ by one bf16 ulp (<= 2^-7 relative)."""
    jqt, tqt = _pair(kind, 128, 256, 4)
    xb = jnp.asarray(np.random.default_rng(rows).standard_normal((rows, 128)),
                     jnp.bfloat16)
    want = np.asarray(qmatmul_pallas(xb, jqt, interpret=True).astype(jnp.float32))
    x_t = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    got = tqm.qmatmul(x_t, tqt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=0)


def test_3d_input_and_out_dtype():
    jqt, tqt = _pair("q4_0", 64, 128, 5)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64)).astype(np.float32)).bfloat16()
    # the reference sees the same bf16 values, as f32
    want = np.asarray(qmatmul_pallas(jnp.asarray(x.float().numpy()), jqt,
                                     interpret=True))
    got = tqm.qmatmul(x, tqt, out_dtype=torch.float32)
    assert tuple(got.shape) == (2, 3, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("rows,K,N", [(1, 2048, 2560), (1, 5632, 2048),
                                      (1, 2048, 32000), (512, 2048, 11264),
                                      (3, 96, 32)])
def test_k_split_covers_k(rows, K, N):
    ks, kbps = tqm.k_split(rows, K, N, 132)      # the H100 SXM's SMs
    nkb = K // 32
    assert ks >= 1 and (ks - 1) * kbps < nkb <= ks * kbps


@pytest.mark.parametrize("weight", ["dense", "q4_0", "q8_0"])
def test_linear_matmul_matches_jax(weight):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    if weight == "dense":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw, tw = jq.quantize_tensor(w, weight), tq.quantize_tensor(w, weight)
    want = np.asarray(jlinear.matmul(jnp.asarray(x), jw))
    got = tlinear.matmul(torch.from_numpy(x), tw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# -- every other kind of _PALLAS_KINDS but q4_0i4 -----------------------------

# kind -> (codec, layout switch that yields it)
KIND_SOURCES = {"q4_1": ("q4_1", None), "q5_0": ("q5_0", None), "q5_1": ("q5_1", None),
                "q2_k": ("q2_k", "TPU_LLM_Q23_INT8"), "q2_kp": ("q2_k", None),
                "q3_k": ("q3_k", "TPU_LLM_Q23_INT8"), "q3_kp": ("q3_k", None),
                "q6_k": ("q6_k", None), "q6_kp": ("q6_k", "TPU_LLM_Q6K_PACK")}


def _kind_pair(monkeypatch, kind, planes, K=256, N=128, seed=11):
    """The JAX package's QTensor of ``kind`` with f32 or bf16 scale (and
    mins) planes, and the same planes as a port QTensor."""
    codec, switch = KIND_SOURCES[kind]
    with monkeypatch.context() as m:
        if switch:
            m.setenv(switch, "1")
        if planes == "f32":
            m.setenv("TPU_LLM_KQ_F32S", "1")
        w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
        jqt = jq.quantize_tensor(w, codec)
    if planes == "bf16":
        jqt = jq.pack_scales_bf16(jqt) if kind != "q6_kp" else jqt
    assert jqt.kind == kind
    assert str(jqt.scales.dtype) == ("bfloat16" if planes == "bf16" else "float32")
    return jqt, to_torch(jqt)


def _row_scale(with_rs, K=256):
    if not with_rs:
        return None, None
    rs = (1.0 + 0.2 * np.random.default_rng(K).standard_normal(K)).astype(np.float32)
    return jnp.asarray(rs), torch.from_numpy(rs)


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("rows", [1, 3, 8, 37])
@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", list(KIND_SOURCES))
def test_kinds_plain_matches_pallas_interpret_f32(monkeypatch, kind, planes, rows, with_rs):
    jqt, tqt = _kind_pair(monkeypatch, kind, planes)
    jrs, trs = _row_scale(with_rs)
    x = np.random.default_rng(rows).standard_normal((rows, 256)).astype(np.float32)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, row_scale=jrs, interpret=True))
    got = tqm.qmatmul(torch.from_numpy(x), tqt, row_scale=trs)
    assert got.dtype == torch.float32
    # the tolerance of tests/test_quant.py for the same kernel and kinds
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("rows", [1, 3, 8, 37])
@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", list(KIND_SOURCES))
def test_kinds_plain_matches_pallas_interpret_bf16(monkeypatch, kind, planes, rows, with_rs):
    """bf16 activations: both sides accumulate in f32 and round the output
    to bf16 once, so they differ by at most one bf16 ulp (2^-7 relative)
    of sums that may differ by the f32 tolerance above (atol 2e-4)."""
    jqt, tqt = _kind_pair(monkeypatch, kind, planes)
    jrs, trs = _row_scale(with_rs)
    xb = jnp.asarray(np.random.default_rng(rows).standard_normal((rows, 256)), jnp.bfloat16)
    want = np.asarray(qmatmul_pallas(xb, jqt, row_scale=jrs, interpret=True)
                      .astype(jnp.float32))
    got = tqm.qmatmul(torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16(), tqt,
                      row_scale=trs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2e-4)


@pytest.mark.parametrize("codec", ["q4_0", "q4_1", "q6_k"])
def test_linear_matmul_k_padded_matches_jax(codec):
    """linear.matmul over a pad_k QTensor (K 768 -> 1024) zero-pads x and
    row_scale: the JAX package's result, and the unpadded one."""
    rng = np.random.default_rng(8)
    w = rng.standard_normal((768, 64)).astype(np.float32)
    x = rng.standard_normal((3, 768)).astype(np.float32)
    rs = (1.0 + 0.1 * rng.standard_normal(768)).astype(np.float32)
    jqt, tqt = jq.quantize_tensor(w, codec), tq.quantize_tensor(w, codec)
    want = np.asarray(jlinear.matmul(jnp.asarray(x), jq.pad_k(jqt), row_scale=jnp.asarray(rs)))
    got = tlinear.matmul(torch.from_numpy(x), tq.pad_k(tqt), row_scale=torch.from_numpy(rs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    unpadded = tlinear.matmul(torch.from_numpy(x), tqt, row_scale=torch.from_numpy(rs))
    np.testing.assert_allclose(got.numpy(), unpadded.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weight", ["dense", "q4_1", "q3_k"])
def test_linear_row_scale_matches_jax(weight):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((256, 96)).astype(np.float32)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    rs = (1.0 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    if weight == "dense":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw, tw = jq.quantize_tensor(w, weight), tq.quantize_tensor(w, weight)
    want = np.asarray(jlinear.matmul(jnp.asarray(x), jw, row_scale=jnp.asarray(rs)))
    got = tlinear.matmul(torch.from_numpy(x), tw, row_scale=torch.from_numpy(rs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# -- the kernel's arithmetic: per-k16 sums, scales on the sums, x' in parts ----

EVERY_KIND = ["q4_0", "q4_0i4", "q8_0", *KIND_SOURCES]


def _every_kind_pair(monkeypatch, kind, planes, K=256, N=128, seed=12):
    """Any kind of _KIND_CODE as a JAX QTensor and the port's, f32 or bf16
    planes; q4_0i4 is to_int4 of q4_0 on each side (bit-equal:
    tests/test_torch_scan.py)."""
    if kind in KIND_SOURCES:
        return _kind_pair(monkeypatch, kind, planes, K, N, seed)
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    jqt = jq.quantize_tensor(w, "q4_0" if kind == "q4_0i4" else kind)
    tqt = to_torch(jqt)
    if kind == "q4_0i4":
        jqt, tqt = jq.to_int4(jqt), tq.to_int4(tqt)
    if planes == "bf16":
        jqt, tqt = jq.pack_scales_bf16(jqt), tq.pack_scales_bf16(tqt)
    assert tqt.kind == kind and tqt.scales.dtype == (
        torch.bfloat16 if planes == "bf16" else torch.float32)
    return jqt, tqt


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", EVERY_KIND)
def test_blocked_plain_matches_pallas_interpret(monkeypatch, kind, planes, with_rs):
    """qmatmul_blocked_plain (the kernel's order: integer values, per-k16
    f32 sums, the scale on each sum, f32 x' as hi + mid + lo bf16 parts)
    against qmatmul_pallas in interpret mode, rows 1, 5, 8 and 37. f32 x:
    the f32 tolerance of tests/test_quant.py (rtol 2e-5, atol 2e-4): the
    three parts hold all of x', so only the order of the f32 sums differs.
    bf16 x (5 rows): one bf16 rounding of the output on each side, as in
    test_kinds_plain_matches_pallas_interpret_bf16. And against the plain
    twin, which dequantizes first: the same f32 tolerance."""
    jqt, tqt = _every_kind_pair(monkeypatch, kind, planes)
    jrs, trs = _row_scale(with_rs)
    for rows in (1, 5, 8, 37):
        x = np.random.default_rng(100 + rows).standard_normal((rows, 256)).astype(np.float32)
        want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, row_scale=jrs, interpret=True))
        got = tqm.qmatmul_blocked_plain(torch.from_numpy(x), tqt, row_scale=trs)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
        twin = tqm.qmatmul_plain(torch.from_numpy(x), tqt, row_scale=trs)
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=2e-5, atol=2e-4)
    xb = jnp.asarray(np.random.default_rng(5).standard_normal((5, 256)), jnp.bfloat16)
    want = np.asarray(qmatmul_pallas(xb, jqt, row_scale=jrs, interpret=True)
                      .astype(jnp.float32))
    got = tqm.qmatmul_blocked_plain(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                                    .bfloat16(), tqt, row_scale=trs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2e-4)


def test_split3_holds_every_bit_of_f32():
    """hi + mid + lo, each a bf16 value, sum back to the f32 input exactly
    (normal values of either sign and magnitude), so the three products a
    step keep x' unrounded."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = x * torch.logspace(-20, 20, 4096, dtype=torch.float32)
    hi, mid, lo = tqm.split3_bf16(x)
    for p in (hi, mid, lo):
        assert torch.equal(p, p.bfloat16().float())
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(tqm.split3_bf16(x.bfloat16().float())[1], torch.zeros_like(x))


@pytest.mark.parametrize("rows,tile", [(1, 16), (5, 16), (16, 16), (17, 64), (512, 64)])
def test_row_tiles_round_up(rows, tile):
    """One m16 tile up to 16 rows (5 rows: one tile, not two), else
    64-row tiles; k_split reads shapes only and covers K."""
    assert tqm.row_tile(rows) == tile
    ks, kbps = tqm.k_split(rows, 2048, 11264, 132)
    assert (ks - 1) * kbps < 64 <= ks * kbps
    assert kbps >= min(64, tqm._MIN_BLOCKS_PER_SPLIT)


# -- the decode body: which calls take it, and its grid --------------------------

# Qwen2-7B's projections (K, N): wqkv, wo, w13, w2, the classifier
QWEN2_SHAPES = {"wqkv": (3584, 4608), "wo": (3584, 3584), "w13": (3584, 37888),
                "w2": (18944, 3584), "wcls": (3584, 152064)}
H100_SMS = 132


@pytest.mark.parametrize("kind", sorted(tqm._KIND_CODE))
@pytest.mark.parametrize("weight", sorted(QWEN2_SHAPES))
def test_decode_body_takes_nibble_kinds_up_to_decode_rows(kind, weight):
    """The nibble-packed kinds (pack 1) take the decode body at rows 1 ..
    DECODE_ROWS at every Qwen2-7B projection; rows above it, the int8
    kinds and q6_kp (qh plane) take the tensor-core body."""
    K, N = QWEN2_SHAPES[weight]
    pack = tqm._KIND_CODE[kind][0]
    for rows in range(1, tqm.DECODE_ROWS + 1):
        assert tqm.takes_decode(rows, K, N, pack, H100_SMS) == (pack == 1)
    for rows in (tqm.DECODE_ROWS + 1, 16, 17, 512):
        assert not tqm.takes_decode(rows, K, N, pack, H100_SMS)


@pytest.mark.parametrize("rows,K,N,want", [
    (9, 3584, 37888, ((2, 56), 16)), (16, 3584, 4608, ((14, 8), 16)),
    (17, 3584, 18944, ((4, 28), 64)), (512, 3584, 37888, ((1, 112), 64)),
    (1, 3584, 4608, ((14, 8), 16)), (8, 18944, 3584, ((19, 32), 16))])
def test_tensor_core_grid_is_unchanged(rows, K, N, want):
    """The tensor-core body's K split and row tile read what they read
    before the decode body: shapes only, the same numbers."""
    assert (tqm.k_split(rows, K, N, H100_SMS), tqm.row_tile(rows)) == want


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("weight", [*sorted(QWEN2_SHAPES), "ragged", "one_block"])
def test_decode_grid_covers_every_block_once(weight, sms, rows):
    """decode_ranges (the kernel's split, in Python) covers every
    (128-column tile, 32-row block) unit exactly once; at least 7/8 of the
    card's CTA slots are used, and a whole number of CTAs a tile keeps each
    CTA in one tile; each CTA's share is U / G rounded down or up, and CTAs
    dealt round-robin to the SMs leave no SM more than one CTA's share
    (and a unit of rounding) above another; the CTAs the kernel's
    merge counts for a tile, and the partial slot it reads of each, are
    the ones that hold that tile's units; x' fits the CTA's slots and its
    shared memory."""
    K, N = {"ragged": (96, 33), "one_block": (32, 1)}.get(weight) or QWEN2_SHAPES[weight]
    nkb, nt = K // 32, -(-N // 128)
    units = nt * nkb
    ctas, nslot = tqm.decode_grid(rows, K, N, sms)
    slots = sms * tqm.decode_ctas_per_sm(rows)
    assert 7 * min(units, slots) <= 8 * ctas <= 8 * min(units, slots)
    ranges = tqm.decode_ranges(rows, K, N, sms)
    if ctas % nt == 0:                      # a whole number of CTAs a tile
        assert all(len(segs) == 1 for segs in ranges)
    seen = {}
    for i, segs in enumerate(ranges):
        share = sum(b - a for _, a, b in segs)
        assert units // ctas <= share <= -(-units // ctas)
        blocks = set()
        for t, a, b in segs:
            assert 0 <= a < b <= nkb
            blocks.update(range(a, b))
            for kb in range(a, b):
                assert (t, kb) not in seen
                seen[(t, kb)] = i
        assert len(blocks) <= nslot
    assert len(seen) == units
    per_sm = [0] * sms
    for i, segs in enumerate(ranges):
        per_sm[i % sms] += sum(b - a for _, a, b in segs)
    # one CTA's share, and a unit of rounding for each CTA an SM holds
    assert max(per_sm) - min(per_sm) <= -(-units // ctas) + tqm.decode_ctas_per_sm(rows)
    for t in range(nt):
        tu0 = t * nkb
        first = ((tu0 + 1) * ctas - 1) // units
        last = ((tu0 + nkb) * ctas - 1) // units
        owners = sorted({seen[(t, kb)] for kb in range(nkb)})
        assert owners == list(range(first, last + 1))
        for i in owners:
            slot = 0 if i * units // ctas > tu0 else 1
            seg = [s for s in ranges[i] if s[0] == t][0]
            assert slot == (0 if seg[1] > 0 else 1)
    if weight in QWEN2_SHAPES:
        assert tqm.decode_smem(rows, nslot) <= tqm._DECODE_SMEM[tqm.decode_ctas_per_sm(rows)]
