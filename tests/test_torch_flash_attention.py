"""The plain twins of the port's attention kernels (K2 decode, K3 fused
decode + append, K4 prefill) against the Pallas kernels they replace
(tpu_llm.ops.flash_attention, interpret mode), and the port's einsum
attention against tpu_llm.ops.attention. f32, tolerance 2e-5 as in
tests/test_flash_attention.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_llm.ops import attention as jatt
from tpu_llm.ops import flash_attention as jfa
from tpu_llm_torch.ops import attention as tatt
from tpu_llm_torch.ops import flash_attention as tfa
from tpu_llm_torch.quant.qmatmul import split3_bf16

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("pos", [0, 3, 77, 255])
def test_decode_plain_matches_pallas(pos):
    rng = np.random.default_rng(pos)
    B, S, H, Hkv, D = 2, 256, 8, 2, 64
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    positions = np.asarray([pos, max(pos - 2, 0)], np.int32)
    want = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(positions), chunk=64, interpret=True)
    got = tfa.flash_decode_attention(_t(q), _t(k).reshape(B, S, Hkv * D),
                                     _t(v).reshape(B, S, Hkv * D), _t(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tfa.flash_decode_attention.launches == 0


@pytest.mark.parametrize("pos", [0, 5, 8, 63, 190])
@pytest.mark.parametrize("batch", [1, 2])
def test_fused_plain_matches_pallas(pos, batch):
    rng = np.random.default_rng(1000 + pos)
    B, S, H, Hkv, D = batch, 256, 8, 2, 64
    q = _rand(rng, B, 1, H, D)
    kc, vc = _rand(rng, B, S, Hkv * D), _rand(rng, B, S, Hkv * D)
    k_cur, v_cur = _rand(rng, B, 1, Hkv * D), _rand(rng, B, 1, Hkv * D)
    positions = np.asarray([pos], np.int32)
    want, k_new, v_new = jfa.flash_decode_fused(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(k_cur),
        jnp.asarray(v_cur), jnp.asarray(positions), chunk=64, interpret=True)
    tk, tv = _t(kc), _t(vc)
    got, tk2, tv2 = tfa.flash_decode_fused(_t(q), tk, tv, _t(k_cur), _t(v_cur),
                                           _t(positions))
    assert tk2 is tk and tv2 is tv               # appended in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # visible rows equal the reference's appended planes exactly; every
    # other row is untouched
    np.testing.assert_array_equal(tk.numpy()[:, : pos + 1], np.asarray(k_new)[:, : pos + 1])
    np.testing.assert_array_equal(tv.numpy()[:, : pos + 1], np.asarray(v_new)[:, : pos + 1])
    np.testing.assert_array_equal(tk.numpy()[:, pos + 1:], kc[:, pos + 1:])
    np.testing.assert_array_equal(tv.numpy()[:, pos + 1:], vc[:, pos + 1:])


@pytest.mark.parametrize("offset", [0, 7, 30])
def test_prefill_plain_matches_pallas(offset):
    rng = np.random.default_rng(offset)
    B, T, S, H, Hkv, D = 2, 32, 64, 4, 2, 16
    q, k, v = _rand(rng, B, T, H, D), _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    want = jfa.flash_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(offset), block_q=16, block_k=16,
                                   interpret=True)
    got = tfa.flash_gqa_attention(_t(q), _t(k), _t(v), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T,positions", [(1, "row"), (5, "shared"), (5, "per_batch")])
def test_gqa_attention_matches_jax(T, positions):
    rng = np.random.default_rng(T)
    B, S, H, Hkv, D = 2, 32, 4, 2, 16
    q, kc, vc = _rand(rng, B, T, H, D), _rand(rng, B, S, Hkv * D), _rand(rng, B, S, Hkv * D)
    if positions == "row":
        pos = np.asarray([[9], [20]], np.int32)
    elif positions == "shared":
        pos = np.arange(11, 11 + T, dtype=np.int32)
    else:
        pos = np.stack([np.arange(3, 3 + T), np.arange(20, 20 + T)]).astype(np.int32)
    want = jatt.gqa_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              jnp.asarray(pos))
    got = tatt.gqa_attention(_t(q), _t(kc), _t(vc), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [0, 6, 31])
def test_gqa_attention_deferred_matches_jax(pos):
    rng = np.random.default_rng(50 + pos)
    B, S, H, Hkv, D = 2, 32, 4, 2, 16
    q, kc, vc = _rand(rng, B, 1, H, D), _rand(rng, B, S, Hkv * D), _rand(rng, B, S, Hkv * D)
    k_cur, v_cur = _rand(rng, B, 1, Hkv * D), _rand(rng, B, 1, Hkv * D)
    p = np.asarray([pos], np.int32)
    want = jatt.gqa_attention_deferred(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(k_cur), jnp.asarray(v_cur),
                                       jnp.asarray(p))
    got = tatt.gqa_attention_deferred(_t(q), _t(kc), _t(vc), _t(k_cur), _t(v_cur), _t(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_update_kv_cache_matches_jax():
    rng = np.random.default_rng(3)
    B, S, Hkv, D, T = 2, 16, 2, 8, 3
    kc, vc = _rand(rng, B, S, Hkv * D), _rand(rng, B, S, Hkv * D)
    kn, vn = _rand(rng, B, T, Hkv, D), _rand(rng, B, T, Hkv, D)
    jk, jv = jatt.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                  jnp.asarray(vn), jnp.int32(5))
    tk, tv = _t(kc), _t(vc)
    tatt.update_kv_cache(tk, tv, _t(kn), _t(vn), 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_wrappers_refuse_mixed_devices():
    q = torch.zeros(1, 1, 4, 16)
    kc = torch.zeros(1, 8, 32, device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tfa.flash_decode_attention(q, kc, kc, torch.zeros(1, dtype=torch.int32))


# -- K2's split over the sequence ----------------------------------------------

@pytest.mark.parametrize("B,Hkv,S", [(8, 4, 1024), (1, 4, 2048), (2, 2, 64), (8, 4, 16),
                                     (3, 1, 4096), (1, 8, 130), (32, 8, 2048)])
def test_decode_splits_cover_the_cache_in_whole_tiles(B, Hkv, S):
    rows, n = tfa.decode_splits(B, Hkv, S)
    assert rows % tfa.SPLIT_TILE == 0                       # whole tiles
    assert rows * n >= S and rows * (n - 1) < S             # [0, S), no empty tail
    # the CTA target: as many splits as it asks for (or one a tile), and
    # no fewer than whole tiles allow: a split one tile shorter would pass it
    tiles = -(-S // tfa.SPLIT_TILE)
    want = min(tiles, -(-tfa.SPLIT_TARGET_CTAS // (B * Hkv)))
    per_split = rows // tfa.SPLIT_TILE
    assert n <= want
    assert per_split == 1 or -(-tiles // (per_split - 1)) > want


def test_decode_splits_read_shapes_only():
    """The plan is a function of (B, Hkv, S): the wrapper takes no
    position into it, so a captured graph replays it at any position."""
    import inspect

    assert list(inspect.signature(tfa.decode_splits).parameters) == ["B", "Hkv", "max_rows"]
    assert tfa.decode_splits(8, 4, 1024) == (128, 8)
    assert tfa.decode_splits(1, 4, 2048) == (64, 32)
    assert tfa.decode_splits(2, 4, 2048) == (64, 32)
    assert tfa.decode_splits(1, 4, 64) == (64, 1)


def _split_case(rng, B, S, H=8, Hkv=2, D=64):
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    return q, k, v


@pytest.mark.parametrize("n_split", [1, 2, 7])
@pytest.mark.parametrize("where", ["zero", "edge", "past_edge", "last"])
def test_decode_split_plain_matches_plain_and_pallas(n_split, where):
    """K2's split-and-combine (plain PyTorch, the kernel's order) against
    the plain twin and the Pallas decode kernel in interpret mode, with
    pos at 0, on a split edge, one past it, and at S - 1."""
    rows = 64
    S = rows * n_split
    B = 2
    rng = np.random.default_rng(10 * n_split + len(where))
    q, k, v = _split_case(rng, B, S)
    edge = rows * (n_split // 2)
    p = {"zero": 0, "edge": edge, "past_edge": edge + 1, "last": S - 1}[where]
    positions = np.asarray([p, max(p - 1, 0)], np.int32)
    Hkv, D = k.shape[2], k.shape[3]
    tk, tv = _t(k).reshape(B, S, Hkv * D), _t(v).reshape(B, S, Hkv * D)
    got = tfa.flash_decode_attention_split_plain(_t(q), tk, tv, _t(positions), rows)
    np.testing.assert_allclose(
        got.numpy(), tfa.flash_decode_attention_plain(_t(q), tk, tv, _t(positions)).numpy(),
        **TOL)
    want = jfa.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(positions), chunk=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_split_plain_empty_splits_and_bf16():
    """Splits wholly past pos add nothing (every row at pos 0 with 7
    splits); with bf16 q and cache the split route rounds p to bf16 and
    stays within bf16 tolerance of the twin."""
    rng = np.random.default_rng(77)
    B, S = 3, 7 * 64
    q, k, v = _split_case(rng, B, S)
    tk, tv = _t(k).reshape(B, S, -1), _t(v).reshape(B, S, -1)
    pos = torch.tensor([0, 64, 446], dtype=torch.int32)
    got = tfa.flash_decode_attention_split_plain(_t(q), tk, tv, pos, 64)
    np.testing.assert_allclose(got.numpy(),
                               tfa.flash_decode_attention_plain(_t(q), tk, tv, pos).numpy(),
                               **TOL)
    # pos 0 sees row 0 only: the output is v[0] of the head's kv head
    np.testing.assert_allclose(got[0, 0].reshape(2, 4, 64).numpy(),
                               np.broadcast_to(v[0, 0][:, None, :], (2, 4, 64)), **TOL)
    qb, kb, vb = _t(q).bfloat16(), tk.bfloat16(), tv.bfloat16()
    got_b = tfa.flash_decode_attention_split_plain(qb, kb, vb, pos, 64)
    want_b = tfa.flash_decode_attention_plain(qb, kb, vb, pos)
    assert got_b.dtype == torch.bfloat16
    err = (got_b.float() - want_b.float()).abs().max().item()
    assert err <= 2e-2 * want_b.float().abs().max().item()


# -- K3 on K2's split body ------------------------------------------------------

@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("where", ["zero", "edge", "mid", "last"])
def test_fused_split_plain_matches_pallas(where, cache):
    """K3's split-and-merge (key pos from k_cur / v_cur in the split that
    holds it, which also stores them) against the Pallas fused kernel in
    interpret mode: four splits of 64 rows, pos at 0, on a split edge,
    mid-split and at S - 1, the second batch row at another position. f32:
    2e-5 as above. bf16 caches (bf16 q, k_cur / v_cur rounded to the cache
    dtype on both sides): 2e-2 * max|ref|, the kernels' bf16 tolerance (the
    split route rounds the unnormalised softmax weights, the reference
    other intermediates). The stored rows are equal in both dtypes."""
    rng = np.random.default_rng(300 + len(where))
    B, S, H, Hkv, D, rows = 2, 256, 8, 2, 64, 64
    p = {"zero": 0, "edge": 128, "mid": 100, "last": S - 1}[where]
    positions = np.asarray([[p], [(p + 77) % S]], np.int32)
    dt, jdt = ((torch.float32, jnp.float32) if cache == "f32"
               else (torch.bfloat16, jnp.bfloat16))
    q = _rand(rng, B, 1, H, D)
    kc, vc = _rand(rng, B, S, Hkv * D), _rand(rng, B, S, Hkv * D)
    k_cur, v_cur = _rand(rng, B, 1, Hkv * D), _rand(rng, B, 1, Hkv * D)
    j = [jnp.asarray(a).astype(jdt) for a in (q, kc, vc, k_cur, v_cur)]
    want, k_new, v_new = jfa.flash_decode_fused(*j, jnp.asarray(positions), chunk=64,
                                                interpret=True)
    tk, tv = (_t(a.astype(jnp.float32)).to(dt) for a in j[1:3])
    tq, tkc, tvc = (_t(a.astype(jnp.float32)).to(dt)
                    for a in (j[0], j[3], j[4]))
    got, tk2, tv2 = tfa.flash_decode_fused_split_plain(tq, tk, tv, tkc, tvc,
                                                       _t(positions), rows)
    assert tk2 is tk and tv2 is tv and got.dtype == dt
    want = np.asarray(want.astype(jnp.float32))
    if cache == "f32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2e-2 * np.abs(want).max(), err
    for new, ref in ((tk, k_new), (tv, v_new)):
        np.testing.assert_array_equal(new.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    # and the plain twin: same attention, same stored rows
    tk3, tv3 = (_t(a.astype(jnp.float32)).to(dt) for a in j[1:3])
    twin, _, _ = tfa.flash_decode_fused_plain(tq, tk3, tv3, tkc, tvc, _t(positions))
    assert torch.equal(tk3, tk) and torch.equal(tv3, tv)
    err = (got.float() - twin.float()).abs().max().item()
    assert err <= (2e-5 if cache == "f32" else 2e-2) * twin.float().abs().max().item()


# -- K4 on tensor cores: f32 operands as three bf16 parts -------------------------

def test_split3_bf16_is_exact():
    """hi + mid + lo == x exactly in f32, each part a bf16 value, over
    random f32 values across exponents -100..100, both signs, and zero
    (csrc/common.cuh split3_bf16, what K1 and K4 split f32 operands with)."""
    rng = np.random.default_rng(8)
    n = 1 << 14
    mant = rng.uniform(1.0, 2.0, n).astype(np.float32)
    exp = rng.integers(-100, 101, n)
    sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
    x = (sign * np.ldexp(mant, exp)).astype(np.float32)
    x[:16] = 0.0
    x[16:32] = -0.0
    xt = torch.from_numpy(x)
    parts = split3_bf16(xt)
    for p in parts:
        assert p.dtype == torch.float32
        assert torch.equal(p, p.bfloat16().float())
    hi, mid, lo = parts
    assert torch.equal(hi + mid + lo, xt)
    assert torch.equal((hi + mid) + lo, xt)        # the order the kernels sum in
    assert torch.equal(hi, xt.bfloat16().float())


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("offset", [0, 23])
def test_prefill_split_plain_matches_plain_and_pallas(cache, offset):
    """K4's arithmetic for f32 q (flash_gqa_attention_split_plain: q, an
    f32 cache and P in three bf16 parts, the products with i + j <= 2)
    against the plain twin at 1e-5 * max|plain| and against the Pallas
    prefill kernel in interpret mode (as test_prefill_plain_matches_pallas
    runs it; a bf16 cache reaches it as f32 planes of the same values), T
    and S off the kernel's 64-row tiles."""
    rng = np.random.default_rng(40 + offset)
    B, T, S, H, Hkv, D = 1, 48, 96, 4, 2, 16
    q, k, v = _rand(rng, B, T, H, D), _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    tk, tv = _t(k), _t(v)
    if cache == "bf16":
        tk, tv = tk.bfloat16(), tv.bfloat16()
        k, v = tk.float().numpy(), tv.float().numpy()
    got = tfa.flash_gqa_attention_split_plain(_t(q), tk, tv, offset)
    assert got.dtype == torch.float32
    plain = tfa.flash_gqa_attention_plain(_t(q), tk, tv, offset)
    err = (got - plain).abs().max().item()
    assert err <= 1e-5 * plain.abs().max().item(), err
    want = jfa.flash_gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(offset), block_q=16, block_k=16,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
