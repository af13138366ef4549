"""The port's paged KV cache (tpu_llm_torch.ops.paged_kv), int8 KV
quantization and the plain twins of the paged decode kernels, against
tpu_llm.ops.paged_kv / kv_cache and the Pallas kernels in interpret mode,
on the CPU. Inputs are made with numpy from a seed and handed to both."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tpu_llm.ops import kv_cache as jkv
from tpu_llm.ops import paged_kv as J
from tpu_llm.ops.flash_attention import (paged_flash_decode_attention,
                                         paged_flash_decode_q)
from tpu_llm_torch.ops import flash_attention as FA
from tpu_llm_torch.ops import kv_cache as tkv
from tpu_llm_torch.ops import paged_kv as T


def t(a):
    """numpy / jax array -> torch tensor (bf16 carried by its bits)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def as_np(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def jnp_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def both_pools(n_blocks, bs, B, mb, Hkv, D, dtype, table):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8"}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8"}[dtype]
    jk = J.PagedKV.zeros(n_blocks, bs, B, mb, Hkv * D, jdt, n_kv_heads=Hkv)
    jk = J.PagedKV(jk.k_pool, jk.v_pool, jnp.asarray(table), jk.lengths,
                   jk.k_scale, jk.v_scale)
    tk = T.PagedKV.zeros(n_blocks, bs, B, mb, Hkv * D, tdt, n_kv_heads=Hkv)
    tk.block_table.copy_(torch.from_numpy(table))
    return jk, tk


def assert_same_state(jk, tk):
    np.testing.assert_array_equal(as_np(tk.k_pool), jnp_bits(jk.k_pool))
    np.testing.assert_array_equal(as_np(tk.v_pool), jnp_bits(jk.v_pool))
    np.testing.assert_array_equal(tk.lengths.numpy(), np.asarray(jk.lengths))
    if jk.k_scale is not None:
        np.testing.assert_allclose(tk.k_scale.numpy(), np.asarray(jk.k_scale),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(tk.v_scale.numpy(), np.asarray(jk.v_scale),
                                   rtol=0, atol=1e-7)


def test_quantize_kv_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 16)) * 3).astype(np.float32)
    x[0, 1, 0] = 0.0                       # an all-zero vector: scale 0
    x[1, 2, 1, :4] = [2.5, -2.5, 0.5, -127 * 0.02]
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    assert ts[0, 1, 0] == 0 and (tq[0, 1, 0] == 0).all()
    deq = tkv.dequantize_kv(tkv.QuantKV(tq, ts))
    np.testing.assert_allclose(
        deq.numpy(), np.asarray(jkv.dequantize_kv(jkv.QuantKV(jq, js))), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("pos0", [[2, 0], 3], ids=["per_row", "scalar"])
def test_paged_update_tokens_matches_jax(dtype, pos0):
    """Multi-token writes at per-row or shared starts, including positions
    past the mapped blocks (null-block entries) and past the table."""
    B, T_, Hkv, D, bs, mb = 2, 7, 2, 8, 4, 3
    rng = np.random.default_rng(1)
    table = np.zeros((B, mb), np.int32)
    table[0, :2] = [5, 2]              # block 2 of row 0 unmapped (null)
    table[1] = [1, 7, 3]
    jk, tk = both_pools(9, bs, B, mb, Hkv, D, dtype, table)
    k = rng.standard_normal((B, T_, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T_, Hkv, D)).astype(np.float32)
    jpos = jnp.asarray(pos0, jnp.int32)
    tpos = torch.tensor(pos0, dtype=torch.int32) if isinstance(pos0, list) else pos0
    jk = J.paged_update_tokens(jk, jnp.asarray(k), jnp.asarray(v), jpos)
    T.paged_update_tokens(tk, torch.from_numpy(k), torch.from_numpy(v), tpos)
    if dtype != "f32":
        # the null block takes several writes at one offset; which lands
        # is unspecified on both sides, so compare the mapped blocks
        jk = J.PagedKV(jk.k_pool.at[0].set(0), jk.v_pool.at[0].set(0), jk.block_table,
                       jk.lengths, jk.k_scale, jk.v_scale)
        tk.k_pool[0] = 0
        tk.v_pool[0] = 0
        if dtype == "int8":
            hp = T.scale_rows_per_block(Hkv)
            jk = J.PagedKV(jk.k_pool, jk.v_pool, jk.block_table, jk.lengths,
                           jk.k_scale.at[:hp].set(0), jk.v_scale.at[:hp].set(0))
            tk.k_scale[:hp] = 0
            tk.v_scale[:hp] = 0
    assert_same_state(jk, tk)


def test_out_of_table_writes_go_to_null_block():
    """The reference's review case: padded writes past a fully mapped table
    land in block 0, never in the clamped last column."""
    B, Hkv, D, bs, mb = 1, 2, 4, 2, 2
    table = np.asarray([[1, 2]], np.int32)
    jk, tk = both_pools(4, bs, B, mb, Hkv, D, "f32", table)
    k = np.random.default_rng(0).standard_normal((B, 4, Hkv, D)).astype(np.float32)
    jk = J.paged_update_tokens(jk, jnp.asarray(k), jnp.asarray(k), jnp.asarray([0], jnp.int32))
    T.paged_update_tokens(tk, torch.from_numpy(k), torch.from_numpy(k),
                          torch.tensor([0], dtype=torch.int32))
    pad = np.full((B, 4, Hkv, D), 99.0, np.float32)
    jk = J.paged_update_tokens(jk, jnp.asarray(pad), jnp.asarray(pad),
                               jnp.asarray([2], jnp.int32))
    snap = tk.k_pool.clone()
    T.paged_update_tokens(tk, torch.from_numpy(pad), torch.from_numpy(pad),
                          torch.tensor([2], dtype=torch.int32))
    assert_same_state(jk, tk)
    assert torch.equal(tk.k_pool[1], snap[1]) and (tk.k_pool[2] == 99.0).all()
    assert (tk.k_pool[3] == 0).all()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_gather_round_trip_matches_jax(dtype):
    B, Hkv, D, bs, mb = 2, 2, 8, 4, 4
    rng = np.random.default_rng(2)
    table = (1 + rng.permutation(B * mb)).reshape(B, mb).astype(np.int32)
    jk, tk = both_pools(1 + B * mb, bs, B, mb, Hkv, D, dtype, table)
    writes = {}
    for pos in [0, 1, 3, 4, 5, 11]:
        k = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        jk = J.paged_update(jk, jnp.asarray(k), jnp.asarray(k), jnp.full((B,), pos, jnp.int32))
        T.paged_update(tk, torch.from_numpy(k), torch.from_numpy(k),
                       torch.full((B,), pos, dtype=torch.int32))
        writes[pos] = k
    jg, _ = J.paged_gather(jk, n_kv_heads=Hkv)
    tg, _ = T.paged_gather(tk, n_kv_heads=Hkv)
    if dtype == "int8":
        np.testing.assert_array_equal(tg.q.numpy(), np.asarray(jg.q))
        np.testing.assert_allclose(tg.s.numpy(), np.asarray(jg.s), rtol=0, atol=1e-7)
        flat = tkv.dequantize_kv(tg, head_dim=D).numpy()
        for pos, k in writes.items():
            np.testing.assert_allclose(flat[:, pos], k[:, 0], atol=0.03)
    else:
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        for pos, k in writes.items():
            np.testing.assert_array_equal(tg.numpy().reshape(B, -1, Hkv, D)[:, pos], k[:, 0])
    assert tk.lengths.tolist() == [12, 12]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("T_", [1, 5])
def test_paged_gqa_attention_matches_jax(dtype, T_):
    """The CPU route (gather + masked attention with kv_lengths) for decode
    and prefill-shaped queries at per-row positions."""
    B, H, Hkv, D, bs, mb = 2, 4, 2, 16, 4, 4
    rng = np.random.default_rng(3 + T_)
    table = (1 + rng.permutation(B * mb)).reshape(B, mb).astype(np.int32)
    jk, tk = both_pools(1 + B * mb, bs, B, mb, Hkv, D, dtype, table)
    k = rng.standard_normal((B, 9, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, 9, Hkv, D)).astype(np.float32)
    jk = J.paged_update_tokens(jk, jnp.asarray(k), jnp.asarray(v), jnp.int32(0))
    T.paged_update_tokens(tk, torch.from_numpy(k), torch.from_numpy(v), 0)
    q = rng.standard_normal((B, T_, H, D)).astype(np.float32)
    qpos = np.asarray([[8 - T_ + 1 + i for i in range(T_)], [4 + i for i in range(T_)]],
                      np.int32)
    jq = jnp.asarray(q, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    want = np.asarray(J.paged_gqa_attention(jq, jk, jnp.asarray(qpos)).astype(jnp.float32))
    got = T.paged_gqa_attention(t(jq), tk, torch.from_numpy(qpos)).float().numpy()
    tol = 1e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_allocator_free_list():
    a = T.BlockAllocator(8)
    assert a.n_free == 7
    blocks = a.alloc(3)
    assert len(set(blocks)) == 3 and 0 not in blocks
    a.reserve(2)
    with pytest.raises(MemoryError):
        a.alloc(3)
    a.unreserve(2)
    a.release(blocks)
    assert a.n_free == 7
    with pytest.raises(MemoryError):
        a.alloc(8)


def test_prefix_cache_matches_jax():
    """Digests byte for byte, and the same hits / queries / evictions and
    refcounts through a match-insert-evict sequence."""
    tokens = [1, 5, 11, 8, 3, 9, 2, 7, 300, -4, 70000]
    for bs in (2, 4):
        assert T.PrefixCache.digests(tokens, bs) == J.PrefixCache.digests(tokens, bs)
    caches = []
    for mod in (J, T):
        alloc = mod.BlockAllocator(6)
        pc = mod.PrefixCache(alloc)
        blocks = alloc.alloc(4)
        pc.insert(tokens, 2, blocks)
        alloc.release(blocks)
        hit = pc.match(tokens[:7], 2)
        alloc.release(hit)
        more = alloc.alloc(4)                # forces an eviction
        caches.append((hit, more, pc.hits, pc.queries, pc.evictions, dict(alloc.refs)))
    assert caches[0] == caches[1]


@pytest.mark.parametrize("positions", [[0, 5], [7, 31], [16, 3], [63, 48]])
def test_paged_decode_twin_matches_pallas(positions):
    """K5's plain twin == the Pallas kernel in interpret mode."""
    B, H, Hkv, D, bs, mb = 2, 8, 2, 64, 16, 4
    N = 1 + B * mb
    rng = np.random.default_rng(sum(positions))
    kp = rng.standard_normal((N, bs, Hkv * D)).astype(np.float32)
    vp = rng.standard_normal((N, bs, Hkv * D)).astype(np.float32)
    table = rng.permutation(np.arange(1, N)).reshape(B, mb).astype(np.int32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    want = paged_flash_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                        jnp.asarray(table), jnp.asarray(pos),
                                        interpret=True)
    got = FA.paged_flash_decode_attention(*map(torch.from_numpy, (q, kp, vp, table, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_paged_decode_twin_skips_unmapped_blocks():
    """Blocks past pos (and the null block) are never read: poison them,
    output unchanged."""
    B, H, Hkv, D, bs = 1, 4, 2, 64, 8
    rng = np.random.default_rng(0)
    kp = torch.from_numpy(rng.standard_normal((6, bs, Hkv * D)).astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((6, bs, Hkv * D)).astype(np.float32))
    table = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([11], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    base = FA.paged_flash_decode_attention(q, kp, vp, table, pos)
    dead = torch.tensor([0, 3, 4, 5])
    got = FA.paged_flash_decode_attention(q, kp.index_add(0, dead, torch.full_like(kp[dead], 1e3)),
                                          vp.index_add(0, dead, torch.full_like(vp[dead], 1e3)),
                                          table, pos)
    assert torch.equal(got, base)


@pytest.mark.parametrize("positions", [[0, 40], [70, 95]])
def test_paged_decode_q_twin_matches_pallas(positions):
    """K6's plain twin == the int8 Pallas kernel in interpret mode (the
    kernel rounds q and p * vs to bf16, the twin stays f32: 5e-3)."""
    B, H, Hkv, D, bs, mb = 2, 8, 2, 64, 32, 4
    N = 1 + B * mb
    rng = np.random.default_rng(positions[0])
    table = rng.permutation(np.arange(1, N)).reshape(B, mb).astype(np.int32)
    jk, tk = both_pools(N, bs, B, mb, Hkv, D, "int8", table)
    for p in range(max(positions) + 1):
        k = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        v = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
        jk = J.paged_update_tokens(jk, jnp.asarray(k), jnp.asarray(v),
                                   jnp.full((B,), p, jnp.int32))
        T.paged_update_tokens(tk, torch.from_numpy(k), torch.from_numpy(v),
                              torch.full((B,), p, dtype=torch.int32))
    assert_same_state(jk, tk)
    pos = np.asarray(positions, np.int32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    want = paged_flash_decode_q(jnp.asarray(q), jk.k_pool, jk.v_pool, jk.k_scale,
                                jk.v_scale, jk.block_table, jnp.asarray(pos),
                                interpret=True)
    got = FA.paged_flash_decode_q(torch.from_numpy(q), tk.k_pool, tk.v_pool, tk.k_scale,
                                  tk.v_scale, tk.block_table, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3)


# The split-and-merge of the paged split launch (K5 / K6 on the split decode
# body): 128 logical rows a batch row, positions 0, BS - 1, BS, the edge of
# split 3 of 7 (57) and the row after it, the edge of split 1 of 2 (64) and
# the row after it, and the last row. One Pallas run per pool and block
# size serves every split count.
SPLIT_ROWS = 128


def _split_positions(bs):
    return [0, bs - 1, bs, 57, 58, 64, 65, SPLIT_ROWS - 1]


@functools.lru_cache(maxsize=None)
def _paged_split_case(pool, bs):
    """Inputs made with numpy from a seed and the Pallas kernel's output
    in interpret mode (K5 for f32/bf16 pools, K6 for int8)."""
    B, H, Hkv, D = 8, 8, 2, 64
    mb = SPLIT_ROWS // bs
    N = 1 + B * mb
    rng = np.random.default_rng(bs + len(pool))
    table = rng.permutation(np.arange(1, N)).reshape(B, mb).astype(np.int32)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    pos = np.asarray(_split_positions(bs), np.int32)
    if pool == "int8":
        kp, vp = (rng.integers(-127, 128, (N, bs, Hkv * D)).astype(np.int8)
                  for _ in range(2))
        shape = (N * T.scale_rows_per_block(Hkv), T.scale_pool_width(bs))
        # scales as quantize_kv gives rows of unit normals (max|x| / 127)
        ks, vs = (rng.uniform(0.015, 0.03, shape).astype(np.float32) for _ in range(2))
        want = paged_flash_decode_q(*map(jnp.asarray, (q, kp, vp, ks, vs, table, pos)),
                                    interpret=True)
        return (q, kp, vp, table, pos, ks, vs), np.asarray(want)
    kp, vp = (rng.standard_normal((N, bs, Hkv * D)).astype(np.float32) for _ in range(2))
    jpool = jnp.asarray
    if pool == "bf16":
        kp, vp = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                  for a in (kp, vp))
        if bs % 16 == 0:
            jpool = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        # else the Pallas kernel takes bf16 pools only in 16-row blocks: the
        # same values widened to f32 (f32 q: the same scores and sums)
    want = paged_flash_decode_attention(jnp.asarray(q), jpool(kp), jpool(vp),
                                        jnp.asarray(table), jnp.asarray(pos), interpret=True)
    return (q, kp, vp, table, pos), np.asarray(want)


@pytest.mark.parametrize("n_split", [1, 2, 7])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_paged_split_plain_matches_pallas(pool, bs, n_split):
    """paged_flash_decode_split_plain (the kernel's splits, merged in split
    order, with K5's / K6's rounding) == the Pallas kernels in interpret
    mode, f32 q: 2e-5 over f32 and bf16 pools, 5e-3 over int8 pools (the
    tolerances of the twins' own tests above)."""
    arrays, want = _paged_split_case(pool, bs)
    q, kp, vp, table, pos, *scales = map(torch.from_numpy, arrays)
    if pool == "bf16":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    rows = -(-SPLIT_ROWS // n_split)
    assert -(-SPLIT_ROWS // rows) == n_split
    got = FA.paged_flash_decode_split_plain(q, kp, vp, table, pos, *scales,
                                            rows_per_split=rows)
    tol = 5e-3 if pool == "int8" else 2e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_paged_splits_cover_the_table():
    for B, Hkv, rows in [(8, 4, 1024), (1, 4, 2048), (2, 2, 64), (8, 4, 16), (3, 1, 4096)]:
        per, n = FA.decode_splits(B, Hkv, rows)
        assert per % FA.SPLIT_TILE == 0 and per * n >= rows and per * (n - 1) < rows
        assert n == 1 or B * Hkv * (n - 1) < FA.SPLIT_TARGET_CTAS
