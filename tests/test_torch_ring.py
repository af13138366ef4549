"""Ring attention and sequence-sharded decode (tpu_llm_torch.parallel.ring)
and the mesh's new collectives on CPU gloo groups of 4 ranks (one spawn
for every case), against the JAX package: ring_gqa_attention against
tpu_llm.parallel.ring's own under shard_map on its virtual CPU devices,
the 1 x 4 prefill against its prefill_context_parallel, the 2 x 2 prefill
and the decode steps against the JAX single-device forward / decode_step,
which the JAX package's own tests hold those functions equal to
(tests/test_ring.py). Tolerances are that file's: 1e-5 for attention and
caches, 2e-4 for hidden states, 2e-5 for the decode logits. The mesh's
ring shift and (pipe, data, model) layout are held against the JAX
ppermute and make_mesh."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.test_sharding import make_params
from tests.test_torch_llama import to_numpy
from tests.torch_parallel_ranks import seq_pipe_rank
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as JM
from tpu_llm.parallel import make_mesh as jmake_mesh
from tpu_llm.parallel.ring import prefill_context_parallel, ring_gqa_attention
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.parallel import ring
from tpu_llm_torch.parallel.distributed import launch
from tpu_llm_torch.parallel.mesh import Mesh

CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=8, n_kv_heads=4, vocab_size=256,
           seq_len=32)
DEC_CFG = dict(dim=32, hidden_dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64,
               seq_len=16)


def tile(results, name, pick, seq_axis=None):
    """The ranks' pieces ``pick(result)`` of case ``name`` reassembled (pipe
    index 0 only): batch rows by data index along axis 0, blocks by model
    index along ``seq_axis`` (None: replicated over the model group)."""
    pieces = {r[name][0][1:]: pick(r[name][1]) for r in results
              if name in r and r[name][0][0] == 0}
    rows = []
    for d in sorted({d for d, _ in pieces}):
        ms = sorted(m for dd, m in pieces if dd == d)
        rows.append(pieces[(d, 0)] if seq_axis is None else
                    np.concatenate([pieces[(d, m)] for m in ms], axis=seq_axis))
    return np.concatenate(rows, axis=0)


def tile_cache(results, name, seq_axis=1):
    """Per layer (B, S, Hkv * D) planes reassembled from the ranks' caches
    (blocks along ``seq_axis``: 1 the sequence, 2 the kv heads)."""
    L = len(next(r[name][1]["cache"]["k"] for r in results if name in r))
    return {kk: [tile(results, name, lambda res, kk=kk, i=i: res["cache"][kk][i], seq_axis)
                 for i in range(L)] for kk in ("k", "v")}


def attention_inputs():
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 2, 32, 8, 4, 8
    return {n: rng.standard_normal(sh).astype(np.float32)
            for n, sh in (("q", (B, S, H, D)), ("k", (B, S, Hkv, D)), ("v", (B, S, Hkv, D)))}


def jax_ring_attention(q, k, v, n=4):
    mesh = jmake_mesh(1, n)

    def local(q, k, v):
        r = jax.lax.axis_index("model")
        pos = r * q.shape[1] + jnp.arange(q.shape[1], dtype=jnp.int32)
        return ring_gqa_attention(q, k, v, pos, pos, "model")

    spec = P(None, "model")
    return np.asarray(shard_map(local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                                check_vma=False)(q, k, v))


def dec_params(seed=3):
    """tests/test_ring.py::test_cp_decode_matches_dense's weights."""
    cfg = JConfig(**DEC_CFG)
    rng = np.random.default_rng(seed)
    s = lambda *sh: jnp.asarray((rng.standard_normal(sh) * 0.05).astype(np.float32))  # noqa: E731
    L, E, F, V, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    return {"tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
            "layers": {"attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
                       "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
                       "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
                       "w2": s(L, F, E)}}


def jax_decode(params, cfg, tok, steps, start=0, cache=None):
    """Greedy decode_step from ``start``: (the fed token rows, the logits a
    step, the cache)."""
    cache = cache if cache is not None else JM.init_cache(cfg, len(tok), cfg.seq_len)
    tok = jnp.asarray(tok, jnp.int32)
    feed, logits = [], []
    for i in range(steps):
        lg, cache = JM.decode_step(params, cfg, tok, cache, jnp.int32(start + i))
        feed.append(np.asarray(tok).tolist())
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return feed, logits, cache


def flat(plane):
    """(B, S, Hkv, D) -> (B, S, Hkv * D)."""
    a = np.asarray(plane)
    return a.reshape(a.shape[0], a.shape[1], -1)


@pytest.fixture(scope="module")
def refs():
    att = attention_inputs()
    cfg = JConfig(**CFG)
    p7 = make_params(7)
    tokens = np.random.default_rng(4).integers(0, CFG["vocab_size"], (2, 32)).astype(np.int32)
    hidden_cp, cache_cp = prefill_context_parallel(p7, cfg, jnp.asarray(tokens),
                                                   JM.init_cache(cfg, 2, 32), jmake_mesh(1, 4))
    hidden0, cache0 = JM.forward(p7, cfg, jnp.asarray(tokens), JM.init_cache(cfg, 2, 32),
                                 jnp.int32(0))
    dcfg = JConfig(**DEC_CFG)
    dp = dec_params()
    feed, logits, dcache = jax_decode(dp, dcfg, [3, 7], 10)
    return dict(attention=(att, jax_ring_attention(att["q"], att["k"], att["v"])),
                p7=p7, tokens=tokens, prefill_cp=(hidden_cp, cache_cp),
                prefill0=(hidden0, cache0), dec=(dp, feed, logits, dcache))


@pytest.fixture(scope="module")
def ranks(refs):
    att, _ = refs["attention"]
    tree, dtree = to_numpy(refs["p7"]), to_numpy(refs["dec"][0])
    feed = refs["dec"][1]
    model = dict(tree=tree, cfg=CFG, tokens=refs["tokens"])
    cases = [("collectives", "collectives", (2, 1, 2), {}),
             ("attention", "ring_attention", (1, 1, 4), att),
             ("prefill_1x4", "prefill", (1, 1, 4), dict(model, how="ring")),
             ("prefill_2x2", "prefill", (1, 2, 2), dict(model, how="ring")),
             ("decode_1x4", "cp_decode", (1, 1, 4), dict(tree=dtree, cfg=DEC_CFG, feed=feed)),
             ("decode_2x2", "cp_decode", (1, 2, 2), dict(tree=dtree, cfg=DEC_CFG, feed=feed))]
    return launch(seq_pipe_rank, 4, cases, device="cpu", timeout=600)


def test_ring_attention_matches_jax(refs, ranks):
    _, want = refs["attention"]
    got = tile(ranks, "attention", lambda res: res, seq_axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["prefill_1x4", "prefill_2x2"])
def test_cp_prefill_matches_jax(name, refs, ranks):
    """1 x 4 against the JAX package's prefill_context_parallel, 2 x 2 (batch
    rows over "data") against its single-device forward."""
    hidden, cache = refs["prefill_cp" if name == "prefill_1x4" else "prefill0"]
    np.testing.assert_allclose(tile(ranks, name, lambda res: res["hidden"], seq_axis=1),
                               np.asarray(hidden), rtol=2e-4, atol=2e-4)
    got = tile_cache(ranks, name)
    for kk in ("k", "v"):
        for i, plane in enumerate(got[kk]):
            np.testing.assert_allclose(plane, flat(cache[kk][i]), rtol=1e-5, atol=1e-5)
    n, b = (4, 2) if name == "prefill_1x4" else (2, 1)     # ranks a ring, batch rows
    shifts = (n - 1) * CFG["n_layers"]        # k and v travel together: n - 1 a layer
    kv_bytes = 2 * b * (32 // n) * 32 * 4     # (2, b, T / n, Hkv * D) f32
    for r in ranks:
        assert r[name][1]["counts"] == {"ppermute": shifts, "ppermute_bytes": shifts * kv_bytes}


@pytest.mark.parametrize("name", ["decode_1x4", "decode_2x2"])
def test_cp_decode_matches_jax(name, refs, ranks):
    """Ten steps from a fresh cache of 4 rows a rank (1 x 4) or 8 (2 x 2),
    crossing the ownership boundaries, against the JAX decode_step; the
    reassembled cache against its cache."""
    _, feed, want, dcache = refs["dec"]
    got = [r[name] for r in ranks if name in r]
    for (p, d, m), res in got:
        b = 2 // (2 if name == "decode_2x2" else 1)
        for lg, ref in zip(res["logits"], want, strict=True):
            np.testing.assert_allclose(lg, ref[d * b:(d + 1) * b], rtol=2e-5, atol=2e-5)
        # two all-reduces a layer a step: the max, then [l | acc]
        assert res["counts"]["all_reduce"] == 2 * DEC_CFG["n_layers"] * len(feed)
    planes = tile_cache(ranks, name)
    for kk in ("k", "v"):
        for i, plane in enumerate(planes[kk]):
            np.testing.assert_allclose(plane, flat(dcache[kk][i]), rtol=1e-5, atol=1e-5)


def test_collectives_match_jax(ranks):
    """On a pipe 2 x model 2 mesh: the ring shift (both ways) against
    jax.lax.ppermute, the reduce-scatter and max against their
    definitions, send / recv and the broadcast over the pipe group, and
    the grid indices against the JAX make_mesh's device grid."""
    xs = [np.arange(48, dtype=np.float32).reshape(2, 8, 3) + 100 * r for r in range(4)]
    jm = jmake_mesh(data=1, model=2, pipe=2)
    grid = np.vectorize(lambda dev: dev.id)(jm.devices)         # (pipe, data, expert, model)

    def jperm(shift):
        fn = shard_map(lambda x: jax.lax.ppermute(x, "model", [(j, (j + shift) % 2)
                                                              for j in range(2)]),
                       mesh=jm, in_specs=P(("pipe", "model")), out_specs=P(("pipe", "model")),
                       check_vma=False)
        return np.asarray(fn(jnp.asarray(np.concatenate(xs)))).reshape(4, 2, 8, 3)

    fwd, back = jperm(1), jperm(-1)
    for r, res in enumerate(ranks):
        (p, d, m), got = res["collectives"]
        assert (p, d, m) == got["index"]
        assert tuple(np.argwhere(grid == r)[0][[0, 1, 3]]) == (p, d, m)
        np.testing.assert_array_equal(got["ppermute"], fwd[r])
        np.testing.assert_array_equal(got["ppermute_back"], back[r])
        pair = [xs[r - m], xs[r - m + 1]]
        np.testing.assert_array_equal(got["reduce_scatter"], (pair[0] + pair[1])[:, m * 4:][:, :4])
        np.testing.assert_array_equal(got["max"], np.maximum(*pair))
        np.testing.assert_array_equal(got["broadcast"], xs[2 + m])
        if p == 1:
            np.testing.assert_array_equal(got["recv"], xs[m])
        assert got["counts"]["ppermute"] == 2 and got["counts"]["all_to_all"] == 1


def test_refusals_before_any_collective():
    """T not divisible by the sequence axis, and a position past the
    sharded cache, raise ValueError in one process (no process group)."""
    cfg = TConfig(**CFG)
    mesh = Mesh(1, 4, 0, torch.device("cpu"), "gloo", ranks=list(range(4)))
    params = {"layers": []}
    cache = {"k": [torch.zeros(1, 8, cfg.kv_dim)], "v": [torch.zeros(1, 8, cfg.kv_dim)]}
    with pytest.raises(ValueError, match="divisible"):
        ring.prefill_context_parallel(params, cfg, torch.zeros((1, 30), dtype=torch.long),
                                      cache, mesh)
    with pytest.raises(ValueError, match="divisible"):
        ring.init_cp_cache(cfg, mesh, 1, 30)
    with pytest.raises(ValueError, match="outside the sharded cache"):
        ring.decode_step_context_parallel(params, cfg, torch.zeros(1, dtype=torch.long),
                                          cache, 32, mesh)
    assert not mesh.counts
