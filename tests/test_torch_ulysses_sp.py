"""Ulysses attention (tpu_llm_torch.parallel.ulysses) and sequence-parallel
prefill (tpu_llm_torch.parallel.sequence) on CPU gloo groups of 4 ranks
(one spawn for every case), against the JAX package:
ulysses_gqa_attention against tpu_llm.parallel.ulysses's own under
shard_map on its virtual CPU devices, the 1 x 4 prefill against its
prefill_ulysses, the sequence-parallel prefill at tp 2 x dp 2 against its
prefill_sequence_parallel (the ranks' rows, tiled, are its output), and
the whole Ulysses decode (prefill, reshard, greedy steps) at degree 2 x
dp 2 against the JAX single-device forward / decode_step, which the JAX
package's own tests hold it equal to (tests/test_ulysses_sp.py).
Tolerances are that file's: 1e-5 for attention and caches, 2e-4 for
hidden states and logits. The mesh's all-to-all is held against
jax.lax.all_to_all(tiled=True)."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tests.test_sharding import CFG, make_params
from tests.test_torch_llama import to_numpy
from tests.test_torch_ring import attention_inputs, flat, jax_decode, tile, tile_cache
from tests.torch_parallel_ranks import seq_pipe_rank
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as JM
from tpu_llm.parallel import llama_cache_spec, llama_param_specs, shard_pytree
from tpu_llm.parallel import make_mesh as jmake_mesh
from tpu_llm.parallel.sequence import prefill_sequence_parallel
from tpu_llm.parallel.ulysses import prefill_ulysses, ulysses_gqa_attention
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.parallel import sequence, ulysses
from tpu_llm_torch.parallel.distributed import launch
from tpu_llm_torch.parallel.mesh import Mesh

MAX_SEQ = CFG["seq_len"] + 8


def jax_tokens(seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"],
                                                (2, CFG["seq_len"])).astype(np.int32)


@pytest.fixture(scope="module")
def refs():
    att = attention_inputs()
    spec = P(None, "model")
    want_att = shard_map(lambda q, k, v: ulysses_gqa_attention(q, k, v, "model"),
                         mesh=jmake_mesh(1, 4), in_specs=(spec, spec, spec), out_specs=spec,
                         check_vma=False)(att["q"], att["k"], att["v"])
    cfg = JConfig(**CFG)
    p11, p13 = make_params(11), make_params(13)
    t5, t6, t9 = jax_tokens(5), jax_tokens(6), jax_tokens(9)
    T = CFG["seq_len"]
    uly = prefill_ulysses(p11, cfg, jnp.asarray(t5), JM.init_cache(cfg, 2, T), jmake_mesh(1, 4))
    mesh = jmake_mesh(2, 2)
    cache = shard_pytree(JM.init_cache(cfg, 2, T), llama_cache_spec(), mesh)
    sp = prefill_sequence_parallel(params=shard_pytree(p13, llama_param_specs(cfg), mesh),
                                   cfg=cfg, tokens=jnp.asarray(t6), cache=cache, mesh=mesh)
    # the Ulysses lifecycle's reference: prefill, then greedy steps from T
    hidden0, cache0 = JM.forward(p13, cfg, jnp.asarray(t9), JM.init_cache(cfg, 2, MAX_SEQ),
                                 jnp.int32(0))
    tok0 = np.asarray(jnp.argmax(JM.lm_head(p13, cfg, hidden0[:, -1:])[:, 0], -1))
    feed, logits, cache0 = jax_decode(p13, cfg, tok0.tolist(), 4, start=T, cache=cache0)
    return dict(attention=(att, np.asarray(want_att)), p11=p11, p13=p13, t5=t5, t6=t6, t9=t9,
                uly=uly, sp=sp, dec=(hidden0, feed, logits, cache0))


@pytest.fixture(scope="module")
def ranks(refs):
    att, _ = refs["attention"]
    t11, t13 = to_numpy(refs["p11"]), to_numpy(refs["p13"])
    cases = [("collectives", "collectives", (2, 1, 2), {}),
             ("attention", "ulysses_attention", (1, 1, 4), att),
             ("prefill_1x4", "prefill", (1, 1, 4),
              dict(tree=t11, cfg=CFG, tokens=refs["t5"], how="ulysses")),
             ("sp_2x2", "prefill", (1, 2, 2), dict(tree=t13, cfg=CFG, tokens=refs["t6"],
                                                   how="sp")),
             ("decode_2x2", "ulysses_decode", (1, 2, 2),
              dict(tree=t13, cfg=CFG, tokens=refs["t9"], feed=refs["dec"][1],
                   max_seq=MAX_SEQ))]
    return launch(seq_pipe_rank, 4, cases, device="cpu", timeout=600)


def test_ulysses_attention_matches_jax(refs, ranks):
    _, want = refs["attention"]
    np.testing.assert_allclose(tile(ranks, "attention", lambda res: res, seq_axis=1), want,
                               rtol=1e-5, atol=1e-5)


def test_ulysses_prefill_matches_jax(refs, ranks):
    hidden, cache = refs["uly"]
    np.testing.assert_allclose(tile(ranks, "prefill_1x4", lambda res: res["hidden"], 1),
                               np.asarray(hidden), rtol=2e-4, atol=2e-4)
    got = tile_cache(ranks, "prefill_1x4")
    for kk in ("k", "v"):
        for i, plane in enumerate(got[kk]):
            np.testing.assert_allclose(plane, flat(cache[kk][i]), rtol=1e-5, atol=1e-5)
    for r in ranks:     # three all-to-alls a layer: q, k and v together, the output back
        assert r["prefill_1x4"][1]["counts"]["all_to_all"] == 3 * CFG["n_layers"]


def test_sp_prefill_matches_jax_and_is_sequence_sharded(refs, ranks):
    """Each rank returns its T / tp rows; tiled, they are the JAX SP
    prefill's output; the TP cache (heads over "model") reassembles to its
    cache; two gathers and two reduce-scatters a layer, no all-reduce."""
    hidden, cache = refs["sp"]
    T, tp = CFG["seq_len"], 2
    for r in ranks:
        assert r["sp_2x2"][1]["hidden"].shape == (1, T // tp, CFG["dim"])
        assert r["sp_2x2"][1]["counts"] == {
            "gather": 2 * CFG["n_layers"], "gather_bytes": 2 * CFG["n_layers"] * T // tp * 64 * 4,
            "reduce_scatter": 2 * CFG["n_layers"],
            "reduce_scatter_bytes": 2 * CFG["n_layers"] * T * 64 * 4}
    np.testing.assert_allclose(tile(ranks, "sp_2x2", lambda res: res["hidden"], 1),
                               np.asarray(hidden), rtol=2e-4, atol=2e-4)
    got = tile_cache(ranks, "sp_2x2", seq_axis=2)
    for kk in ("k", "v"):
        for i, plane in enumerate(got[kk]):
            np.testing.assert_allclose(plane, flat(cache[kk][i]), rtol=1e-5, atol=1e-5)


def test_ulysses_decode_matches_jax(refs, ranks):
    """Prefill at degree 2 x dp 2, the reshard to the head-sharded layout at
    max_seq T + 8, four greedy steps: logits and the reassembled cache
    against the JAX single-device path."""
    hidden0, _, want, cache0 = refs["dec"]
    np.testing.assert_allclose(tile(ranks, "decode_2x2", lambda res: res["hidden"], 1),
                               np.asarray(hidden0), rtol=2e-4, atol=2e-4)
    for step, ref in enumerate(want):
        got = tile(ranks, "decode_2x2", lambda res, s=step: res["logits"][s])
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        assert (got.argmax(-1) == ref.argmax(-1)).all()
    got = tile_cache(ranks, "decode_2x2", seq_axis=2)
    for kk in ("k", "v"):
        for i, plane in enumerate(got[kk]):
            np.testing.assert_allclose(plane, flat(cache0[kk][i]), rtol=1e-5, atol=1e-5)


def test_all_to_all_matches_jax(ranks):
    """Mesh.all_to_all(x, 1, 2) over each model group of a pipe 2 x model 2
    mesh against jax.lax.all_to_all(split_axis=1, concat_axis=2,
    tiled=True) over "model"."""
    xs = [np.arange(48, dtype=np.float32).reshape(2, 8, 3) + 100 * r for r in range(4)]
    jm = jmake_mesh(data=1, model=2, pipe=2)
    spec = P(("pipe", "model"))
    fn = shard_map(lambda x: jax.lax.all_to_all(x, "model", 1, 2, tiled=True), mesh=jm,
                   in_specs=spec, out_specs=spec, check_vma=False)
    want = np.asarray(fn(jnp.asarray(np.concatenate(xs)))).reshape(4, 2, 4, 6)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["collectives"][1]["all_to_all"], want[r])


def test_refusals_before_any_collective():
    """A Ulysses degree that does not divide n_kv_heads names ring
    attention (prefill and decode); SP's T must divide by tp; the reshard
    refuses max_seq < T. One process, no process group."""
    cfg = TConfig(**CFG)
    mesh = Mesh(1, 8, 0, torch.device("cpu"), "gloo", ranks=list(range(8)))
    cache = {"k": [torch.zeros(1, 4, cfg.kv_dim)], "v": [torch.zeros(1, 4, cfg.kv_dim)]}
    with pytest.raises(ValueError, match="ring attention"):
        ulysses.prefill_ulysses({}, cfg, torch.zeros((1, 32), dtype=torch.long), cache, mesh)
    with pytest.raises(ValueError, match="ring attention"):
        ulysses.decode_ulysses({}, cfg, torch.zeros(1, dtype=torch.long), cache, 0, mesh)
    with pytest.raises(ValueError, match="divisible"):
        sequence.prefill_sequence_parallel({}, cfg, torch.zeros((1, 30), dtype=torch.long),
                                           cache, mesh)
    with pytest.raises(ValueError, match="max_seq"):
        ulysses.reshard_cache_for_decode(cache, 16, mesh)
    assert not mesh.counts
