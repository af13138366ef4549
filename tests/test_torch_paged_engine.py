"""The port's PagedEngine (tpu_llm_torch.runtime.paged_engine) against
tpu_llm.runtime.paged_engine.PagedEngine on the CPU: the same q4_0
weights, the same requests and step sequence give identical greedy
tokens, prefix-cache hits and queries, and blocks in use — over block
sizes 4 and 16, chunked prefill, pool pressure, eviction, int8 pools and
reset."""

import warnings

import pytest

from tests.test_torch_batching import CFG, drive
from tests.test_torch_llama import jax_params, to_numpy
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.runtime import batching as JB
from tpu_llm.runtime.paged_engine import PagedEngine as JPaged
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models.llama import params_from_numpy
from tpu_llm_torch.runtime import batching as TB
from tpu_llm_torch.runtime.paged_engine import PagedEngine as TPaged
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)


@pytest.fixture(scope="module")
def weights():
    jp = jax_params("q4_0")
    return jp, params_from_numpy(to_numpy(jp))


def engines(weights, **kw):
    jp, tp = weights
    kw.setdefault("max_seq", CFG["seq_len"])
    cache = kw.pop("cache_dtype", None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the int8 block-size bump
        je = JPaged(jp, JConfig(**CFG), **kw, **({"cache_dtype": cache} if cache else {}))
        te = TPaged(tp, TConfig(**CFG), device="cpu", **kw,
                    **({"cache_dtype": cache} if cache else {}))
    return je, te


def stats(eng):
    pc = eng.prefix
    return (pc.hits, pc.queries, pc.evictions) if pc else None, eng.hbm_blocks_in_use


SHARED = [5, 11, 8, 3, 9, 2, 7, 4, 6, 1, 30, 31, 32, 33, 34]   # +BOS = 16 ids
SCRIPTS = {
    "three_prompts": dict(kw=dict(batch=3, n_blocks=32), script=[
        ("submit", [5, 11], 5, {}), ("submit", [3], 6, {}),
        ("submit", [9, 2, 40], 4, {}), ("run",)]),
    # a shared prefix admitted after its first owner finished, and a
    # diverging tail while the second one still runs
    "prefix_sharing": dict(kw=dict(batch=2, n_blocks=48), script=[
        ("submit", SHARED + [40, 41], 6, {}), ("run",),
        ("submit", SHARED + [42, 43, 44], 5, {}), ("step",),
        ("submit", SHARED[:9] + [50], 4, {}), ("run",)]),
    # every other decode step crosses a block boundary
    "growth_and_slot_reuse": dict(kw=dict(batch=1, n_blocks=32, prefix_caching=False),
                                  script=[("submit", [5, 11, 8], 9, {}), ("run",),
                                          ("submit", [9, 4, 7], 5, {}), ("run",)]),
    # a 41-id prompt through 8-token chunks and a bucketed tail
    "chunked_prefill": dict(kw=dict(batch=2, n_blocks=48, prefill_chunk=8), script=[
        ("submit", [5, 11], 8, {}), ("step",),
        ("submit", list(range(2, 42)), 4, {}), ("run",)]),
    # a pool too small for both: the second waits for the first's blocks
    "pool_pressure": dict(kw=dict(batch=2, n_blocks={4: 5, 16: 2}, prefix_caching=False),
                          script=[("submit", [5, 11, 8, 3, 9], 6, {}),
                                  ("submit", [7, 4, 2, 6, 1], 6, {}), ("run",)]),
    # a stream of distinct prompts evicts cached blocks LRU
    "eviction": dict(kw=dict(batch=1, n_blocks={4: 9, 16: 4}), script=[
        x for i in range(5)
        for x in (("submit", [5 + i] + list(range(11, 30)), 3, {}), ("run",))]),
    "cancel_and_multi_turn": dict(kw=dict(batch=1, n_blocks=64), script=[
        ("submit", [5, 11, 8, 3], 10, {}), ("step",), ("step",), ("cancel", 0),
        ("submit", [5, 11, 8, 3, 9, 2], 4, {}), ("run",)]),
}


@pytest.mark.parametrize("block_size", [4, 16])
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_paged_engine_matches_jax(weights, name, block_size):
    case = SCRIPTS[name]
    kw = {k: v[block_size] if isinstance(v, dict) else v for k, v in case["kw"].items()}
    je, te = engines(weights, block_size=block_size, **kw)
    want = drive(je, JB, case["script"])
    got = drive(te, TB, case["script"])
    assert got == want
    assert all(done for _, done in got)
    assert stats(te) == stats(je)
    if name == "eviction":
        assert te.prefix.evictions > 0
    if name == "prefix_sharing":
        assert te.prefix.hits > 0


@pytest.mark.parametrize("block_size", [4, 32])
def test_int8_pools_match_jax(weights, block_size):
    """int8 pools (a block size under 32 is bumped to 32, as in the
    reference): the pool and scale-pool shapes, the block tables and the
    tokens equal the reference's."""
    import numpy as np

    je, te = engines(weights, batch=2, n_blocks=32, block_size=block_size,
                     cache_dtype="int8")
    assert te.block_size == je.block_size == 32 and te._n_blocks == je._n_blocks
    script = [("submit", [5, 11, 8], 5, {}), ("submit", [9, 2], 6, {}),
              ("submit", list(range(3, 30)), 3, {}), ("run",)]
    want = drive(je, JB, script)
    got = drive(te, TB, script)
    assert got == want
    assert stats(te) == stats(je)
    for name in ("k", "ks"):
        assert [tuple(a.shape) for a in te.state[name]] == \
            [tuple(a.shape) for a in je.state[name]]
    np.testing.assert_array_equal(te.state["table"].numpy(), np.asarray(je.state["table"]))


def test_impossible_request_raises(weights):
    for eng in engines(weights, batch=1, n_blocks=4, block_size=2, prefix_caching=False):
        with pytest.raises(MemoryError):
            eng.submit(JB.Request(prompt=list(range(3, 11)), max_new=4)
                       if isinstance(eng, JPaged)
                       else TB.Request(prompt=list(range(3, 11)), max_new=4))
            eng.run()


def test_reset_recovers(weights):
    je, te = engines(weights, batch=3, n_blocks=32, block_size=4)
    r1 = te.submit(TB.Request(prompt=[5, 9, 3], max_new=6))
    te.run()
    te.submit(TB.Request(prompt=[8, 8], max_new=20))
    te.step()
    te.reset()
    assert te.n_active == 0 and not te._queue and te.hbm_blocks_in_use == 0
    r2 = te.submit(TB.Request(prompt=[5, 9, 3], max_new=6))
    te.run()
    want = drive(je, JB, [("submit", [5, 9, 3], 6, {}), ("run",)])
    assert r2.tokens == r1.tokens == want[0][0]


@pytest.mark.parametrize("drafter", ["lookup", "draft_model"])
@pytest.mark.parametrize("block_size,cache", [(2, None), (4, None), (32, "int8")])
def test_paged_speculative_matches_jax(weights, block_size, cache, drafter):
    """Speculation over the paged pools (tests/test_paged_engine.py
    ``test_paged_speculative_matches_plain``): across block growth, slot
    reuse and a draft model (its own dense cache), the JAX paged spec
    engine's tokens, spec stats, prefix-cache counts and blocks in use,
    and the port's plain paged stream."""
    from tests.test_torch_batching import _weights_q4_0
    from tpu_llm.runtime.engine import ModelAdapter as JAdapter
    from tpu_llm_torch.runtime.engine import ModelAdapter as TAdapter

    kw = dict(batch=2, n_blocks=64, block_size=block_size, speculative_k=3)
    if cache:
        kw["cache_dtype"] = cache
    if drafter == "draft_model":
        jd, td = _weights_q4_0(seed=1)
        jp, tp = weights
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            je = JPaged(jp, JConfig(**CFG), max_seq=CFG["seq_len"], **kw,
                        draft=(jd, JAdapter.llama(JConfig(**CFG), bos_id=1)))
            te = TPaged(tp, TConfig(**CFG), max_seq=CFG["seq_len"], device="cpu", **kw,
                        draft=(td, TAdapter.llama(TConfig(**CFG), device="cpu")))
    else:
        je, te = engines(weights, **kw)
    script = [("submit", [5, 11, 5, 11, 5], 6, {}), ("submit", [9, 2, 9, 2], 5, {}),
              ("run",), ("submit", [3, 3, 3], 4, {}), ("run",)]
    want = drive(je, JB, script)
    got = drive(te, TB, script)
    assert got == want and all(done for _, done in got)
    assert te.stats == je.stats and te.stats["spec_forwards"] > 0
    assert stats(te) == stats(je)
    kw.pop("speculative_k")
    _, plain = engines(weights, **kw)
    assert drive(plain, TB, script) == got


@pytest.mark.parametrize("cache", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("name", ["penalties", "logit_bias", "logprobs", "mixed_staggered"])
def test_paged_controls_match_jax(weights, name, cache):
    """The batch engines' controls through the paged prefill tail and
    decode: the JAX paged engine's tokens, logprobs within 1e-4, top ids,
    prefix-cache counts and blocks in use. For "penalties" the reference
    is the JAX dense engine (the JAX paged engine stops on that script:
    its step's arguments hold the state that the counts rebuild's
    collect donates when it retires a slot; ROADMAP.md queue 3), whose
    tokens the JAX paged engine's equal (tests/test_paged_engine.py
    ``test_paged_penalties_match_dense_engine``)."""
    from tests.test_torch_batching import CONTROL_SCRIPTS, drive_reqs, same_controls
    from tpu_llm.runtime.engine import ModelAdapter as JAdapter

    batch, script = CONTROL_SCRIPTS[name]
    kw = dict(batch=batch, n_blocks=48, block_size=4)
    if cache:
        kw["cache_dtype"] = cache
    je, te = engines(weights, **kw)
    got = drive_reqs(te, TB, script)
    if name == "penalties":
        je = JB.BatchEngine(weights[0], JAdapter.llama(JConfig(**CFG), bos_id=1,
                                                       **({"cache_dtype": cache} if cache else {})),
                            batch=batch, max_seq=CFG["seq_len"])
        same_controls(got, drive_reqs(je, JB, script))
        return
    same_controls(got, drive_reqs(je, JB, script))
    assert stats(te) == stats(je)


def test_paged_speculative_logprobs_match_jax(weights):
    from tests.test_torch_batching import SPEC_CONTROL_SCRIPTS, drive_reqs, same_controls

    batch, script = SPEC_CONTROL_SCRIPTS["penalised_neighbour"]
    je, te = engines(weights, batch=batch, n_blocks=64, block_size=4, speculative_k=3)
    same_controls(drive_reqs(te, TB, script), drive_reqs(je, JB, script))
    assert te.stats == je.stats and te.stats["spec_forwards"] > 0


def test_paged_sampled_filters_stay_in_jax_kept_set(weights, monkeypatch):
    import jax.numpy as jnp

    from tests.test_torch_batching import drive_reqs, jax_kept_sets

    filt = dict(top_k=6, top_p=0.8, min_p=0.05)
    script = [("submit", [5, 11, 8, 3, 9], 10, dict(filt, temperature=0.9, seed=5)),
              ("submit", [3, 9], 8, {}), ("run",)]
    runs = [drive_reqs(engines(weights, batch=2, n_blocks=32, block_size=4)[1], TB, script)
            for _ in range(2)]
    assert [r.tokens for r in runs[0]] == [r.tokens for r in runs[1]]
    r = runs[0][0]
    kept = jax_kept_sets(monkeypatch, weights[0], r, (jnp.int32(6), jnp.float32(0.8),
                                                      jnp.float32(0.05)))
    assert len(kept) == len(r.tokens) == 10 and all(t in k for t, k in zip(r.tokens, kept))
