"""The port's continuous-batching engine (tpu_llm_torch.runtime.batching)
against tpu_llm.runtime.batching.BatchEngine on the CPU: the same q4_0
weights (carried across with params_from_numpy), the same requests and
the same sequence of engine steps give identical greedy token lists. A
sampled request's stream equals the port's single-stream Engine with the
same seed (the two packages' random streams differ by design)."""

import numpy as np
import pytest
import torch

from tests.test_torch_llama import jax_params, to_numpy
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.runtime import batching as JB
from tpu_llm.runtime import engine as JE
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models import llama as TM
from tpu_llm_torch.models.llama import params_from_numpy
from tpu_llm_torch.runtime import batching as TB
from tpu_llm_torch.runtime import engine as TE

CFG = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
           vocab_size=96, seq_len=64)


@pytest.fixture(scope="module")
def weights():
    jp = jax_params("q4_0")
    return jp, params_from_numpy(to_numpy(jp))


def engines(weights, batch):
    jp, tp = weights
    je = JB.BatchEngine(jp, JE.ModelAdapter.llama(JConfig(**CFG), bos_id=1),
                        batch=batch, max_seq=CFG["seq_len"])
    te = TB.BatchEngine(tp, TE.ModelAdapter.llama(TConfig(**CFG), device="cpu"),
                        batch=batch, max_seq=CFG["seq_len"])
    return je, te


def drive(eng, mod, script):
    """Run ``script`` (a list of ("submit", prompt, n_new, kw) / ("step",) /
    ("until_done", i) / ("cancel", i) / ("run",)) on one engine; returns the
    requests' token lists and done flags."""
    reqs = []
    for op, *a in script:
        if op == "submit":
            reqs.append(eng.submit(mod.Request(prompt=a[0], max_new=a[1], **a[2])))
        elif op == "step":
            eng.step()
        elif op == "until_done":
            while not reqs[a[0]].done:
                eng.step()
        elif op == "cancel":
            assert eng.cancel(reqs[a[0]])
        elif op == "run":
            eng.run()
    return [(r.tokens, r.done) for r in reqs]


SCRIPTS = {
    "three_prompts": (4, [("submit", [5, 11], 5, {}), ("submit", [3], 6, {}),
                          ("submit", [9, 2, 40], 4, {}), ("run",)]),
    # r1 finishes, r3 is admitted into its slot mid-flight (slot reuse)
    "staggered_admission": (2, [("submit", [5, 11], 3, {}), ("submit", [3], 8, {}),
                                ("until_done", 0), ("submit", [7, 7, 24], 4, {}),
                                ("run",)]),
    "long_prompt_mid_decode": (2, [("submit", [5, 11], 8, {}), ("step",), ("step",),
                                   ("submit", list(range(2, 42)), 4, {}), ("run",)]),
    # cancel a live request and a queued one, then reuse the slot
    "cancel_live_and_queued": (1, [("submit", [5, 11], 10, {}), ("submit", [3, 4], 5, {}),
                                   ("step",), ("step",), ("cancel", 0), ("cancel", 1),
                                   ("submit", [9, 2], 4, {}), ("run",)]),
    "slot_reuse_after_run": (1, [("submit", [5, 11], 3, {}), ("run",),
                                 ("submit", [9, 4, 7], 5, {}), ("run",)]),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_greedy_tokens_match_jax(weights, name):
    batch, script = SCRIPTS[name]
    je, te = engines(weights, batch)
    want = drive(je, JB, script)
    got = drive(te, TB, script)
    assert got == want
    assert all(done for _, done in got)


def test_eos_and_stop_ids_retire(weights):
    je, te = engines(weights, 2)
    first = drive(te, TB, [("submit", [6], 1, {}), ("run",)])[0][0][0]
    for eng, mod in ((je, JB), (te, TB)):
        eng.eos_id = first
    script = [("submit", [6], 10, {"stop_at_eos": True}),
              ("submit", [6], 10, {"stop_at_eos": True, "stop_token_ids": [first]}),
              ("submit", [6], 3, {}), ("run",)]
    want = drive(je, JB, script)
    got = drive(te, TB, script)
    assert got == want and got[0][0] == [first] and len(got[2][0]) == 3


def test_sampled_stream_matches_single_stream(weights):
    """A sampled request next to a greedy one: its tokens are the port's
    single-stream Engine's with the same seed."""
    _, tp = weights
    _, te = engines(weights, 3)
    r1 = te.submit(TB.Request(prompt=[4, 9], max_new=8, temperature=0.8, seed=123))
    r2 = te.submit(TB.Request(prompt=[5, 11, 3], max_new=6))
    r3 = te.submit(TB.Request(prompt=[4, 9], max_new=8, temperature=0.8, seed=7))
    te.run()
    se = TE.Engine(tp, TE.ModelAdapter.llama(TConfig(**CFG), device="cpu"),
                   max_seq=CFG["seq_len"], device="cpu")
    for r in (r1, r3):
        want = se.generate(r.prompt, n_new=8, temperature=0.8, seed=r.seed).tokens
        assert r.tokens == want[len(r.prompt):]
    assert r1.tokens != r3.tokens
    assert r2.tokens == se.generate([5, 11, 3], n_new=6).tokens[3:]


@pytest.mark.parametrize("field", [{"top_k": 5}, {"top_p": 0.9}, {"min_p": 0.1},
                                   {"logprobs": True}, {"top_logprobs": 2},
                                   {"frequency_penalty": 0.5},
                                   {"repetition_penalty": 1.1},
                                   {"logit_bias": {"3": 5.0}}])
def test_controls_outside_the_slice_are_refused(weights, field):
    _, te = engines(weights, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.submit(TB.Request(prompt=[5], max_new=2, **field))


def test_reset_then_same_tokens(weights):
    _, te = engines(weights, 2)
    r1 = te.submit(TB.Request(prompt=[5, 9, 3], max_new=6))
    te.submit(TB.Request(prompt=[8], max_new=20))
    te.step()
    te.reset()
    assert te.n_active == 0 and not te._queue
    r2 = te.submit(TB.Request(prompt=[5, 9, 3], max_new=6))
    te.run()
    _, fresh = engines(weights, 2)
    r3 = fresh.submit(TB.Request(prompt=[5, 9, 3], max_new=6))
    fresh.run()
    assert r2.tokens == r3.tokens and not r1.done


def test_dense_int8_cache_is_refused():
    """What a dense int8 cache is still refused: the fused decode + append
    (defer_kv, K3), whose kernel takes float caches only."""
    cfg = TConfig(**CFG)
    _, tp = _weights_q4_0()
    cache = TM.init_cache(cfg, 1, CFG["seq_len"], "int8", "cpu")
    with pytest.raises(ValueError, match="float caches"):
        TM.decode_step(tp, cfg, torch.ones(1, dtype=torch.long), cache, 3, defer_kv=True)


def test_dense_int8_cache_matches_jax():
    """The adapter serves int8 QuantKV planes: the same greedy tokens as
    the JAX engine over its int8 cache."""
    jp, tp = _weights_q4_0()
    je = JB.BatchEngine(jp, JE.ModelAdapter.llama(JConfig(**CFG), cache_dtype="int8"),
                        batch=2, max_seq=CFG["seq_len"])
    te = TB.BatchEngine(tp, TE.ModelAdapter.llama(TConfig(**CFG), cache_dtype="int8",
                                                  device="cpu"),
                        batch=2, max_seq=CFG["seq_len"])
    script = SCRIPTS["staggered_admission"][1]
    assert drive(te, TB, script) == drive(je, JB, script)


def _weights_q4_0(seed: int = 0):
    jp = jax_params("q4_0", seed=seed)
    return jp, params_from_numpy(to_numpy(jp))


def spec_engines(weights, batch, k, draft=None, cache_dtype=None):
    """The JAX and port BatchEngines with ``speculative_k`` k; ``draft`` a
    (jax params, port params) pair of a draft model of CFG's shape."""
    jp, tp = weights
    kw = {} if cache_dtype is None else {"cache_dtype": cache_dtype}
    jd = td = None
    if draft is not None:
        jd = (draft[0], JE.ModelAdapter.llama(JConfig(**CFG), bos_id=1))
        td = (draft[1], TE.ModelAdapter.llama(TConfig(**CFG), device="cpu"))
    je = JB.BatchEngine(jp, JE.ModelAdapter.llama(JConfig(**CFG), bos_id=1, **kw),
                        batch=batch, max_seq=CFG["seq_len"], speculative_k=k, draft=jd)
    te = TB.BatchEngine(tp, TE.ModelAdapter.llama(TConfig(**CFG), device="cpu", **kw),
                        batch=batch, max_seq=CFG["seq_len"], speculative_k=k, draft=td)
    return je, te


# repetitive prompts, so that prompt lookup finds drafts that get accepted;
# the 58-token prompt reaches the end of the 64-row cache (plain steps there)
SPEC_SCRIPTS = {
    "repetitive": (4, [("submit", [5, 11, 5, 11, 5], 6, {}), ("submit", [3, 3, 3], 7, {}),
                       ("submit", [9, 2, 9, 2], 5, {}), ("run",)]),
    "staggered": (2, [("submit", [5, 11, 5, 11], 3, {}), ("submit", [7, 8, 7, 8, 7], 9, {}),
                      ("until_done", 0), ("submit", [4, 6, 4, 6], 6, {}), ("run",)]),
    "cache_end": (2, [("submit", [5, 11] * 29, 5, {}), ("submit", [9, 2, 9], 6, {}),
                      ("run",)]),
}


@pytest.mark.parametrize("drafter", ["lookup", "draft_model"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", list(SPEC_SCRIPTS))
def test_speculative_tokens_match_jax(weights, name, k, drafter):
    """Batched speculation (prompt lookup, or a draft model from another
    seed): the JAX engine's tokens and spec stats, and the plain greedy
    stream of the port's own plain engine."""
    batch, script = SPEC_SCRIPTS[name]
    draft = _weights_q4_0(seed=1) if drafter == "draft_model" else None
    je, te = spec_engines(weights, batch, k, draft)
    want = drive(je, JB, script)
    got = drive(te, TB, script)
    assert got == want and all(done for _, done in got)
    assert te.stats == je.stats and te.stats["spec_forwards"] > 0
    _, plain = engines(weights, batch)
    assert drive(plain, TB, script) == got


def test_speculative_mixed_temperature(weights):
    """A sampled slot in a speculative batch emits the stream it emits in
    the port's plain engine (one draw a step, no drafts accepted); the
    greedy slot's tokens are the JAX spec engine's."""
    script = [("submit", [4, 4, 4], 6, {"temperature": 0.8, "seed": 42}),
              ("submit", [5, 11, 5, 11], 6, {}), ("run",)]
    je, te = spec_engines(weights, 4, 3)
    got = drive(te, TB, script)
    _, plain = engines(weights, 4)
    assert got == drive(plain, TB, script)
    assert got[1] == drive(je, JB, script)[1]


def test_speculative_eos_stop(weights):
    _, te = engines(weights, 2)
    first = drive(te, TB, [("submit", [6], 1, {}), ("run",)])[0][0][0]
    je, te = spec_engines(weights, 2, 4)
    for eng in (je, te):
        eng.eos_id = first
    script = [("submit", [6], 10, {"stop_at_eos": True}), ("run",)]
    got = drive(te, TB, script)
    assert got == drive(je, JB, script) and got[0][0] == [first]


def test_speculative_int8_cache(weights):
    """Speculation over the dense int8 cache: the JAX int8 spec engine's
    tokens, and the port's plain int8 engine's."""
    script = [("submit", [5, 11, 5, 11], 6, {}), ("submit", [9, 2, 9], 6, {}), ("run",)]
    je, te = spec_engines(weights, 2, 3, cache_dtype="int8")
    got = drive(te, TB, script)
    assert got == drive(je, JB, script)
    plain = TB.BatchEngine(weights[1], TE.ModelAdapter.llama(
        TConfig(**CFG), cache_dtype="int8", device="cpu"), batch=2, max_seq=CFG["seq_len"])
    assert drive(plain, TB, script) == got
