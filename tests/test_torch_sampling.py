"""The port's sampling controls against the JAX package's on the CPU, with
the same uniform draw: ``filtered_sample`` (per-row top-k with ties at
the k-th logit, top-p, min-p, their mix, temperature 0), ``sample_token``
and ``masked_softmax`` (tpu_llm.ops.sampling), and the batch engines'
helpers ``_apply_penalties``, ``_bias_row``, ``_token_logprob`` and
``_top_rows`` (tpu_llm.runtime.batching). Token ids must be equal;
probabilities and logprobs within 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tpu_llm.ops import sampling as JS
from tpu_llm.runtime import batching as JB
from tpu_llm_torch.ops import sampling as TS
from tpu_llm_torch.runtime import batching as TB

B, V = 6, 97
ROWS = 24          # uniforms a row: each draw probes the row's CDF at another point


def _logits(seed: int, ties: bool) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(B, V)).astype(np.float32) * 3
    # rounded to one decimal, many logits tie, at the k-th one too
    return np.round(x, 1) if ties else x


CASES = {
    "top_k": dict(temp=[0.8] * B, k=[1, 2, 3, 5, 10, 96], p=[1.0] * B, m=[0.0] * B),
    "top_p": dict(temp=[0.7, 1.0, 1.3, 0.5, 1.0, 2.0], k=[0] * B,
                  p=[0.1, 0.5, 0.9, 0.95, 0.3, 0.999], m=[0.0] * B),
    "min_p": dict(temp=[1.0, 0.6, 1.5, 1.0, 0.9, 1.2], k=[0] * B, p=[1.0] * B,
                  m=[0.01, 0.05, 0.1, 0.3, 0.5, 0.9]),
    "mix": dict(temp=[0.0, 0.7, 1.0, 1.3, 0.9, 1.0], k=[5, 0, 3, 7, 0, 200],
                p=[1.0, 0.9, 0.5, 1.0, 0.3, 0.8], m=[0.0, 0.0, 0.05, 0.2, 0.1, 0.02]),
    "temperature_0": dict(temp=[0.0] * B, k=[0, 3, 0, 1, 5, 0], p=[1.0, 0.5, 0.2, 1.0, 1.0, 0.9],
                          m=[0.0, 0.0, 0.3, 0.0, 0.1, 0.0]),
    "identity": dict(temp=[1.0, 0.5, 2.0, 1.0, 0.8, 1.1], k=[0] * B, p=[1.0] * B, m=[0.0] * B),
}

_JAX_FILTERED = jax.jit(jax.vmap(JS.filtered_sample))


def _uniform(key, shape):
    """The uniform JAX's _cdf_sample draws from ``key``."""
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", list(CASES))
def test_filtered_sample_matches_jax(case, ties):
    c = CASES[case]
    x = _logits(len(case), ties)
    knobs = [np.asarray(c["temp"], np.float32), np.asarray(c["k"], np.int32),
             np.asarray(c["p"], np.float32), np.asarray(c["m"], np.float32)]
    keys_all = jax.random.split(jax.random.PRNGKey(3), ROWS * B).reshape(ROWS, B, -1)
    got, want = [], []
    for keys in keys_all:
        want.append(np.asarray(_JAX_FILTERED(jnp.asarray(x), keys, *map(jnp.asarray, knobs))))
        r = np.stack([_uniform(k, (1,)) for k in keys])
        got.append(TS.filtered_sample(torch.from_numpy(x), torch.from_numpy(r),
                                      *map(torch.from_numpy, knobs)).numpy())
    got, want = np.stack(got), np.stack(want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "top_k":
        # rows keep only ids at or above their k-th logit (ties included)
        kth = -np.sort(-x, axis=1)[np.arange(B), np.asarray(c["k"]) - 1]
        assert (x[np.arange(B), got] >= kth).all()
    if case == "temperature_0":
        assert (got == x.argmax(1)).all()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", list(CASES))
def test_filtered_probs_match_jax(monkeypatch, case, ties):
    """The distribution drawn from: JAX's, observed at its draw, within
    1e-6 relative, and zero at the same ids but for the top-p boundary:
    ids whose exclusive cumulative sum lies within 1e-5 of top_p, where
    the two packages' roundings of the softmax decide (at top_p >= 1 the
    port keeps every id, as the filter's contract says; JAX may drop a
    tail whose exclusive sum rounds up to 1)."""
    c = CASES[case]
    x = _logits(len(case) + 1, ties)
    seen = []
    monkeypatch.setattr(JS, "_cdf_sample", lambda key, probs: seen.append(probs) or jnp.int32(0))
    for b in range(B):
        JS.filtered_sample(jnp.asarray(x[b]), None, jnp.float32(c["temp"][b]),
                           jnp.int32(c["k"][b]), jnp.float32(c["p"][b]), jnp.float32(c["m"][b]))
    want = np.stack([np.asarray(p) for p in seen])
    got = TS.filtered_probs(torch.from_numpy(x), torch.tensor(c["temp"]), torch.tensor(c["k"]),
                            torch.tensor(c["p"]), torch.tensor(c["m"])).numpy()
    for b in range(B):
        if c["temp"][b] == 0:
            continue                             # temperature 0 samples greedily
        w = want[b].astype(np.float64)
        order = np.argsort(-w, kind="stable")
        excl = np.empty_like(w)
        excl[order] = np.cumsum(w[order]) - w[order]
        boundary = np.abs(excl - min(c["p"][b], 1.0)) < 1e-5
        np.testing.assert_array_equal((got[b] == 0)[~boundary], (want[b] == 0)[~boundary])
        both = (got[b] > 0) & (want[b] > 0)
        np.testing.assert_allclose(got[b][both], want[b][both], rtol=1e-6)
        assert both.sum() >= 1


def test_filtered_sample_scalar_knobs_and_device_agnostic_r():
    """Scalar knobs broadcast over the rows, as (B,) vectors of them do."""
    x = torch.from_numpy(_logits(7, False))
    r = torch.rand((B, 1), generator=torch.Generator().manual_seed(1))
    a = TS.filtered_sample(x, r, 0.8, 4, 0.9, 0.05)
    b = TS.filtered_sample(x, r, torch.full((B,), 0.8), torch.full((B,), 4),
                           torch.full((B,), 0.9), torch.full((B,), 0.05))
    assert torch.equal(a, b)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, None, None), (0.8, None, None), (0.8, 5, None), (1.2, None, 0.6),
    (0.9, 4, 0.8), (1.0, 1, None), (0.7, 0, 1.0)])
def test_sample_token_matches_jax(temperature, top_k, top_p):
    x = _logits(11, True)
    for s in range(ROWS):
        key = jax.random.PRNGKey(s)
        want = np.asarray(JS.sample_token(key, jnp.asarray(x), temperature, top_k, top_p))
        r = _uniform(key, (B, 1))
        got = TS.sample_token(torch.from_numpy(x), temperature, top_k, top_p,
                              r=torch.from_numpy(r)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 5, 96, 97])
def test_masked_softmax_matches_jax(n):
    x = _logits(5, False)
    want = np.asarray(JS.masked_softmax(jnp.asarray(x), n))
    got = TS.masked_softmax(torch.from_numpy(x), n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    assert (got[:, n:] == 0).all()


def _counts(seed: int) -> np.ndarray:
    c = np.random.default_rng(seed).integers(0, 4, size=(B, V)).astype(np.int32)
    c[:, ::3] = 0
    return c


@pytest.mark.parametrize("fp,pp,rp", [(0.0, 0.0, 1.0), (0.5, 0.0, 1.0), (0.0, 0.8, 1.0),
                                      (0.0, 0.0, 1.3), (0.3, 0.2, 0.7), (1e9, 0.0, 1.0)])
def test_apply_penalties_matches_jax(fp, pp, rp):
    x, c = _logits(2, False), _counts(2)
    rows = np.arange(B, dtype=np.float32) / B
    knobs = [np.float32(fp) * (1 + rows), np.float32(pp) * (1 + rows),
             np.float32(rp) + 0 * rows]
    want = np.asarray(JB._apply_penalties(jnp.asarray(x), jnp.asarray(c),
                                          *map(jnp.asarray, knobs)))
    got = TB._apply_penalties(torch.from_numpy(x), torch.from_numpy(c),
                              *map(torch.from_numpy, knobs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("bias", [None, {}, {"4": 100}, {4: -250.0, "7": 3.5, "96": 1e9},
                                  {"97": 5, "-1": 5, 0: -0.5}])
def test_bias_row_matches_jax(bias):
    got = TB._bias_row(TB.Request(prompt=[1], max_new=1, logit_bias=bias), V)
    want = JB._bias_row(JB.Request(prompt=[1], max_new=1, logit_bias=bias), V)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(B,), (2, 3)], ids=["step", "verify_window"])
def test_token_logprob_matches_jax(shape):
    x = _logits(4, False).reshape(*shape, V)
    toks = np.random.default_rng(4).integers(0, V, size=shape).astype(np.int32)
    want = np.asarray(JB._token_logprob(jnp.asarray(x), jnp.asarray(toks)))
    got = TB._token_logprob(torch.from_numpy(x), torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_top_rows_match_jax(ties):
    """Values equal within 1e-6; ids equal as sets within each group of
    equal values (topk orders ties freely), and each id's logprob is its
    value."""
    x = _logits(6, ties)
    wv, wi = (np.asarray(a) for a in JB._top_rows(jnp.asarray(x)))
    gv, gi = (a.numpy() for a in TB._top_rows(torch.from_numpy(x)))
    assert gv.shape == gi.shape == (B, TB._TOPN) and gi.dtype == np.int32
    np.testing.assert_allclose(gv, wv, rtol=1e-6)
    lp = x - np.log(np.exp(x.astype(np.float64)).sum(1, keepdims=True))
    for b in range(B):
        # a group: the ids of one logit value (tied logits are >= 0.1 apart
        # from the others; the two packages' values differ in the last bits)
        kw, kg = np.round(wv[b], 4), np.round(gv[b], 4)
        for v in np.unique(kw):
            # the last group may be cut at _TOPN: its ids lie among the tied ids
            grp_w, grp_g = set(wi[b][kw == v]), set(gi[b][kg == v])
            tied = set(np.flatnonzero(np.isclose(lp[b], v, rtol=0, atol=1e-3)))
            assert len(grp_g) == len(grp_w) and grp_g <= tied and grp_w <= tied
        if not ties:
            np.testing.assert_array_equal(gi[b], wi[b])
