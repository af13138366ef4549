"""The port's dense int8 KV cache against tpu_llm's on the CPU:
``update_kv_cache`` into ``QuantKV`` planes (flat and 4D, a scalar and a
per-row offset, T 1 and 3) gives the JAX package's int8 planes exactly
and its scales within 1e-6 relative; ``init_cache("int8")`` has its
per-layer flat planes; and a llama prefill + decode over the int8 cache
gives the JAX package's logits within 2e-4 (tests/test_llama.py's
tolerance), on the einsum path and on the dequantize-then-flash route."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_torch_llama import CFG, TOL, both
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as J
from tpu_llm.ops import attention as JA
from tpu_llm.ops.kv_cache import QuantKV as JQuantKV
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models import llama as T
from tpu_llm_torch.ops import attention as TA
from tpu_llm_torch.ops.kv_cache import QuantKV

SCALE_RTOL = 1e-6


def _assert_quant_equal(got: QuantKV, want: JQuantKV):
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "4d"])
@pytest.mark.parametrize("T_", [1, 3])
@pytest.mark.parametrize("offset", [4, [0, 9], [14, 2]], ids=["scalar", "rows", "clamped"])
def test_update_kv_cache_int8_matches_jax(flat, T_, offset):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 16, 4, 8
    k = rng.standard_normal((B, T_, H, D)).astype(np.float32)
    v = rng.standard_normal((B, T_, H, D)).astype(np.float32)
    # start from non-zero planes: rows outside the write must keep them
    kc0 = [rng.integers(-127, 128, (B, S, H, D)).astype(np.int8),
           rng.random((B, S, H)).astype(np.float32)]
    vc0 = [rng.integers(-127, 128, (B, S, H, D)).astype(np.int8),
           rng.random((B, S, H)).astype(np.float32)]

    def planes(c, lib):
        q, s = c
        if flat:
            q, s = q.reshape(B, S, H * D), s.transpose(0, 2, 1)
        if lib == "jax":
            return JQuantKV(jnp.asarray(q), jnp.asarray(s))
        return QuantKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()))

    off_j = jnp.asarray(offset, jnp.int32)
    off_t = offset if isinstance(offset, int) else torch.tensor(offset, dtype=torch.int32)
    jk, jv = JA.update_kv_cache(planes(kc0, "jax"), planes(vc0, "jax"), jnp.asarray(k),
                                jnp.asarray(v), off_j)
    tk, tv = TA.update_kv_cache(planes(kc0, "torch"), planes(vc0, "torch"),
                                torch.from_numpy(k), torch.from_numpy(v), off_t)
    _assert_quant_equal(tk, jk)
    _assert_quant_equal(tv, jv)


def test_init_cache_int8_matches_jax():
    jc = J.init_cache(JConfig(**CFG), 2, 24, dtype="int8", stacked=False)
    tc = T.init_cache(TConfig(**CFG), 2, 24, dtype="int8")
    for name in ("k", "v"):
        assert len(tc[name]) == len(jc[name]) == CFG["n_layers"]
        for t, j in zip(tc[name], jc[name]):
            assert isinstance(t, QuantKV)
            assert tuple(t.q.shape) == j.q.shape and t.q.dtype == torch.int8
            assert tuple(t.s.shape) == j.s.shape and t.s.dtype == torch.float32
            assert not t.q.any() and not t.s.any()


@pytest.mark.parametrize("flash_prefill", [False, True], ids=["einsum", "flash"])
def test_prefill_and_decode_over_int8_cache_match_jax(flash_prefill, monkeypatch):
    """Prefill 8 tokens and decode 4 over the int8 cache: the logits of
    every step within 2e-4 of the JAX package's. ``flash`` lowers the
    prefill gate so the port dequantizes the planes to bf16 for K4's twin
    (JAX on the CPU keeps its einsum path), held at bf16's 2e-2."""
    if flash_prefill:
        monkeypatch.setattr(T, "FLASH_PREFILL_SCORES_BYTES", 0)
    jp, tp = both("q4_0")
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, CFG["vocab_size"], (1, 8))
    jcache = J.init_cache(jcfg, 1, CFG["seq_len"], dtype="int8", stacked=True)
    tcache = T.init_cache(tcfg, 1, CFG["seq_len"], dtype="int8")
    jh, jcache = J.forward(jp, jcfg, jnp.asarray(ids, jnp.int32), jcache, jnp.int32(0))
    th, tcache = T.forward(tp, tcfg, torch.from_numpy(ids), tcache, 0)
    tol = dict(rtol=2e-2, atol=2e-2) if flash_prefill else TOL
    np.testing.assert_allclose(T.lm_head(tp, tcfg, th).numpy(),
                               np.asarray(J.lm_head(jp, jcfg, jh)), **tol)
    tok = np.asarray([7])
    for i in range(4):
        jl, jcache = J.decode_step(jp, jcfg, jnp.asarray(tok, jnp.int32), jcache,
                                   jnp.int32(8 + i))
        tl, tcache = T.decode_step(tp, tcfg, torch.from_numpy(tok), tcache, 8 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        tok = np.asarray(jl).argmax(-1)
