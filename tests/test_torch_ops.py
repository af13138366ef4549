"""Elementwise ops of the port against tpu_llm.ops on the CPU: the same
numpy inputs through both, f32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tpu_llm.ops import activations as jact
from tpu_llm.ops import norms as jnorms
from tpu_llm.ops import rope as jrope
from tpu_llm.ops import sampling as jsamp
from tpu_llm_torch.ops import activations as tact
from tpu_llm_torch.ops import norms as tnorms
from tpu_llm_torch.ops import rope as trope
from tpu_llm_torch.ops import sampling as tsamp


def _np(t):
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("shape", [(1, 1, 64), (2, 5, 96)])
def test_rmsnorm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jnorms.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tnorms.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    # f32 rsqrt/mean differ by an ulp or so between the two libraries
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_rmsnorm_eps_inside_sqrt():
    x = np.zeros((1, 4), np.float32)
    x[0, 0] = 1e-3
    got = _np(tnorms.rmsnorm(torch.from_numpy(x), None, 1e-5))
    np.testing.assert_allclose(got[0, 0], 1e-3 / np.sqrt(1e-6 / 4 + 1e-5), rtol=1e-6)


def test_silu():
    x = np.linspace(-8, 8, 257, dtype=np.float32)
    np.testing.assert_allclose(_np(tact.silu(torch.from_numpy(x))),
                               _np(jact.silu(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", ["interleaved", "neox", "llmf90"])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_rope(variant, head_dim):
    rng = np.random.default_rng(1)
    B, T, H = 2, 7, 3
    x = rng.standard_normal((B, T, H, head_dim)).astype(np.float32)
    pos = np.arange(100, 100 + T, dtype=np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, variant)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0, variant)
    # sin/cos of angles up to ~100 rad: the two libraries' f32 transcendentals
    # agree to a few ulp of the angle
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_rope_angles_shape_and_values():
    pos = np.asarray([[0, 3], [5, 2047]], np.int32)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 64)
    tc, ts = trope.rope_angles(torch.from_numpy(pos), 64)
    assert tuple(tc.shape) == jc.shape == (2, 2, 32)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=2e-4)
    np.testing.assert_allclose(_np(ts), _np(js), atol=2e-4)


def test_greedy_first_max_wins():
    logits = np.asarray([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 5.0, 5.0]], np.float32)
    got = tsamp.greedy(torch.from_numpy(logits))
    want = jsamp.greedy(jnp.asarray(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cdf_sample_same_uniform(seed):
    """Given JAX's own uniform draw, the port's inverse-CDF pick equals
    jax's _cdf_sample."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 2
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    key = jax.random.PRNGKey(seed)
    r = jax.random.uniform(key, probs.shape[:-1] + (1,), dtype=probs.dtype)
    want = jsamp._cdf_sample(key, probs)
    got = tsamp.cdf_sample(torch.from_numpy(np.array(probs)),
                           torch.from_numpy(np.array(r)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cdf_sample_falls_back_to_last_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25]])
    assert int(tsamp.cdf_sample(probs, torch.tensor([[1.5]]))[0]) == 3
    assert int(tsamp.cdf_sample(probs, torch.tensor([[0.0]]))[0]) == 0


def test_select_token_seeded():
    logits = torch.randn(2, 40, generator=torch.Generator().manual_seed(0))
    draw = lambda s: tsamp.select_token(logits, 0.8, torch.Generator().manual_seed(s))  # noqa: E731
    assert torch.equal(draw(5), draw(5))
    assert torch.equal(tsamp.select_token(logits, 0.0, None), tsamp.greedy(logits))
