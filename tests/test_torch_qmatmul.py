"""The plain twin of the port's qmatmul kernel against the Pallas kernel it
replaces (tpu_llm.quant.pallas_matmul.qmatmul_pallas, interpret mode) on
the same packed weights, and the linear dispatch against tpu_llm's."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_llm.quant import linear as jlinear
from tpu_llm.quant import qtensor as jq
from tpu_llm.quant.pallas_matmul import qmatmul_pallas
from tpu_llm_torch.quant import linear as tlinear
from tpu_llm_torch.quant import qmatmul as tqm
from tpu_llm_torch.quant import qtensor as tq


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
    ks, kbps = tqm.k_split(rows, K, N)
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
