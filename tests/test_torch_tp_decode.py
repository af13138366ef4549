"""The port's explicit TP decode step (tpu_llm_torch.parallel.tp_decode) on
CPU gloo groups of 4 ranks (one spawn for every case), against the JAX
package: tp 2 against tpu_llm.parallel.tp_decode's shard_map step on its
8 virtual devices; tp 4, the fused layout repacked for tp 2, tp 2 x dp 2
and q4_0 weights against the JAX unsharded decode, which the JAX
package's own tests hold its TP step equal to (tests/test_tp_decode.py).
Tolerances are that file's: 2e-5, and 5e-4 for q4_0."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

import jax.numpy as jnp

from tests.test_torch_llama import to_numpy
from tests.test_tp_decode import CFG, make_params, reference_logits, run_tp
from tests.torch_parallel_ranks import tp_decode_rank
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as JM
from tpu_llm.quant.convert_params import fuse_llama_layers, quantize_llama_params
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.parallel import tp_decode as T
from tpu_llm_torch.parallel.distributed import launch

QCFG = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=8, n_kv_heads=4, vocab_size=512,
            seq_len=32)


def _stacked(params):
    return {k: jnp.stack([lp[k] for lp in params["layers"]]) for k in params["layers"][0]}


@pytest.fixture(scope="module")
def jax_cases():
    cfg = JConfig(**CFG)
    p0, p1 = make_params(cfg), make_params(cfg, seed=1)
    fused = JM.unstack_layers(dict(p1, layers=fuse_llama_layers(_stacked(p1))))
    qcfg = JConfig(**QCFG)
    qp = make_params(qcfg, seed=2)
    qparams = JM.unstack_layers(quantize_llama_params(dict(qp, layers=_stacked(qp)), "q4_0",
                                                      fuse=True))
    tok2, tok1, tok4 = [3, 77], [9], [3, 77, 5, 9]
    tj = lambda t: jnp.asarray(t, jnp.int32)  # noqa: E731
    return {  # name: (params, cfg kwargs, tp, dp, tokens, fused, steps, reference, tolerance)
        "tp2": (p0, CFG, 2, 1, tok2, False, 3, run_tp(p0, cfg, tj(tok2), 0, tp=2), 2e-5),
        "tp4": (p0, CFG, 4, 1, tok2, False, 3, reference_logits(p0, cfg, tj(tok2), 0), 2e-5),
        "tp2_fused": (fused, CFG, 2, 1, tok1, True, 3,
                      reference_logits(p1, cfg, tj(tok1), 0), 2e-5),
        "tp2_dp2": (p0, CFG, 2, 2, tok4, False, 3, reference_logits(p0, cfg, tj(tok4), 0), 2e-5),
        "q4_0_tp2": (qparams, QCFG, 2, 1, [5], True, 2,
                     reference_logits(qparams, qcfg, tj([5]), 0, n_steps=2), 5e-4),
    }


@pytest.fixture(scope="module")
def ranks(jax_cases):
    cases = [(name, to_numpy(p), kw, tp, dp, tok, fused, steps)
             for name, (p, kw, tp, dp, tok, fused, steps, _, _) in jax_cases.items()]
    return launch(tp_decode_rank, 4, cases, device="cpu", timeout=600)


@pytest.mark.parametrize("name", ["tp2", "tp4", "tp2_fused", "tp2_dp2", "q4_0_tp2"])
def test_tp_decode_matches_jax(name, jax_cases, ranks):
    *_, dp, tokens, _, steps, ref, tol = jax_cases[name]
    got_by_rank = [r[name] for r in ranks if name in r]
    assert len(got_by_rank) == jax_cases[name][2] * dp
    for d, got in got_by_rank:
        b = len(tokens) // dp
        assert len(got) == steps
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, np.asarray(r)[d * b:(d + 1) * b], rtol=tol, atol=tol)


def test_repack_matches_jax_permutation():
    """repack_fused_for_tp's columns are the JAX package's."""
    from tpu_llm.parallel.tp_decode import repack_fused_for_tp as jrepack

    cfg = JConfig(**CFG)
    p = make_params(cfg, seed=4)
    fused = JM.unstack_layers(dict(p, layers=fuse_llama_layers(_stacked(p))))
    want = jrepack(fused["layers"], cfg, 2)
    from tpu_llm_torch.models.llama import params_from_numpy

    got = T.repack_fused_for_tp(params_from_numpy(to_numpy(fused))["layers"],
                                TConfig(**CFG), 2)
    for lw, lg in zip(want, got):
        for k in ("wqkv", "w13"):
            np.testing.assert_array_equal(lg[k].numpy(), np.asarray(lw[k]))


def test_tp_param_specs_refuse_biased_layouts():
    with pytest.raises(NotImplementedError, match="unbiased llama layout"):
        T.tp_param_specs(("attn_norm", "ffn_norm", "wqkv", "bqkv", "wo", "w13", "w2"), True)
    assert T.tp_param_specs(("wq", "wo"), False) == {"wq": "col", "wo": "row"}
