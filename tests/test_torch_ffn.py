"""The port's FFN megakernel (K7) on the CPU: its plain twin against the
Pallas kernel it replaces (tpu_llm.quant.pallas_ffn.ffn_fused_pallas,
interpret mode), and the model's forward with TPU_LLM_FFN_MEGAKERNEL set
against the JAX package's forward (which takes the unfused path on the
CPU). Tolerance rtol / atol 2e-2, that of tests/test_ffn_fused.py: bf16
weights and activations on both sides."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as J
from tpu_llm.quant import qtensor as jq
from tpu_llm.quant.pallas_ffn import ffn_fused_pallas
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models import llama as T
from tpu_llm_torch.quant import ffn as tffn
from tpu_llm_torch.quant import qtensor as tq
from tests.test_torch_llama import CFG, jax_params, to_numpy

TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows", [1, 8])
def test_plain_matches_pallas_interpret(kind, rows):
    rng = np.random.default_rng(rows)
    E, F = 512, 1024
    w13 = (rng.standard_normal((E, 2 * F)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((F, E)) * 0.05).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((rows, E)), jnp.bfloat16)
    want = np.asarray(ffn_fused_pallas(x, jq.quantize_tensor(w13, kind),
                                       jq.quantize_tensor(w2, kind), interpret=True)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    got = tffn.ffn_fused(xt, tq.quantize_tensor(w13, kind), tq.quantize_tensor(w2, kind))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, E)
    assert tffn.ffn_fused.launches == 0
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


def test_gates():
    w = np.random.default_rng(0).standard_normal((256, 64)).astype(np.float32)
    q4, q8, k = (tq.quantize_tensor(w, c) for c in ("q4_0", "q8_0", "q4_k"))
    assert tffn.ffn_ok(q4, q4) and tffn.ffn_ok(q8, q8)
    assert not tffn.ffn_ok(q4, q8)                      # one kind for both
    assert not tffn.ffn_ok(k, k)                        # q4_1 (from Q4_K)
    assert not tffn.ffn_ok(torch.from_numpy(w), q4)     # dense weights


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_forward_with_megakernel_matches_jax(monkeypatch, kind):
    """bf16 activations (a bf16 embedding), fused q4_0 / q8_0 weights:
    decode steps at batch 2 take the megakernel twin; a 10-token prompt
    (> 8 rows) stays unfused, as in the JAX package."""
    monkeypatch.setenv("TPU_LLM_FFN_MEGAKERNEL", "1")
    calls = []
    plain = tffn.ffn_fused_plain
    monkeypatch.setattr(tffn, "ffn_fused_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    jp = jax_params(kind)
    jp = dict(jp, tok_emb=jp["tok_emb"].astype(jnp.bfloat16))
    tp = T.params_from_numpy(to_numpy(jp))
    jcfg, tcfg = JConfig(**CFG), TConfig(**CFG)
    toks = np.asarray([[1, 4, 9, 16, 25, 36, 49, 64, 81, 3]] * 2, np.int32)
    jc = J.init_cache(jcfg, 2, CFG["seq_len"], dtype=jnp.bfloat16)
    tc = T.init_cache(tcfg, 2, CFG["seq_len"], dtype=torch.bfloat16)
    _, jc = J.forward(jp, jcfg, jnp.asarray(toks), jc, jnp.int32(0))
    T.forward(tp, tcfg, torch.from_numpy(toks), tc, 0)
    assert calls == []
    for pos, tok in enumerate([5, 17, 2], start=10):
        step = np.asarray([tok, (tok * 3) % 96], np.int32)
        jl, jc = J.decode_step(jp, jcfg, jnp.asarray(step), jc, jnp.int32(pos))
        tl, tc = T.decode_step(tp, tcfg, torch.from_numpy(step), tc, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert len(calls) == 3 * CFG["n_layers"]


# -- K7 on K1's tensor-core tile: its plan and its order of sums ----------------

@pytest.mark.parametrize("ctas", [528, 32])
@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows", [1, 8])
def test_split_plain_matches_plain_and_pallas(kind, rows, ctas):
    """ffn_fused_split_plain (the kernel's K-split partials summed in split
    order, the gate on the merged sums) against the plain twin and the
    Pallas kernel in interpret mode; 2e-2 as above. The plans split both
    phases here (E 512, F 1024: w13 in 4 splits and w2 in 8 for an H100's
    528 co-resident CTAs, w13 in 2 for 32)."""
    rng = np.random.default_rng(20 + rows)
    E, F = 512, 1024
    w13 = (rng.standard_normal((E, 2 * F)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((F, E)) * 0.05).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((rows, E)), jnp.bfloat16)
    plan = tffn.ffn_plan(E, F, ctas)
    assert plan.ks_a > 1 and plan.ks_b > 1
    want = np.asarray(ffn_fused_pallas(x, jq.quantize_tensor(w13, kind),
                                       jq.quantize_tensor(w2, kind), interpret=True)
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    t13, t2 = tq.quantize_tensor(w13, kind), tq.quantize_tensor(w2, kind)
    got = tffn.ffn_fused_split_plain(xt, t13, t2, ctas)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, E)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               tffn.ffn_fused_plain(xt, t13, t2).float().numpy(), **TOL)


def _covered(ks, kbps, nkb):
    """The 32-row blocks of each split, in split order."""
    return [list(range(s * kbps, min(nkb, (s + 1) * kbps))) for s in range(ks)]


@pytest.mark.parametrize("E,F", [(2048, 5632), (512, 1024), (64, 96), (4096, 11008),
                                 (3072, 8192)])
@pytest.mark.parametrize("ctas", [528, 660, 132, 7, 1])
def test_plan_covers_every_block_once(E, F, ctas):
    """ffn_plan: each 32-row block of E (phase A) and of F (phase B) in
    exactly one split, no split empty; every item reached by one CTA of the
    grid (blockIdx.x + i * grid); the grid never past the co-resident
    CTAs; about one item a CTA where K allows."""
    plan = tffn.ffn_plan(E, F, ctas)
    assert 1 <= plan.grid <= ctas
    for tiles, ks, kbps, nkb in ((plan.tiles_a, plan.ks_a, plan.kbps_a, E // 32),
                                 (plan.tiles_b, plan.ks_b, plan.kbps_b, F // 32)):
        splits = _covered(ks, kbps, nkb)
        assert all(splits) and sum(splits, []) == list(range(nkb))
        items = tiles * ks
        reached = sorted(i for c in range(plan.grid) for i in range(c, items, plan.grid))
        assert reached == list(range(items))
        assert ks == 1 or items <= ctas             # a K split never makes a second wave
    assert plan.tiles_a * tffn.GATE_COLS >= F and plan.tiles_b * tffn.COLS >= E
