"""The port's `llm-bench` (tpu_llm_torch.runtime.bench_cli) on the CPU at a
tiny size (TinyLlama and Llama-2 7B swapped for tiny configs, the 7B
stand-in with head_dim 128 and one q head a kv head):

- every row family prints JSON lines whose metric and unit are the names
  tpu_llm.runtime.bench_cli's f-strings give for the same args (the JAX
  bench run with its builders, timers and engine stubbed out, so only its
  printing runs; phi-2 and the synthetic MoE at shrunk configs), and the
  rows waiting for later slices (mamba*, the parallel rows) exit 2;
- synth_quant_llama / _synth_qtensor / random_llama_params / _build_phi2
  / _build_moe give the JAX package's tree, kinds, shapes and dtypes for every kind and switch (the
  values differ: the RNGs do);
- the timed decode program emits the greedy tokens of a plain
  decode_step loop over the same weights, exactly; the paged program
  emits the dense program's tokens.
"""

import json
import types

import numpy as np
import pytest

import torch

from tpu_llm import config as jconfig
from tpu_llm.runtime import bench_cli as JB
from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.models import llama as M
from tpu_llm_torch.quant.qtensor import QTensor
from tpu_llm_torch.runtime import bench_cli as TB
from tpu_llm_torch.runtime.engine import ModelAdapter

TINY = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
            seq_len=512)
TINY_7B = dict(dim=256, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
               vocab_size=96, seq_len=512)          # head_dim 128, Hkv = H

ROWS = {
    "formats": ["--configs", "bf16,q8_0,q4_0", "--steps", "3", "--ttft-samples", "2"],
    "kquants": ["--configs", "q2_k,q3_k,q4_k,q5_k,q6_k", "--skip-ttft", "--steps", "3"],
    "7b": ["--configs", "7b,7b_q4_0,7b_q8_0,7b_bf16,7b_foldnorm", "--steps", "3",
           "--max-seq", "256", "--skip-ttft"],
    "cache_f32": ["--configs", "q4_0", "--cache-dtype", "f32", "--steps", "3",
                  "--prompt-len", "64", "--max-seq", "256"],
    "cache_int8": ["--configs", "q4_0", "--cache-dtype", "int8", "--steps", "3",
                   "--skip-ttft"],
    "paged": ["--paged", "--batch", "3", "--steps", "3", "--block-size", "16"],
    "spec": ["--spec", "--steps", "6", "--max-seq", "256", "--spec-k", "3"],
    "families": ["--configs", "phi2,phi2_q4_0,phi2_q8_0,moe,moe_q4_0,moe_q8_0", "--steps",
                 "3", "--max-seq", "256", "--skip-ttft"],
}
# phi-2 and the synthetic MoE shrunk (dims of 64 / 128: q4_0 / q8_0 blocks)
TINY_PHI2 = dict(TINY, n_kv_heads=4, rope_variant="neox", rope_dims=8,
                 parallel_block=True, use_layernorm=True, use_bias=True, act="gelu",
                 gated_mlp=False)
TINY_MOE = dict(TINY, rope_variant="neox", n_experts=4, n_experts_used=2)


@pytest.fixture
def tiny(monkeypatch):
    from tpu_llm_torch import config as tconfig

    monkeypatch.setattr(TB, "tinyllama_1_1b", lambda: LlamaConfig(**TINY))
    monkeypatch.setattr(TB, "llama2_7b", lambda: LlamaConfig(**TINY_7B))
    monkeypatch.setattr(tconfig, "phi2_2_7b", lambda: LlamaConfig(**TINY_PHI2))
    monkeypatch.setattr(TB, "moe_config", lambda: LlamaConfig(**TINY_MOE))


def _jax_rows(argv, monkeypatch, capsys):
    """tpu_llm's llm-bench main with every builder, timer and engine
    stubbed: the rows its f-strings print for ``argv``."""
    import tpu_llm.runtime.batching as jbatching
    import tpu_llm.runtime.engine as jengine
    import tpu_llm.runtime.timing as jtiming

    class Engine:
        def __init__(self, params, adapter, batch, max_seq, speculative_k=0):
            self.spec_k = speculative_k
            self.stats = {"spec_forwards": 0, "spec_tokens": 0}
            self.reqs = []

        def submit(self, r):
            self.reqs.append(r)

        def run(self):
            for r in self.reqs:
                r.tokens = [5] * r.max_new
                if self.spec_k:
                    self.stats["spec_forwards"] += 1
                    self.stats["spec_tokens"] += r.max_new
            self.reqs = []

    monkeypatch.setenv("TPU_LLM_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(JB, "_build", lambda quant: {"layers": []})
    monkeypatch.setattr(JB, "synth_quant_llama", lambda cfg, kind: None)
    monkeypatch.setattr(JB, "_build_llama2_7b", lambda quant: (
        {"layers": [], "final_norm": None}, jconfig.llama2_7b()))
    monkeypatch.setattr(JB, "_build_phi2", lambda quant: ({}, jconfig.phi2_2_7b()))
    monkeypatch.setattr(JB, "_build_moe", lambda quant: ({}, jconfig.llama2_7b()))
    monkeypatch.setattr(JB, "_decode_tok_s", lambda *a, **k: 1.0)
    monkeypatch.setattr(JB, "_ttft_p50", lambda *a, **k: 0.001)
    monkeypatch.setattr(jtiming, "slope_time_s", lambda *a, **k: 1.0)
    monkeypatch.setattr(jbatching, "BatchEngine", Engine)
    monkeypatch.setattr(jengine, "ModelAdapter",
                        types.SimpleNamespace(llama=lambda *a, **k: None))
    capsys.readouterr()
    assert JB.main(argv) == 0
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("family", list(ROWS))
def test_rows_carry_the_jax_metric_names(family, tiny, monkeypatch, capsys):
    argv = ROWS[family]
    capsys.readouterr()
    assert TB.main(argv + ["--device", "cpu"]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    want = _jax_rows(argv, monkeypatch, capsys)
    assert [(r["metric"], r["unit"], sorted(r)) for r in got] == \
        [(r["metric"], r["unit"], sorted(r)) for r in want]
    for r in got:
        assert r["value"] > 0 and np.isfinite(r["value"])
        if r["vs_baseline"] is not None:
            # both rounded to 2 places from the unrounded tok/s, as in JAX
            assert abs(r["vs_baseline"] - r["value"] / TB.REFERENCE_TOK_S) <= \
                0.005 + 0.005 / TB.REFERENCE_TOK_S + 1e-9
    if family == "spec":
        assert all(("spec" in r["metric"]) == ("tokens_per_verify_forward" in r)
                   for r in got)


@pytest.mark.parametrize("argv", [["--configs", "mamba_bf16"], ["--configs", "q4_0,mamba"],
                                  ["--configs", "mamba"], ["--scaling"], ["--sharded"],
                                  ["--serve-tp", "2"]])
def test_later_rows_exit_2(argv, capsys):
    capsys.readouterr()
    assert TB.main(argv + ["--device", "cpu"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "ROADMAP.md queue 1, item" in cap.err


# -- weights -----------------------------------------------------------------

def _tree(p):
    """Structure, kinds, shapes and dtypes of a parameter tree (JAX or port)."""
    def dt(a):
        return str(a.dtype).replace("torch.", "")

    if isinstance(p, QTensor) or hasattr(p, "kind"):
        return ("qtensor", p.kind, tuple(p.q.shape), dt(p.q), tuple(p.scales.shape),
                dt(p.scales), None if p.mins is None else (tuple(p.mins.shape), dt(p.mins)))
    if isinstance(p, dict):
        return {k: _tree(v) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [_tree(v) for v in p]
    return None if p is None else (tuple(p.shape), dt(p))


SWITCHES = [None, "TPU_LLM_KQ_F32S", "TPU_LLM_Q23_INT8", "TPU_LLM_Q6K_PACK"]


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("kind", ["q4_0", "q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"])
def test_synth_quant_llama_matches_jax_tree(kind, switch, monkeypatch):
    if switch:
        monkeypatch.setenv(switch, "1")
    got = TB.synth_quant_llama(LlamaConfig(**TINY), kind, device="cpu")
    want = JB.synth_quant_llama(jconfig.LlamaConfig(**TINY), kind)
    assert _tree(got) == _tree(want)
    # values in the kind's range (before packing)
    w = TB._synth_qtensor(TB._generator(0, "cpu"), 64, 32, kind)
    lo, hi = {"q4_0": (0, 255), "q8_0": (-127, 127), "q4_k": (0, 255), "q5_k": (0, 31),
              "q6_k": (-32, 31)}.get(kind, (None, None))
    if lo is not None and w.kind not in ("q6_kp",):
        assert lo <= int(w.q.int().min()) and int(w.q.int().max()) <= hi
    s = w.scales.float()
    assert 0.001 <= float(s.min()) and float(s.max()) <= 0.0101


def test_random_and_7b_params_match_jax_tree(monkeypatch):
    from tpu_llm.models.llama import unstack_layers

    cfg = LlamaConfig(**TINY)
    got = TB.random_llama_params(cfg, device="cpu")
    want = unstack_layers(JB.random_llama_params(jconfig.LlamaConfig(**TINY)))
    assert _tree(got) == _tree(want)
    monkeypatch.setattr(TB, "llama2_7b", lambda: LlamaConfig(**TINY_7B))
    monkeypatch.setattr(jconfig, "llama2_7b", lambda: jconfig.LlamaConfig(**TINY_7B))
    for quant in ("q4_0", "bf16"):
        (got, gcfg), (want, wcfg) = TB._build_llama2_7b(quant, "cpu"), \
            JB._build_llama2_7b(quant)
        assert _tree(got) == _tree(want) and gcfg.head_dim == wcfg.head_dim == 128


@pytest.mark.parametrize("quant", ["bf16", "q4_0", "q8_0"])
def test_phi2_and_moe_trees_match_jax(quant, monkeypatch):
    """_build_phi2 / _build_moe give the JAX package's tree, kinds, shapes
    and dtypes at a shrunk config (their ``cfg`` parameter here,
    the JAX package's config factories patched there)."""
    import tpu_llm.models.llama  # noqa: F401  (imported before LlamaConfig is patched)
    from tpu_llm.models.llama import unstack_layers

    got, gcfg = TB._build_phi2(quant, "cpu", LlamaConfig(**TINY_PHI2))
    monkeypatch.setattr(jconfig, "phi2_2_7b", lambda: jconfig.LlamaConfig(**TINY_PHI2))
    want, wcfg = JB._build_phi2(quant)
    if quant == "bf16":
        want = want if isinstance(want["layers"], list) else unstack_layers(want)
    assert _tree(got) == _tree(want) and gcfg == LlamaConfig(**TINY_PHI2)
    if quant != "bf16":
        got, gcfg = TB._build_moe(quant, "cpu", LlamaConfig(**TINY_MOE))
        jmoe = jconfig.LlamaConfig(**TINY_MOE)
        monkeypatch.setattr(jconfig, "LlamaConfig", lambda **kw: jmoe)
        want, wcfg = JB._build_moe(quant)
        assert _tree(got) == _tree(want) and gcfg.n_experts == wcfg.n_experts == 4
        assert got["layers"][0]["w1e"].q.shape[0] == 4      # stacked expert planes
    moe = TB.moe_config()
    assert (moe.dim, moe.hidden_dim, moe.n_layers, moe.n_experts) == (1024, 2816, 8, 8)


# -- the timed programs ----------------------------------------------------------

@pytest.mark.parametrize("cfg,kind,cache", [(TINY, "q4_0", torch.bfloat16),
                                            (TINY, "q4_k", torch.float32),
                                            (TINY, "q8_0", "int8"),
                                            (TINY_7B, "q4_0", torch.bfloat16)],
                         ids=["q4_0_bf16", "q4_k_f32", "q8_0_int8", "7b_q4_0_bf16"])
def test_timed_program_emits_the_plain_loop_tokens(cfg, kind, cache):
    """The timed program, the Engine's graph loop (eager here, over the
    int4-plane weights), against decode_step over the loaded weights: the
    same tokens."""
    cfg = LlamaConfig(**cfg)
    params = TB.synth_quant_llama(cfg, kind, seed=3, device="cpu")
    B, prompt_len, n, max_seq = 2, 20, 12, 64
    run = TB._engine_program(params, ModelAdapter.llama(cfg, cache, device="cpu"), B,
                             max_seq, prompt_len, "cpu")
    with torch.inference_mode():
        got = run(n)
        again = run(n - 4)
        cache_t = M.init_cache(cfg, B, max_seq, cache, "cpu")
        tok, want = torch.ones(B, dtype=torch.long), []
        for pos in range(prompt_len, prompt_len + n):
            logits, cache_t = M.decode_step(params, cfg, tok, cache_t, pos)
            tok = torch.argmax(logits, dim=-1)
            want.append(tok.tolist())
    assert got == want and again == want[:n - 4]
    assert len({tuple(r) for r in want}) > 1


def test_paged_program_emits_the_dense_tokens():
    cfg = LlamaConfig(**TINY)
    params = TB.synth_quant_llama(cfg, "q4_0", seed=4, device="cpu")
    B, bs, prompt_len, n = 3, 16, 20, 12
    paged = TB._paged_program(params, cfg, B, bs, prompt_len, n, "cpu")
    S = -(-(prompt_len + n + 1) // bs) * bs            # the paged view's rows
    dense = TB._engine_program(params, ModelAdapter.llama(cfg, torch.bfloat16, device="cpu"),
                               B, S, prompt_len, "cpu")
    with torch.inference_mode():
        assert paged(n) == dense(n)


def test_ttft_counts_samples_after_the_first(monkeypatch):
    cfg = LlamaConfig(**TINY)
    params = TB.synth_quant_llama(cfg, "q4_0", device="cpu")
    calls = []
    forward = M.forward
    monkeypatch.setattr(M, "forward", lambda *a, **k: calls.append(1) or forward(*a, **k))
    t = TB._ttft_p50(params, cfg, 16, 64, 3, "cpu")
    assert len(calls) == 4 and t > 0
