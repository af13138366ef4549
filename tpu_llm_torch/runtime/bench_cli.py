"""`llm-bench` of the port: ``python -m tpu_llm_torch.runtime.bench_cli``.

The perf harness (``tpu_llm/runtime/bench_cli.py``): one JSON line a
metric, ``{"metric", "value", "unit", "vs_baseline"}``, with the JAX
package's metric names. Rows:

- ``--configs`` (default bf16,q8_0,q4_0): greedy decode tokens/s at
  TinyLlama-1.1B shapes for each weight format, and the p50 time to the
  first token of a ``--prompt-len`` prompt (``--skip-ttft`` drops it);
  q2_k ... q6_k in the layouts the K-quant loader makes; 7b, 7b_q4_0,
  7b_q8_0, 7b_bf16 and 7b_foldnorm at Llama-2 7B shapes.
  ``--cache-dtype f32|bf16|int8`` sets the TinyLlama rows' KV cache.
- ``--paged``: decode through the block table (``--block-size``) beside
  the dense cache at the same ``--batch``.
- ``--spec``: the real ``BatchEngine`` host loop at batch 1 and 8 on a
  repetitive and a random 128-token prompt, plain and with prompt-lookup
  speculation (``--spec-k``): tokens/s and tokens per verify forward.

- ``phi2`` / ``phi2_q4_0`` / ``phi2_q8_0``: phi-2 2.7B shapes (parallel
  block, biases, GELU MLP, partial neox RoPE), dense bf16 or packed;
  ``moe`` / ``moe_q4_0`` / ``moe_q8_0``: the JAX package's synthetic
  Mixtral-style MoE (dim 1024, 8 experts, top-2, 8 layers), whose batch-1
  decode gathers the 2 selected experts a layer on the device.

- ``mamba`` / ``mamba_bf16``: Mamba-130M greedy decode tokens/s, f32 or
  with ``cast_weights`` (bf16 projections, embedding and classifier),
  ``vs_baseline`` over 6.237, the reference's Mamba-130M figure (one CPU
  core; ssm/README.md).

- ``--scaling``: data-parallel weak scaling, decode tokens/s at dp = 1,
  2, 4, ... ranks with ``--batch`` rows a rank, and the efficiency against
  dp = 1 as ``vs_baseline``; ``--sharded``: the explicit TP decode step
  (``parallel/tp_decode.py``) at tp = 1, 2, ... up to min(devices, kv
  heads); ``--serve-tp N``: BatchEngine tokens/s with the engine on a
  tp-rank mesh (``shard_engine``), N clamped to the devices and the kv
  heads with the JAX package's ``{"note": "serve-tp clamped ..."}`` line.
  The devices are the GPUs (the one CPU under ``--device cpu``, where the
  rows take the JAX package's small stand-in config and the
  ``_cpuvirtual`` names); ``llm-bench`` spawns one rank a device and rank
  0 prints. Their steps run eagerly (a gloo group cannot be captured in a
  CUDA graph); a gloo group on one card is a correctness path, not a
  speed figure.

Weights are random, drawn on the device from a seeded ``torch.Generator``
(throughput does not depend on their values), packed in the layouts the
port's loader produces; the 7B weights never pass through the host.
Decode is timed as ``slope_time_s`` over runs of N and 5N steps of the
Engine's own graph loop (``llm --scan``: one decode step captured in a
CUDA graph, the token and the position on the device, greedy feedback on
the device), the run synced by fetching its tokens to the host. The q4
kinds are converted to int4 planes (``unpack_params_int4``) before the
timed window, as that loop does. ``vs_baseline`` is tokens/s
over 7.3, the reference's best published single-stream figure (one CPU
core; its README). Entry points run on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpu_llm_torch.config import llama2_7b, mamba_130m, tinyllama_1_1b

REFERENCE_TOK_S = 7.3
REFERENCE_MAMBA_TOK_S = 6.237      # the reference's Mamba-130M, ssm/README.md

def _row(metric: str, value: float, unit: str, vs_baseline, **extra):
    print(json.dumps({"metric": metric, "value": round(value, 2), "unit": unit,
                      "vs_baseline": vs_baseline, **extra}), flush=True)


# -- weights -----------------------------------------------------------------

def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def random_llama_params(cfg, seed: int = 0, device="cuda"):
    """Random dense bf16 llama weights at ``cfg`` shapes (std 0.02; norms
    of ones), per-layer and unfused, drawn on ``device``."""
    g = _generator(seed, device)
    E, F, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim

    def w(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.02).bfloat16()

    ones = lambda: torch.ones(E, device=device)  # noqa: E731
    layers = [{"attn_norm": ones(), "ffn_norm": ones(), "wq": w(E, E), "wk": w(E, KV),
               "wv": w(E, KV), "wo": w(E, E), "w1": w(E, F), "w3": w(E, F), "w2": w(F, E)}
              for _ in range(cfg.n_layers)]
    return {"tok_emb": w(V, E), "final_norm": ones(), "wcls": w(E, V), "layers": layers}


def _synth_qtensor(g: torch.Generator, K: int, N: int, kind: str):
    """A random packed (K, N) QTensor drawn on the generator's device: the
    JAX package's planes (values uniform over the kind's range, scales in
    [0.001, 0.01]) in the layouts the port's loader produces. The K-quants
    load folded: q4_k as q4_1 and q5_k as q5_1 (per-32 affine), q2/q3/q6_k
    as per-16 int8 kinds, q2/q3 nibble-packed (q2_kp / q3_kp) unless
    TPU_LLM_Q23_INT8, q6_k as q6_kp under TPU_LLM_Q6K_PACK; their planes
    are bf16 unless TPU_LLM_KQ_F32S."""
    from tpu_llm_torch.quant.qtensor import QTensor, pack_q2_k, pack_q3_k, pack_q6_k

    dev = g.device

    def ints(lo, hi, shape, dtype):       # uniform over [lo, hi)
        return torch.randint(lo, hi, shape, generator=g, device=dev).to(dtype)

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    if kind in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
        kq_dt = torch.float32 if os.environ.get("TPU_LLM_KQ_F32S") else torch.bfloat16
        if kind in ("q4_k", "q5_k"):
            packed = kind == "q4_k"
            q = (ints(0, 256, (K // 2, N), torch.uint8) if packed
                 else ints(0, 32, (K, N), torch.int8))
            s = uniform((K // 32, N), 0.001, 0.01)
            mins = -(8.0 if packed else 16.0) * s + 0.001 * uniform((K // 32, N))
            return QTensor(q, s.to(kq_dt), "q4_1" if packed else "q5_1", mins.to(kq_dt))
        if kind in ("q2_k", "q3_k"):
            lo, hi = (0, 4) if kind == "q2_k" else (-4, 4)
            q = ints(lo, hi, (K, N), torch.int8)
            s = uniform((K // 16, N), 0.001, 0.01)
            mins = (-2.0 * s).to(kq_dt) if kind == "q2_k" else None
            qt = QTensor(q, s.to(kq_dt), kind, mins)
            if os.environ.get("TPU_LLM_Q23_INT8"):
                return qt
            return pack_q2_k(qt) if kind == "q2_k" else pack_q3_k(qt)
        q = ints(-32, 32, (K, N), torch.int8)
        qt = QTensor(q, uniform((K // 16, N), 0.001, 0.01).to(kq_dt), "q6_k")
        return pack_q6_k(qt) if os.environ.get("TPU_LLM_Q6K_PACK") else qt
    if kind == "q4_0":
        q = ints(0, 256, (K // 2, N), torch.uint8)
    elif kind == "q8_0":
        q = ints(-127, 128, (K, N), torch.int8)
    else:
        raise ValueError(f"no synthetic weights of kind {kind!r}")
    return QTensor(q, uniform((K // 32, N), 0.001, 0.01), kind)


def synth_quant_llama(cfg, kind: str = "q4_0", seed: int = 0, device="cuda"):
    """Random PACKED llama weights drawn on ``device`` (no host copy, no
    quantize pass): fused wqkv / w13, per-layer list, a bf16 embedding."""
    g = _generator(seed, device)
    E, F, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    emb = (torch.randn((V, E), generator=g, device=device) * 0.02).bfloat16()
    ones = lambda: torch.ones(E, device=device)  # noqa: E731
    layers = [{"attn_norm": ones(), "ffn_norm": ones(),
               "wqkv": _synth_qtensor(g, E, E + 2 * KV, kind),
               "wo": _synth_qtensor(g, E, E, kind),
               "w13": _synth_qtensor(g, E, 2 * F, kind),
               "w2": _synth_qtensor(g, F, E, kind)} for _ in range(cfg.n_layers)]
    return {"tok_emb": emb, "final_norm": ones(), "wcls": _synth_qtensor(g, E, V, kind),
            "layers": layers}


def _build(quant: str, device="cuda"):
    """TinyLlama-1.1B-shaped weights: packed q4_0 / q8_0 drawn on the
    device (the layout ``quantize_llama_params(fuse=True)`` gives), or
    dense bf16 with fused projections."""
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    cfg = tinyllama_1_1b()
    if quant != "bf16":
        return synth_quant_llama(cfg, quant, device=device)
    params = random_llama_params(cfg, device=device)
    return dict(params, layers=fuse_llama_layers(params["layers"]))


def _build_llama2_7b(quant: str = "q4_0", device="cuda"):
    """Random Llama-2 7B-shaped weights: q4_0 / q8_0 packed on the device,
    anything else dense bf16 (13.5 GB), fused."""
    from tpu_llm_torch.quant.convert_params import fuse_llama_layers

    cfg = llama2_7b()
    if quant in ("q4_0", "q8_0"):
        return synth_quant_llama(cfg, quant, device=device), cfg
    params = random_llama_params(cfg, device=device)
    return dict(params, layers=fuse_llama_layers(params["layers"])), cfg


def _build_phi2(quant: str = "bf16", device="cuda", cfg=None):
    """Random phi-2 2.7B-shaped weights (``cfg``: phi2_2_7b unless given),
    the JAX package's tree: per-layer, unfused wq / wk / wv, zero biases,
    LayerNorm weights of ones and biases of zeros; projections and the
    classifier dense bf16, or packed q4_0 / q8_0 drawn on the device."""
    from tpu_llm_torch.config import phi2_2_7b

    cfg = cfg or phi2_2_7b()
    g = _generator(0, device)
    E, F, V = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    packed = quant in ("q4_0", "q8_0")

    def w(K, N):
        if packed:
            return _synth_qtensor(g, K, N, quant)
        return (torch.randn((K, N), generator=g, device=device) * 0.02).bfloat16()

    zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
    ones = lambda n: torch.ones(n, device=device)  # noqa: E731
    emb = (torch.randn((V, E), generator=g, device=device) * 0.02).bfloat16()
    layers = [{"attn_norm": ones(E), "attn_norm_b": zeros(E),
               "wq": w(E, E), "wk": w(E, E), "wv": w(E, E), "wo": w(E, E),
               "bq": zeros(E), "bk": zeros(E), "bv": zeros(E), "bo": zeros(E),
               "w3": w(E, F), "b3": zeros(F), "w2": w(F, E), "b2": zeros(E)}
              for _ in range(cfg.n_layers)]
    return {"tok_emb": emb, "final_norm": ones(E), "final_norm_b": zeros(E),
            "wcls": w(E, V), "bcls": zeros(V), "layers": layers}, cfg


def moe_config():
    """The JAX package's synthetic Mixtral-style MoE: dim 1024, ffn 2816,
    8 layers, 16/8 heads, 8 experts, top-2, vocab 32000, neox RoPE."""
    from tpu_llm_torch.config import LlamaConfig

    return LlamaConfig(dim=1024, hidden_dim=2816, n_layers=8, n_heads=16, n_kv_heads=8,
                       vocab_size=32000, seq_len=2048, rope_variant="neox",
                       n_experts=8, n_experts_used=2)


def _build_moe(quant: str = "q4_0", device="cuda", cfg=None):
    """Random MoE weights (``cfg``: moe_config unless given) drawn on the
    device: fused wqkv, wo and the classifier packed, an f32 router (std
    0.05), the experts' w1e / w3e (Ex, E, F) and w2e (Ex, F, E) as stacked
    packed planes."""
    from tpu_llm_torch.quant.qtensor import qmap

    cfg = cfg or moe_config()
    g = _generator(0, device)
    E, F, V, KV, EX = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim, cfg.n_experts

    def qt(K, N):
        return _synth_qtensor(g, K, N, quant)

    def qte(K, N):
        return qmap(lambda *ps: torch.stack(ps), *[qt(K, N) for _ in range(EX)])

    ones = lambda: torch.ones(E, device=device)  # noqa: E731
    layers = [{"attn_norm": ones(), "ffn_norm": ones(), "wqkv": qt(E, E + 2 * KV),
               "wo": qt(E, E),
               "router": torch.randn((E, EX), generator=g, device=device) * 0.05,
               "w1e": qte(E, F), "w3e": qte(E, F), "w2e": qte(F, E)}
              for _ in range(cfg.n_layers)]
    emb = (torch.randn((V, E), generator=g, device=device) * 0.02).bfloat16()
    return {"tok_emb": emb, "final_norm": ones(), "wcls": qt(E, V),
            "layers": layers}, cfg


def _build_mamba(device="cuda"):
    """Random Mamba-130M weights (the JAX package's ``_build_mamba`` tree:
    N(0, 0.02) everywhere, norms around 1, A_log = |.| + 0.1) drawn on the
    device, in the port's per-layer layout."""
    cfg = mamba_130m()
    g = _generator(0, device)
    s = lambda *sh: torch.randn(sh, generator=g, device=device) * 0.02  # noqa: E731
    E, di, ds, dr, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.dt_rank_, cfg.d_conv
    layers = [{"norm": s(E) + 1.0, "in_proj": s(E, 2 * di), "conv_w": s(dc, di),
               "conv_b": s(di), "x_proj": s(di, dr + 2 * ds), "dt_proj": s(dr, di),
               "dt_bias": s(di), "A_log": s(ds, di).abs() + 0.1, "d": s(di),
               "out_proj": s(di, E)} for _ in range(cfg.n_layers)]
    return {"tok_emb": s(cfg.vocab_size, E), "norm_f": s(E) + 1.0,
            "wcls": s(E, cfg.vocab_size), "layers": layers}, cfg


# -- the timed programs ----------------------------------------------------------

def _engine_program(params, adapter, batch: int, max_seq: int, prompt_len: int, device):
    """``run(n)``: n greedy decode steps from token 1 at ``prompt_len``
    through the Engine's graph loop (``llm --scan``: one step captured in a
    CUDA graph, eager on the CPU, the argmax fed back on the device),
    synced by fetching the (n, B) tokens to the host. The int4-plane
    weights and the state are made here, before any timed run; the graph
    is captured at the first run, whose warm-up is its first step."""
    from tpu_llm_torch.runtime.engine import Engine

    eng = Engine(params, adapter, batch, max_seq, device)
    eng._graph_params()
    eng._static_state()
    return lambda n: eng._run_decode_graph(1, prompt_len, n, 0.0, 0)


def _slope_tok_s(run, steps: int, batch: int) -> float:
    from tpu_llm_torch.runtime.timing import slope_time_s

    return batch / slope_time_s(lambda n: lambda: run(n), steps, steps * 5)


@torch.inference_mode()
def _decode_tok_s(params, cfg, steps, batch, max_seq, prompt_len, cache_dtype=None,
                  device="cuda"):
    """Greedy decode tokens/s: the captured step over a (batch, max_seq)
    cache (bf16 unless ``cache_dtype``) from ``prompt_len``, slope-timed
    at ``steps`` and 5 * ``steps``."""
    from tpu_llm_torch.runtime.engine import ModelAdapter

    # keep the 5x run inside the cache (writes past max_seq would clamp)
    steps = min(steps, max(1, (max_seq - prompt_len - 1) // 5))
    adapter = ModelAdapter.llama(cfg, cache_dtype or torch.bfloat16, device=device)
    run = _engine_program(params, adapter, batch, max_seq, prompt_len, device)
    return _slope_tok_s(run, steps, batch)


@torch.inference_mode()
def _decode_tok_s_mamba(params, cfg, steps, batch, device="cuda"):
    """Greedy Mamba decode tokens/s: the Engine's captured step over the
    static (batch) state, slope-timed at ``steps`` and 5 * ``steps``."""
    from tpu_llm_torch.runtime.engine import ModelAdapter

    run = _engine_program(params, ModelAdapter.mamba(cfg, device), batch, 5 * steps + 8, 0,
                          device)
    return _slope_tok_s(run, steps, batch)


@torch.inference_mode()
def _ttft_p50(params, cfg, prompt_len, max_seq, samples, device="cuda"):
    """p50 seconds from a random prompt to its first greedy token on the
    host; the bf16 cache is allocated inside the timed call; sample 0 (the
    first build and warm-up) is not counted."""
    from tpu_llm_torch.models import llama as M

    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prompt_len))).to(device)
    times = []
    for i in range(samples + 1):
        t0 = time.perf_counter()
        cache = M.init_cache(cfg, 1, max_seq, torch.bfloat16, device)
        hidden, _ = M.forward(params, cfg, tokens, cache, 0)
        int(torch.argmax(M.lm_head(params, cfg, hidden[:, -1:])[0, 0]))
        if i > 0:
            times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50))


def _paged_program(params, cfg, batch, block_size, prompt_len, n_max, device):
    """``_engine_program`` over the PagedEngine's forward (the block-table
    update and attention, bf16 pools), each row's table mapped for
    prompt_len + n_max + 1 rows; the engine's ``max_seq`` is that span
    rounded up to whole blocks."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.ops.paged_kv import PagedKV
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.paged_engine import _paged_attn_fn, _paged_update_fn

    per_row = -(-(prompt_len + n_max + 1) // block_size)

    def init_state(batch, max_seq):
        table = (1 + torch.arange(batch * per_row, dtype=torch.int32,
                                  device=device)).reshape(batch, per_row)
        lengths = torch.full((batch,), prompt_len, dtype=torch.int32, device=device)

        def pool():
            return torch.zeros((1 + batch * per_row, block_size, cfg.kv_dim),
                               dtype=torch.bfloat16, device=device)

        return {"k": [PagedKV(pool(), pool(), table, lengths) for _ in range(cfg.n_layers)],
                "v": [None] * cfg.n_layers}

    adapter = ModelAdapter(
        apply=lambda p, tokens, state, offset: M.forward(
            p, cfg, tokens, state, offset, update_fn=_paged_update_fn,
            attn_fn=_paged_attn_fn),
        lm_head=lambda p, hidden: M.lm_head(p, cfg, hidden),
        init_state=init_state, vocab_size=cfg.vocab_size)
    return _engine_program(params, adapter, batch, per_row * block_size, prompt_len, device)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@torch.inference_mode()
def _paged_rows(args, device) -> int:
    """Paged decode tokens/s (one captured paged step, tables mapped for
    the measured window) beside the dense cache at the same batch: the
    cost of the block-table indirection itself."""
    cfg = tinyllama_1_1b()
    params = _build("q4_0", device)
    B, bs, steps = args.batch, args.block_size, args.steps
    span = args.prompt_len + 5 * steps + 1
    run = _paged_program(params, cfg, B, bs, args.prompt_len, steps * 5, device)
    tok_s = _slope_tok_s(run, steps, B)
    _row(f"tinyllama_1.1b_q4_0_PAGED_decode_tokens_per_s_b{B}_bs{bs}", tok_s, "tok/s",
         round(tok_s / REFERENCE_TOK_S, 2))
    dense = _decode_tok_s(params, cfg, steps, B, max(_round_up(span, 128), 256),
                          args.prompt_len, torch.bfloat16, device)
    _row(f"tinyllama_1.1b_q4_0_dense_decode_tokens_per_s_b{B}", dense, "tok/s",
         round(dense / REFERENCE_TOK_S, 2))
    return 0


@torch.inference_mode()
def _spec_rows(args, device) -> int:
    """BatchEngine tokens/s, plain and with prompt-lookup speculation, at
    batch 1 and 8 on a repetitive and a random 128-token prompt, through
    the real host loop; with tokens per verify forward (accepted drafts +
    1). Each engine is warmed by a full run first."""
    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import ModelAdapter

    cfg = tinyllama_1_1b()
    params = _build("q4_0", device)
    rng = np.random.default_rng(0)
    pat = rng.integers(5, cfg.vocab_size - 1, 8).tolist()
    prompts = {"repetitive": (pat * 16)[:128],
               "random": rng.integers(5, cfg.vocab_size - 1, 128).tolist()}
    for B in (1, 8):
        for pname, prompt in prompts.items():
            for spec in (0, args.spec_k):
                adapter = ModelAdapter.llama(cfg, cache_dtype=torch.bfloat16, device=device)
                eng = BatchEngine(params, adapter, batch=B, max_seq=args.max_seq,
                                  speculative_k=spec)
                for _ in range(B):
                    eng.submit(Request(prompt=list(prompt), max_new=8))
                eng.run()
                eng.stats["spec_forwards"] = eng.stats["spec_tokens"] = 0
                reqs = [Request(prompt=list(prompt), max_new=args.steps) for _ in range(B)]
                t0 = time.perf_counter()
                for r in reqs:
                    eng.submit(r)
                eng.run()
                dt = time.perf_counter() - t0
                total = sum(len(r.tokens) for r in reqs)
                fwd = eng.stats["spec_forwards"]
                label = f"spec{spec}" if spec else "plain"
                extra = ({"tokens_per_verify_forward": round(eng.stats["spec_tokens"] / fwd, 3)}
                         if fwd else {})
                _row(f"tinyllama_1.1b_q4_0_engine_{label}_{pname}_tokens_per_s_b{B}",
                     total / dt, "tok/s", round(total / dt / REFERENCE_TOK_S, 2), **extra)
    return 0


# -- the parallel rows ---------------------------------------------------------------

def _small_cfg():
    """The JAX package's stand-in for TinyLlama in its CPU parallel rows."""
    from tpu_llm_torch.config import LlamaConfig

    return LlamaConfig(dim=256, hidden_dim=512, n_layers=4, n_heads=8, n_kv_heads=4,
                       vocab_size=2048, seq_len=256)


def _small_params(cfg, device):
    """Its weights: N(0, 0.02) f32 from numpy's seed 0, norms around 1."""
    rng = np.random.default_rng(0)
    s = lambda *sh: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(sh) * 0.02).astype(np.float32)).to(device)
    E, F, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    layers = [{"attn_norm": s(E) + 1.0, "ffn_norm": s(E) + 1.0, "wq": s(E, E), "wk": s(E, KV),
               "wv": s(E, KV), "wo": s(E, E), "w1": s(E, F), "w3": s(E, F), "w2": s(F, E)}
              for _ in range(cfg.n_layers)]
    return {"tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V), "layers": layers}


def _step_loop_tok_s(step, params, cache, batch: int, rows: int, steps: int, mesh) -> float:
    """Tokens/s of ``rows`` total rows (``batch`` on this rank) through an
    eager greedy step loop from position 1, slope-timed; each run ends on
    a host fetch and a barrier of the mesh, so its ranks time alike."""
    dev = mesh.device

    def make_run(n):
        def run():
            tok = torch.zeros((batch,), dtype=torch.int32, device=dev)
            for pos in range(1, n + 1):
                logits, _ = step(params, tok, cache, pos)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            tok.tolist()
            mesh.barrier()
        return run

    from tpu_llm_torch.runtime.timing import slope_time_s

    return rows / slope_time_s(make_run, steps, steps * 5)


@torch.inference_mode()
def _scaling_rows(args, device, ndev: int, tl_cfg):
    """Weak scaling: at dp = 1, 2, 4, ... <= ndev, each of the first dp
    ranks decodes ``--batch`` rows with the whole model; tokens/s of all
    dp * batch rows, and the efficiency against dp = 1."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.mesh import make_mesh

    on_card = device.type == "cuda"
    cfg = tl_cfg if on_card else _small_cfg()
    max_seq = min(cfg.seq_len, args.max_seq)
    steps = min(args.steps, max(1, (max_seq - 2) // 5))
    params = None
    base, dp = None, 1
    while dp <= ndev:
        mesh = make_mesh(dp, 1, device=device.type, ranks=list(range(dp)))
        if mesh.member:
            if params is None:
                params = (random_llama_params(cfg, device=mesh.device) if on_card
                          else _small_params(cfg, mesh.device))
            cache = M.init_cache(cfg, args.batch, max_seq, torch.bfloat16, mesh.device)
            tok_s = _step_loop_tok_s(lambda p, t, c, pos: M.decode_step(p, cfg, t, c, pos),
                                     params, cache, args.batch, args.batch * dp, steps, mesh)
            base = base or tok_s
            if mesh.index == 0:
                _row(f"scaling_dp{dp}_decode_tokens_per_s" + ("" if on_card else "_cpuvirtual"),
                     tok_s, "tok/s", round(tok_s / (dp * base), 3))
        dp *= 2
    return 0


@torch.inference_mode()
def _tp_rows(args, device, ndev: int, tl_cfg):
    """The explicit TP decode step at tp = 1, 2, ... <= min(ndev, kv heads):
    TinyLlama q4_0 (fused, repacked for tp) on the card, the small f32
    stand-in on the CPU."""
    from tpu_llm_torch.parallel.mesh import make_mesh
    from tpu_llm_torch.parallel.tp_decode import (init_tp_cache, make_tp_decode_step,
                                                  repack_fused_for_tp, shard_tp_params)

    on_card = device.type == "cuda"
    cfg = tl_cfg if on_card else _small_cfg()
    name = "q4_0" if on_card else "bf16"
    max_seq = min(cfg.seq_len, args.max_seq)
    steps = min(args.steps, max(1, (max_seq - 2) // 5))
    tp = 1
    while tp <= min(ndev, cfg.n_kv_heads):
        mesh = make_mesh(1, tp, device=device.type, ranks=list(range(tp)))
        if mesh.member:
            params = (synth_quant_llama(cfg, "q4_0", device=mesh.device) if on_card
                      else _small_params(cfg, mesh.device))
            fused = "wqkv" in params["layers"][0]
            if fused and tp > 1:
                params = dict(params, layers=repack_fused_for_tp(params["layers"], cfg, tp))
            p_sh = shard_tp_params(params, cfg, mesh, fused=fused)
            del params
            cache = init_tp_cache(cfg, mesh, args.batch, max_seq)
            step = make_tp_decode_step(cfg, mesh)
            tok_s = _step_loop_tok_s(step, p_sh, cache, args.batch, args.batch, steps, mesh)
            if mesh.index == 0:
                _row(f"tp{tp}_shardmap_{name}_decode_tokens_per_s"
                     + ("" if on_card else "_cpuvirtual"), tok_s, "tok/s",
                     round(tok_s / REFERENCE_TOK_S, 2) if on_card else None)
            del p_sh, cache
        tp *= 2
    return 0


@torch.inference_mode()
def _serve_tp_rows(args, device, ndev: int, tl_cfg):
    """BatchEngine tokens/s with the engine on a tp-rank mesh (bf16
    weights, a bf16 cache), ``--batch`` requests of a 64-token prompt,
    after a warm-up run."""
    from tpu_llm_torch.parallel.mesh import make_mesh
    from tpu_llm_torch.parallel.serving import shard_engine
    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import ModelAdapter

    cfg = tl_cfg
    tp = max(1, min(args.serve_tp, ndev, cfg.n_kv_heads))
    mesh = make_mesh(1, tp, device=device.type, ranks=list(range(tp)))
    if not mesh.member:
        return 0
    lead = mesh.index == 0
    if tp < args.serve_tp and lead:
        print(json.dumps({"note": f"serve-tp clamped {args.serve_tp}->{tp} "
                                  f"({ndev} devices, {cfg.n_kv_heads} kv heads)"}), flush=True)
    params = random_llama_params(cfg, device=mesh.device)
    # built on the host, then placed: shard_engine moves the state and the shards
    eng = BatchEngine(params, ModelAdapter.llama(cfg, torch.bfloat16, device="cpu"),
                      batch=args.batch, max_seq=args.max_seq)
    eng = shard_engine(eng, cfg, mesh)
    del params
    rng = np.random.default_rng(0)
    prompt = rng.integers(5, cfg.vocab_size - 1, 64).tolist()
    for _ in range(args.batch):
        eng.submit(Request(prompt=list(prompt), max_new=8))
    eng.run()
    reqs = [Request(prompt=list(prompt), max_new=args.steps) for _ in range(args.batch)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    mesh.barrier()
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in reqs)
    if lead:
        _row(f"tinyllama_1.1b_bf16_engine_serving_tp{tp}_tokens_per_s_b{args.batch}",
             total / dt, "tok/s", round(total / dt / REFERENCE_TOK_S, 2))
    return 0


def _parallel_rank(rank: int, argv, tl_cfg) -> int:
    """One rank of the parallel rows (every rank of the world runs it; the
    first prints)."""
    from tpu_llm_torch.parallel.mesh import rank_device

    args = build_parser().parse_args(argv)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    device = rank_device(args.device, rank)
    rows = (_scaling_rows if args.scaling else _tp_rows if args.sharded else _serve_tp_rows)
    return rows(args, device, world, tl_cfg)


# -- main --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    # no prefix matching: a flag must be named in full
    ap = argparse.ArgumentParser(prog="llm-bench", description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", default="bf16,q8_0,q4_0")
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--max-seq", type=int, default=1024)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--ttft-samples", type=int, default=5)
    ap.add_argument("--skip-ttft", action="store_true")
    ap.add_argument("--cache-dtype", default="bf16", choices=["f32", "bf16", "int8"])
    ap.add_argument("--scaling", action="store_true",
                    help="dp-scaling rows (tok/s + efficiency at dp=1,2,4,... over the "
                         "available devices)")
    ap.add_argument("--sharded", action="store_true",
                    help="explicit TP decode rows (tp=1,2,... up to min(devices, kv heads))")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV decode rows (block-table kernel vs dense cache at "
                         "the same batch)")
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--spec", action="store_true",
                    help="speculative-decoding rows (engine tok/s + "
                         "tokens-per-verify-forward vs the plain step)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--serve-tp", type=int, default=0, metavar="N",
                    help="mesh-sharded serving row (BatchEngine on a tp-rank mesh; clamps "
                         "to the available devices)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    names = [n.strip() for n in args.configs.split(",")]
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    if args.scaling or args.sharded or args.serve_tp:
        from tpu_llm_torch.parallel.distributed import configured_world, launch
        from tpu_llm_torch.parallel.mesh import device_count

        ndev = device_count(args.device)
        if ndev == 1 or configured_world() > 1:
            from tpu_llm_torch.parallel.distributed import init_distributed

            rank, _ = init_distributed(device=args.device)
            return _parallel_rank(rank, argv, tinyllama_1_1b())
        try:
            rcs = launch(_parallel_rank, ndev, argv, tinyllama_1_1b(), device=args.device,
                         quiet=True)
        except RuntimeError as e:
            print(f"llm-bench: {e}", file=sys.stderr)
            return 1
        return max(rcs)
    device = torch.device(args.device)
    if args.paged:
        return _paged_rows(args, device)
    if args.spec:
        return _spec_rows(args, device)

    cfg = tinyllama_1_1b()
    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    for name in names:
        if name in ("mamba", "mamba_bf16"):
            from tpu_llm_torch.models.mamba import cast_weights

            mparams, mcfg = _build_mamba(device)
            if name == "mamba_bf16":
                mparams = cast_weights(mparams)
            tok_s = _decode_tok_s_mamba(mparams, mcfg, args.steps, args.batch, device)
            del mparams
            dt = "f32" if name == "mamba" else "bf16"
            _row(f"mamba_130m_{dt}_decode_tokens_per_s_per_chip", tok_s, "tok/s",
                 round(tok_s / REFERENCE_MAMBA_TOK_S, 2))
            continue
        if name.startswith("7b"):
            # 7b | 7b_q4_0 | 7b_q8_0 | 7b_bf16 | 7b_foldnorm (q4_0 without
            # the norm weights: what fold_norms_requant leaves to read)
            quant = name[3:] or "q4_0"
            foldnorm = quant == "foldnorm"
            if foldnorm:
                quant = "q4_0"
            lparams, lcfg = _build_llama2_7b(quant, device)
            if foldnorm:
                lparams = dict(lparams, final_norm=None, layers=[
                    dict(lp, attn_norm=None, ffn_norm=None) for lp in lparams["layers"]])
            tok_s = _decode_tok_s(lparams, lcfg, args.steps, args.batch,
                                  min(args.max_seq, lcfg.seq_len), args.prompt_len,
                                  device=device)
            del lparams
            _row(f"llama2_7b_{quant}{'_foldnorm' if foldnorm else ''}"
                 f"_decode_tokens_per_s_per_chip", tok_s, "tok/s", None)
            continue
        if name.startswith(("phi2", "moe")):
            # phi2 | phi2_q4_0 | phi2_q8_0 ; moe | moe_q4_0 | moe_q8_0
            phi2 = name.startswith("phi2")
            quant = (name[5:] or "bf16") if phi2 else (name[4:] or "q4_0")
            fparams, fcfg = (_build_phi2 if phi2 else _build_moe)(quant, device)
            tok_s = _decode_tok_s(fparams, fcfg, args.steps, args.batch,
                                  min(args.max_seq, fcfg.seq_len), args.prompt_len,
                                  device=device)
            del fparams
            _row(f"phi2_2.7b_{quant}_decode_tokens_per_s_per_chip" if phi2 else
                 f"synthetic_moe_8e_top2_{quant}_decode_tokens_per_s_per_chip",
                 tok_s, "tok/s", None)
            continue
        if name in ("q2_k", "q3_k", "q4_k", "q5_k", "q6_k"):
            params = synth_quant_llama(cfg, kind=name, device=device)
        else:
            params = _build(name, device)
        tok_s = _decode_tok_s(params, cfg, args.steps, args.batch, args.max_seq,
                              args.prompt_len, cache_dtype, device)
        _row(f"tinyllama_1.1b_{name}_decode_tokens_per_s_per_chip", tok_s, "tok/s",
             round(tok_s / REFERENCE_TOK_S, 2))
        if not args.skip_ttft:
            ttft = _ttft_p50(params, cfg, args.prompt_len, args.max_seq,
                             args.ttft_samples, device)
            _row(f"tinyllama_1.1b_{name}_ttft_p50_prompt{args.prompt_len}", ttft * 1000,
                 "ms", None)
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
