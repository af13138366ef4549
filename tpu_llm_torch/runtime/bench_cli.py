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

--scaling, --sharded and --serve-tp need the parallelism the port does
not have yet: they exit 2 naming the ROADMAP.md item they wait for, and
print no row.

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

# the ROADMAP.md queue 1 item each refused row waits for
_LATER = {"--scaling": "item 9, parallelism", "--sharded": "item 9, parallelism",
          "--serve-tp": "item 9, parallelism"}


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
                    help="dp-scaling rows (refused: needs parallel/*)")
    ap.add_argument("--sharded", action="store_true",
                    help="TP decode rows (refused: needs parallel/*)")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV decode rows (block-table kernel vs dense cache at "
                         "the same batch)")
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--spec", action="store_true",
                    help="speculative-decoding rows (engine tok/s + "
                         "tokens-per-verify-forward vs the plain step)")
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--serve-tp", type=int, default=0, metavar="N",
                    help="mesh-sharded serving row (refused: needs parallel/*)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _refused(args) -> list:
    """The rows of this run that wait for a later slice, with the item."""
    return [(flag, _LATER[flag]) for flag, on in (
        ("--scaling", args.scaling), ("--sharded", args.sharded),
        ("--serve-tp", args.serve_tp)) if on]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    names = [n.strip() for n in args.configs.split(",")]
    refused = _refused(args)
    if refused:
        for what, item in refused:
            print(f"llm-bench: {what} is not in this slice of tpu_llm_torch "
                  f"(ROADMAP.md queue 1, {item})", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
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
