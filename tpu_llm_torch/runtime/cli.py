"""`llm` CLI of the port: ``python -m tpu_llm_torch.runtime.cli``.

The reference flags -m/--model, -p/--prompt, -s/--tokenizer,
-t/--temperature, -n/--num_tokens (total incl. prompt echo), -v/--verbose,
plus --dtype f32|bf16|native, --cache-dtype f32|bf16|int8, --seed,
--max-seq, --rope, --fold-norms, --scan (the CUDA-graph decode loop), --spec
K and --draft GGUF (speculative decoding), the sampling controls --top-k,
--top-p, --min-p, --repeat-penalty, --frequency-penalty and
--presence-penalty, --timings (the five-bucket report), --profile DIR (a
torch.profiler trace of the generation, as a Chrome trace in DIR) and
--device (cuda unless told otherwise). Any other flag of the JAX
package's CLI (--ak, --lora, --tp, --dp and the multi-host flags) is
refused by argparse. Output contract
(``tpu_llm/runtime/cli.py``): the streamed raw token bytes (with --scan,
the decoded text at the end instead), then a blank line, the inference
time, the decode tokens/second and the TTFT, then the timing report, the
line that names the trace, or a line that names --timings and --profile.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    # no prefix matching: a JAX-CLI flag outside this slice must not pass
    # as an abbreviation of one of these
    p = argparse.ArgumentParser(prog="llm", description=__doc__, allow_abbrev=False)
    p.add_argument("-m", "--model", default="stories15M.bin", help="GGUF model file")
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-s", "--tokenizer", default="",
                   help="external tokenizer.bin (overrides GGUF vocab)")
    p.add_argument("-t", "--temperature", type=float, default=0.0)
    p.add_argument("-n", "--num_tokens", type=int, default=256,
                   help="total tokens incl. prompt echo (reference -n)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16", "native"])
    p.add_argument("--cache-dtype", default="f32", choices=["f32", "bf16", "int8"],
                   help="KV cache storage; int8 = per-(token, head) scaled planes "
                        "(ops/kv_cache.py)")
    p.add_argument("--top-k", type=int, default=0,
                   help="top-k sampling filter (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling filter (1.0 = off)")
    p.add_argument("--min-p", type=float, default=0.0,
                   help="llama.cpp min_p filter (0 = off)")
    p.add_argument("--repeat-penalty", type=float, default=1.0,
                   help="HF/llama.cpp-style repetition penalty over the text so far "
                        "(1.0 = off)")
    p.add_argument("--frequency-penalty", type=float, default=0.0,
                   help="OpenAI frequency penalty (per-count logit subtraction; 0 = off)")
    p.add_argument("--presence-penalty", type=float, default=0.0,
                   help="OpenAI presence penalty (seen-token logit subtraction; 0 = off)")
    p.add_argument("--seed", type=int, default=None,
                   help="sampling seed (default: time-based)")
    p.add_argument("--fold-norms", action="store_true",
                   help="fold rmsnorm weights into the projections "
                        "(quantized weights REQUANTIZE: one extra rounding)")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--rope", default="interleaved",
                   choices=["interleaved", "neox", "llmf90"],
                   help="rope variant; 'llmf90' reproduces the Fortran bit-for-bit")
    p.add_argument("--scan", action="store_true",
                   help="decode loop as a captured CUDA graph (no streaming)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative decoding: verify K drafted tokens per forward "
                        "(greedy only; output is exactly the plain greedy stream). "
                        "Drafts come from prompt lookup, or from --draft when given")
    p.add_argument("--draft", default=None, metavar="GGUF",
                   help="small same-vocabulary draft model for two-model "
                        "speculation (needs --spec K)")
    p.add_argument("--timings", action="store_true",
                   help="after generation, measure and print the reference's five "
                        "per-token timing buckets (qkv/rope/attention/ffn/classifier), "
                        "each slope-timed at the run's decode shapes")
    p.add_argument("--profile", default="", metavar="DIR",
                   help="write a torch.profiler trace of the generation (Chrome "
                        "trace format, trace.json) into DIR")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models.llama import load_model
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    device = torch.device(args.device)

    t_load = time.perf_counter()
    gguf = GGUFFile(args.model)
    params, cfg = load_model(gguf, dtype_policy=args.dtype, device=device)
    if args.fold_norms:
        from tpu_llm_torch.quant.convert_params import fold_norms_requant

        params = fold_norms_requant(params, cfg)
    tokenizer = (BPETokenizer.from_gguf(gguf)
                 if "tokenizer.ggml.tokens" in gguf.metadata else None)
    if args.rope != "interleaved" and args.rope != cfg.rope_variant:
        cfg = dataclasses.replace(cfg, rope_variant=args.rope)
    if args.tokenizer:
        tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if tokenizer is None:
        print("no tokenizer available (use -s tokenizer.bin)", file=sys.stderr)
        return 1
    if args.verbose:
        print(f"config: {cfg}", file=sys.stderr)
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda"
                 else ""), file=sys.stderr)
        print(f"loaded weights in {time.perf_counter() - t_load:.2f}s", file=sys.stderr)

    max_seq = args.max_seq or min(cfg.seq_len, max(args.num_tokens + 8, 64))
    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    bos_id = tokenizer.bos_id if getattr(tokenizer, "add_bos", True) else -1
    adapter = ModelAdapter.llama(cfg, cache_dtype=cache_dtype, bos_id=bos_id,
                                 device=device)
    engine = Engine(params, adapter, max_seq=max_seq, device=device)
    draft_engine = None
    if args.draft:
        dparams, dcfg = load_model(GGUFFile(args.draft), dtype_policy=args.dtype,
                                   device=device)
        if args.rope != "interleaved" and args.rope != dcfg.rope_variant:
            dcfg = dataclasses.replace(dcfg, rope_variant=args.rope)
        draft_engine = Engine(dparams, ModelAdapter.llama(dcfg, cache_dtype=cache_dtype,
                                                          bos_id=bos_id, device=device),
                              max_seq=max_seq, device=device)

    prompt_ids = tokenizer.encode(args.prompt) if args.prompt else []
    n = args.num_tokens
    if n > cfg.seq_len:
        print(f" {n} greater than maximum sequence length", file=sys.stderr)
        print(f" set to {cfg.seq_len}", file=sys.stderr)
        n = cfg.seq_len

    out = sys.stdout.buffer

    def stream(tid: int):
        out.write(tokenizer.token_bytes(tid))
        out.flush()

    seed = args.seed if args.seed is not None else int(time.time_ns() % (2**31))
    profiler = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else []))
    with profiler:
        res = engine.generate(prompt_ids, n_total=n, temperature=args.temperature,
                              seed=seed, stream=None if args.scan else stream,
                              use_scan=args.scan, speculative_k=args.spec,
                              draft=draft_engine, top_k=args.top_k, top_p=args.top_p,
                              min_p=args.min_p, repetition_penalty=args.repeat_penalty,
                              frequency_penalty=args.frequency_penalty,
                              presence_penalty=args.presence_penalty)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    if args.scan:
        out.write(tokenizer.decode(res.tokens))
        out.flush()

    # reference output contract
    print()
    print(f" Inference time: {res.total_s:10.4f} seconds")
    print(f" {res.tokens_per_s:10.4f} tokens/second (decode)")
    print(f" TTFT: {res.ttft_s * 1000:10.2f} ms")
    if args.timings and (cfg.n_experts or cfg.parallel_block or cfg.q_dim != cfg.dim):
        # the buckets run the dense llama layer's pieces (as in the JAX
        # package, whose report stops on these layouts)
        print(" Timings: the per-bucket report covers dense llama-layout models "
              "(no MoE, no parallel block, q width == dim)")
    elif args.timings:
        from tpu_llm_torch.runtime.phase_timing import format_report, measure_phase_times

        res.phase_times = measure_phase_times(params, cfg, batch=1, pos=len(res.tokens),
                                              max_seq=max_seq)
        print(format_report(res.phase_times))
    if args.profile:
        print(f" Timings: torch.profiler trace written to {args.profile}")
    elif not args.timings:
        print(" Timings: pass --timings for the per-bucket report, or "
              "--profile DIR for a torch.profiler trace")
    return 0


if __name__ == "__main__":
    sys.exit(main())
