"""`llm-serve` of the port: ``python -m tpu_llm_torch.runtime.serve_cli``.

Offline batched serving (``tpu_llm/runtime/serve_cli.py``): many prompts
(repeated -p, or -f with one a line) through the continuous-batching
engines; requests are admitted into slots as others finish, each prompt
prefills in one forward, and decode runs one batched step for every live
slot. ``--paged`` takes the paged KV pool with automatic prefix caching;
``--cache-dtype int8`` (with ``--paged``) stores the pools in int8.

Flags: -m -p -f -n -t -s, --dtype f32|bf16|native, --cache-dtype
f32|bf16|int8, --batch, --max-seq, --paged, --block-size, --n-blocks,
--stop-at-eos, --seed, -v and --device (cuda unless told otherwise). Any
other flag of the JAX package's front end (--spec, --draft, --lora, --tp,
--dp, --top-k, --top-p, --min-p) is refused by argparse.

Output contract: one JSON object a request on stdout (prompt,
completion, n_tokens, ttft_s), then the summary object on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    # no prefix matching: a flag outside this slice must not pass as an
    # abbreviation of one of these
    p = argparse.ArgumentParser(prog="llm-serve", description=__doc__,
                                allow_abbrev=False)
    p.add_argument("-m", "--model", required=True, help="GGUF model file")
    p.add_argument("-p", "--prompt", action="append", default=[],
                   help="prompt text (repeatable)")
    p.add_argument("-f", "--prompts-file", help="file with one prompt per line")
    p.add_argument("-n", "--num-tokens", type=int, default=64,
                   help="max new tokens per request")
    p.add_argument("-t", "--temperature", type=float, default=0.0)
    p.add_argument("-s", "--tokenizer", help="external tokenizer.bin")
    p.add_argument("--dtype", default="native", choices=["f32", "bf16", "native"])
    p.add_argument("--cache-dtype", default="bf16", choices=["f32", "bf16", "int8"])
    p.add_argument("--batch", type=int, default=8, help="engine slots")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool + prefix caching (llama only)")
    p.add_argument("--block-size", type=int, default=None,
                   help="paged block size (default 16; 32 for int8 pools)")
    p.add_argument("--n-blocks", type=int, default=None,
                   help="paged pool size (default: batch x max_seq worth)")
    p.add_argument("--stop-at-eos", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _load(args, device):
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models.llama import load_gguf
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    gguf = GGUFFile(args.model)
    params, cfg = load_gguf(gguf, dtype_policy=args.dtype, device=device)
    tokenizer = (BPETokenizer.from_gguf(gguf)
                 if "tokenizer.ggml.tokens" in gguf.metadata else None)
    if args.tokenizer:
        tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if tokenizer is None:
        raise SystemExit("no tokenizer available (use -s tokenizer.bin)")
    return params, cfg, tokenizer


def make_engine(args, params, cfg, tokenizer, max_seq, device):
    """The dense or paged engine from parsed serving flags."""
    import torch

    from tpu_llm_torch.runtime.batching import BatchEngine
    from tpu_llm_torch.runtime.engine import ModelAdapter

    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    bos_id = (getattr(tokenizer, "bos_id", 1)
              if getattr(tokenizer, "add_bos", True) else -1)
    eos_id = getattr(tokenizer, "eos_id", 2)
    if args.paged:
        from tpu_llm_torch.runtime.paged_engine import PagedEngine

        bs = args.block_size or (32 if args.cache_dtype == "int8" else 16)
        n_blocks = args.n_blocks or (1 + args.batch * ((max_seq + bs - 1) // bs))
        return PagedEngine(params, cfg, batch=args.batch, n_blocks=n_blocks,
                           block_size=bs, max_seq=max_seq, cache_dtype=cache_dtype,
                           bos_id=bos_id, eos_id=eos_id, device=device)
    adapter = ModelAdapter.llama(cfg, cache_dtype=cache_dtype, bos_id=bos_id,
                                 device=device)
    return BatchEngine(params, adapter, batch=args.batch, max_seq=max_seq,
                       eos_id=eos_id)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from tpu_llm_torch.runtime.batching import Request

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    if args.cache_dtype == "int8" and not args.paged:
        print("--cache-dtype int8 needs --paged in this slice of tpu_llm_torch "
              "(ROADMAP.md queue 1: the dense int8 QuantKV cache)", file=sys.stderr)
        return 1
    device = torch.device(args.device)

    prompts = list(args.prompt)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [ln.rstrip("\n") for ln in f if ln.strip()]
    if not prompts:
        print("no prompts (-p or -f)", file=sys.stderr)
        return 1

    t_load = time.perf_counter()
    try:
        params, cfg, tokenizer = _load(args, device)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    if args.verbose:
        print(f"config: {cfg}", file=sys.stderr)
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda"
                 else ""), file=sys.stderr)
        print(f"loaded weights in {time.perf_counter() - t_load:.2f}s", file=sys.stderr)
    prompt_ids = [tokenizer.encode(t) for t in prompts]
    ctx_cap = cfg.seq_len
    # default context: the longest prompt (+BOS) + the budget
    need = max(len(ids) for ids in prompt_ids) + 1 + args.num_tokens
    max_seq = args.max_seq or min(ctx_cap, max(need, 256))
    if args.paged and max_seq > 256 and max_seq % 256:
        # a 256-multiple keeps long-prompt prefill on the flash kernel's
        # route (S % 256 gate)
        max_seq = min(-(-max_seq // 256) * 256, ctx_cap)
    engine = make_engine(args, params, cfg, tokenizer, max_seq, device)

    t0 = time.perf_counter()
    first_tok_s = {}

    def _mark_first(rid):
        def cb(_tok):
            if rid not in first_tok_s:
                first_tok_s[rid] = time.perf_counter() - t0
        return cb

    reqs = []
    for i, ids in enumerate(prompt_ids):
        reqs.append(engine.submit(Request(
            prompt=ids, max_new=args.num_tokens, temperature=args.temperature,
            seed=args.seed + i, stop_at_eos=args.stop_at_eos,
            stream=_mark_first(i))))

    steps = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    n_generated = 0
    for i, (req, text) in enumerate(zip(reqs, prompts)):
        n_generated += len(req.tokens)
        out = tokenizer.decode(req.tokens)
        if isinstance(out, bytes):  # byte-exact decode -> lossy str for JSON
            out = out.decode("utf-8", errors="replace")
        print(json.dumps({
            "prompt": text,
            "completion": out,
            "n_tokens": len(req.tokens),
            "ttft_s": round(first_tok_s.get(i, wall), 4),
        }), flush=True)
    ttfts = sorted(first_tok_s.values()) or [wall]
    summary = {
        "requests": len(reqs),
        "generated_tokens": n_generated,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(n_generated / max(wall, 1e-9), 2),
        "ttft_p50_s": round(ttfts[len(ttfts) // 2], 4),
        "engine_steps": steps,
        "engine": "paged" if args.paged else "dense",
        "speculative_k": 0,
    }
    if args.paged and engine.prefix is not None and engine.prefix.queries:
        summary["prefix_cache_hit_rate"] = round(
            engine.prefix.hits / engine.prefix.queries, 3)
        summary["hbm_blocks_in_use"] = engine.hbm_blocks_in_use
    print(json.dumps(summary), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
