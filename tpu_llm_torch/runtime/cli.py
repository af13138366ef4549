"""`llm` CLI of the port: ``python -m tpu_llm_torch.runtime.cli``.

The reference flags -m/--model, -p/--prompt, -s/--tokenizer,
-t/--temperature, -n/--num_tokens (total incl. prompt echo), -v/--verbose,
plus --dtype f32|bf16|native, --cache-dtype f32|bf16, --seed, --max-seq,
--rope, --fold-norms and --device (cuda unless told otherwise). Any other flag of the
JAX package's CLI is refused by argparse. Output contract
(``tpu_llm/runtime/cli.py``): the streamed raw token bytes, then a blank
line, the inference time, the decode tokens/second and the TTFT.
"""

from __future__ import annotations

import argparse
import dataclasses
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
    p.add_argument("--cache-dtype", default="f32", choices=["f32", "bf16"])
    p.add_argument("--seed", type=int, default=None,
                   help="sampling seed (default: time-based)")
    p.add_argument("--fold-norms", action="store_true",
                   help="fold rmsnorm weights into the projections "
                        "(quantized weights REQUANTIZE: one extra rounding)")
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--rope", default="interleaved",
                   choices=["interleaved", "neox", "llmf90"],
                   help="rope variant; 'llmf90' reproduces the Fortran bit-for-bit")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models.llama import load_gguf
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    device = torch.device(args.device)

    t_load = time.perf_counter()
    gguf = GGUFFile(args.model)
    params, cfg = load_gguf(gguf, dtype_policy=args.dtype, device=device)
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
    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.cache_dtype]
    bos_id = tokenizer.bos_id if getattr(tokenizer, "add_bos", True) else -1
    adapter = ModelAdapter.llama(cfg, cache_dtype=cache_dtype, bos_id=bos_id,
                                 device=device)
    engine = Engine(params, adapter, max_seq=max_seq, device=device)

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
    res = engine.generate(prompt_ids, n_total=n, temperature=args.temperature,
                          seed=seed, stream=stream)

    # reference output contract
    print()
    print(f" Inference time: {res.total_s:10.4f} seconds")
    print(f" {res.tokens_per_s:10.4f} tokens/second (decode)")
    print(f" TTFT: {res.ttft_s * 1000:10.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
