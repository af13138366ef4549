"""`llm-ssm` of the port: ``python -m tpu_llm_torch.runtime.mamba_cli``
(``tpu_llm/runtime/mamba_cli.py``, the reference's ssm/llm executable,
ssm/mamba.f90:90-443).

Decodes a Mamba model from a packed checkpoint with a tokenizer.bin
(GPT-NeoX vocabulary with merge-rank scores). Flags: -m -p -s -t -n -v
(the reference's), --ak (accepted and implied: the packed format is the
only one, ssm/mamba.f90:159-162), --seed, --dtype f32|bf16 (bf16: the
projections, embedding and classifier stored in bf16, the state f32),
--scan (the decode step captured in a CUDA graph and replayed a token; no
streaming), --convert HF_DIR (HF Mamba -> packed at -m, the reference's
ssm/savemodel.py), --convert-tokenizer TOKENIZER_JSON (-> tokenizer.bin at
-s, the reference's ssm/convert_tokens.py) and --device (cuda unless told
otherwise; the converters need no card).

Output contract: the streamed token bytes (with --scan, the decoded text at
the end), a blank line, the inference time, the decode tokens/second and
the TTFT. An empty prompt exits 1: Mamba has no BOS (ssm/mamba.f90:406).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="llm-ssm", description=__doc__, allow_abbrev=False)
    p.add_argument("-m", "--model", default="model.bin")
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-s", "--tokenizer", default="tokenizer.bin")
    p.add_argument("-t", "--temperature", type=float, default=0.0)
    p.add_argument("-n", "--num_tokens", type=int, default=100)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--ak", action="store_true",
                   help="packed format (always on; kept for flag parity)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="f32 = the reference's numerics (default); bf16 = weight-only "
                        "cast of the projections, embedding and classifier")
    p.add_argument("--scan", action="store_true",
                   help="decode loop as a captured CUDA graph (no streaming)")
    p.add_argument("--convert", metavar="HF_DIR",
                   help="convert a HF Mamba dir to packed format at -m, then exit")
    p.add_argument("--convert-tokenizer", metavar="TOKENIZER_JSON",
                   help="convert a HF tokenizer.json (GPT-NeoX byte-level BPE) to "
                        "tokenizer.bin at -s, then exit")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.convert:
        from tpu_llm_torch.io.mamba_ckpt import convert_hf_mamba

        convert_hf_mamba(args.convert, args.model, verbose=True)
        return 0

    if args.convert_tokenizer:
        from tpu_llm_torch.tokenizers.bpe import BPETokenizer
        from tpu_llm_torch.tokenizers.tokenizer_bin import write_tokenizer_bin

        tok = BPETokenizer.from_hf_tokenizer_json(args.convert_tokenizer)
        write_tokenizer_bin(args.tokenizer, tok.tokens, tok.scores)
        print(f"wrote {args.tokenizer} ({tok.vocab_size} tokens)")
        return 0

    import torch

    from tpu_llm_torch.models.mamba import cast_weights, load_packed
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    device = torch.device(args.device)

    t0 = time.perf_counter()
    params, cfg = load_packed(args.model, device)
    tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if args.verbose:
        print(f"config: {cfg}", file=sys.stderr)
        print(f"loaded in {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    if args.dtype == "bf16":
        params = cast_weights(params)
    engine = Engine(params, ModelAdapter.mamba(cfg, device),
                    max_seq=max(args.num_tokens + 8, 64), device=device)

    prompt_ids = tokenizer.encode(args.prompt) if args.prompt else []
    if not prompt_ids:
        print("empty prompt (Mamba needs a first token; no BOS convention, "
              "ssm/mamba.f90:406)", file=sys.stderr)
        return 1

    out = sys.stdout.buffer

    def stream(tid: int):
        if tid < tokenizer.vocab_size:
            out.write(tokenizer.token_bytes(tid))
            out.flush()

    seed = args.seed if args.seed is not None else int(time.time_ns() % (2**31))
    res = engine.generate(prompt_ids, n_total=args.num_tokens,
                          temperature=args.temperature, seed=seed,
                          stream=None if args.scan else stream, add_bos=False,
                          use_scan=args.scan)
    if args.scan:
        out.write(tokenizer.decode([t for t in res.tokens if t < tokenizer.vocab_size]))
        out.flush()

    print()
    print(f" Inference time: {res.total_s:10.4f} seconds")
    print(f" {res.tokens_per_s:10.4f} tokens/second (decode)")
    print(f" TTFT: {res.ttft_s * 1000:10.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
