"""`llm-load` of the port: ``python -m tpu_llm_torch.runtime.convert_cli``
(``tpu_llm/runtime/convert_cli.py``, the reference's `load` converter,
load.f90:158-507).

GGUF -> packed "ak" weight binary (-o, dequantized f32), tokenizer.bin
(-t) and/or the fast-reload ``.npz`` weight cache (--cache-out, with
--dtype f32|bf16|native and --fuse), with the reference's flags -i -o -t
-v. The files need no card: the cache is built on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="llm-load", description=__doc__, allow_abbrev=False)
    p.add_argument("-i", "--infile", required=True, help="input GGUF file")
    p.add_argument("-o", "--outfile", default="", help="output packed ak file")
    p.add_argument("-t", "--tokenizer", default="", help="output tokenizer.bin")
    p.add_argument("--cache-out", default="", metavar="FILE.npz",
                   help="write a fast-reload weight cache: the converted parameter "
                        "tree (dtype policy applied, quants in the device layout); "
                        "`llm -m FILE.npz` reloads it without parsing the GGUF")
    p.add_argument("--dtype", default="native", choices=["f32", "bf16", "native"],
                   help="dtype policy baked into --cache-out")
    p.add_argument("--fuse", action="store_true",
                   help="fuse QKV / gate-up in --cache-out")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from tpu_llm_torch.io.gguf import GGUFFile

    gguf = GGUFFile(args.infile)
    if args.verbose:
        print(f"GGUF v{gguf.version}: {len(gguf.tensors)} tensors, "
              f"{len(gguf.metadata)} metadata keys")

    if args.outfile:
        from tpu_llm_torch.io.ak import write_ak

        write_ak(args.outfile, gguf, verbose=args.verbose)
        print(f"wrote {args.outfile}")

    if args.tokenizer:
        # the '▁' -> ' ' rewrite happens in BPETokenizer.from_gguf, as in
        # the reference's tokenizer write (load.f90:423-503)
        from tpu_llm_torch.tokenizers.bpe import BPETokenizer
        from tpu_llm_torch.tokenizers.tokenizer_bin import write_tokenizer_bin

        tok = BPETokenizer.from_gguf(gguf)
        write_tokenizer_bin(args.tokenizer, tok.tokens, tok.scores)
        print(f"wrote {args.tokenizer} ({tok.vocab_size} tokens)")

    if args.cache_out:
        from tpu_llm_torch.io.weight_cache import save_weight_cache
        from tpu_llm_torch.models.llama import load_gguf

        params, cfg = load_gguf(gguf, dtype_policy=args.dtype, fuse=args.fuse)
        save_weight_cache(args.cache_out, params, cfg)
        print(f"wrote {args.cache_out} (dtype={args.dtype}, fuse={args.fuse})")

    if not args.outfile and not args.tokenizer and not args.cache_out:
        print("nothing to do: pass -o, -t and/or --cache-out", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
