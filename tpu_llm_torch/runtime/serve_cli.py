"""`llm-serve` of the port: ``python -m tpu_llm_torch.runtime.serve_cli``.

Offline batched serving (``tpu_llm/runtime/serve_cli.py``): many prompts
(repeated -p, or -f with one a line) through the continuous-batching
engines; requests are admitted into slots as others finish, each prompt
prefills in one forward, and decode runs one batched step for every live
slot. ``--paged`` takes the paged KV pool with automatic prefix caching;
``--cache-dtype int8`` stores the dense planes or the paged pools in int8;
``--spec K`` verifies up to K drafted tokens a greedy slot a forward
(prompt lookup, or the ``--draft GGUF`` model's greedy tokens).

``-m`` takes a GGUF, a ``.npz`` weight cache (``llm-load --cache-out``)
or a Mamba packed checkpoint ``X.bin`` (the reference's ssm format,
``io/mamba_ckpt.py``), which serves on the dense engine: a recurrent state
has no KV rows to page and cannot roll back a draft, so --paged and --draft
are refused for it, as in the JAX package. ``.npz`` and ``.bin`` need -s
tokenizer.bin.

Flags: -m -p -f -n -t -s, --dtype f32|bf16|native, --cache-dtype
f32|bf16|int8, --batch, --max-seq, --paged, --block-size, --n-blocks,
--spec, --draft, --lora GGUF (an adapter merged at load, llama family
only), --tp N / --dp M (the engine on a mesh of N * M ranks,
parallel/serving.py: a single process spawns them itself, and rank 0
alone prints), --stop-at-eos, --top-k, --top-p, --min-p (each request's
sampling filters), --seed, -v and --device (cuda unless told otherwise).

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
    p.add_argument("-m", "--model", required=True,
                   help="GGUF, .npz weight cache, or Mamba packed .bin")
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
    p.add_argument("--draft", default=None, metavar="GGUF",
                   help="small same-vocabulary draft model for two-model "
                        "speculation (needs --spec K)")
    p.add_argument("--lora", default=None, metavar="GGUF",
                   help="LoRA adapter GGUF merged into the base weights at load "
                        "(llama.cpp convert_lora format)")
    p.add_argument("--spec", type=int, default=0, metavar="K",
                   help="speculative drafts per step (greedy slots)")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="tensor-parallel degree: shard the serving step over an "
                        "N-rank model axis")
    p.add_argument("--dp", type=int, default=1, metavar="N",
                   help="data-parallel degree: shard engine batch rows over an N-rank "
                        "data axis (batch %% dp == 0)")
    p.add_argument("--stop-at-eos", action="store_true")
    p.add_argument("--top-k", type=int, default=0,
                   help="per-request top-k filter (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="per-request nucleus filter (1.0 = off)")
    p.add_argument("--min-p", type=float, default=0.0,
                   help="llama.cpp min_p: drop tokens with prob < min_p * max_prob "
                        "(0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def _load(args, device):
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer

    tokenizer = None
    if args.model.endswith(".bin"):          # a Mamba packed checkpoint
        from tpu_llm_torch.io.mamba_ckpt import read_packed

        params, cfg = read_packed(args.model, device)
    elif args.model.endswith(".npz"):
        from tpu_llm_torch.io.weight_cache import load_weight_cache

        params, cfg = load_weight_cache(args.model, device)
    else:
        from tpu_llm_torch.io.gguf import GGUFFile
        from tpu_llm_torch.models.llama import load_model

        gguf = GGUFFile(args.model)
        try:
            params, cfg = load_model(gguf, dtype_policy=args.dtype, device=device,
                                     lora=args.lora, verbose=args.verbose)
        except ValueError as e:
            raise SystemExit(str(e))
        if "tokenizer.ggml.tokens" in gguf.metadata:
            tokenizer = BPETokenizer.from_gguf(gguf)
    if args.tokenizer:
        tokenizer = BPETokenizer.from_tokenizer_bin(args.tokenizer)
    if tokenizer is None:
        raise SystemExit("no tokenizer available (use -s tokenizer.bin)")
    return params, cfg, tokenizer


def make_engine(args, params, cfg, tokenizer, max_seq, device, mesh=None):
    """The dense or paged engine from parsed serving flags (a Mamba model:
    the dense engine only, SystemExit for --paged and --draft), placed on
    ``mesh`` (parallel/serving.shard_engine) when one is given: then
    ``params`` may live on the host, and the engine is built there first."""
    import torch

    from tpu_llm_torch.config import MambaConfig
    from tpu_llm_torch.runtime.batching import BatchEngine
    from tpu_llm_torch.runtime.engine import ModelAdapter

    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": "int8"}[args.cache_dtype]
    bos_id = (getattr(tokenizer, "bos_id", 1)
              if getattr(tokenizer, "add_bos", True) else -1)
    eos_id = getattr(tokenizer, "eos_id", 2)
    if mesh is not None:
        if isinstance(cfg, MambaConfig):
            raise SystemExit("--tp/--dp require a llama-family target")
        if args.batch % mesh.data:
            raise SystemExit(f"--batch {args.batch} must divide by --dp {mesh.data}")
        device = torch.device("cpu")
    if isinstance(cfg, MambaConfig):
        if args.paged:
            raise SystemExit("--paged requires a KV-cache model (llama family)")
        if args.draft:
            raise SystemExit("--draft requires a llama-family target")
        return BatchEngine(params, ModelAdapter.mamba(cfg, device), batch=args.batch,
                           max_seq=max_seq, eos_id=eos_id, speculative_k=args.spec)
    draft = None
    if args.draft:
        from tpu_llm_torch.io.gguf import GGUFFile
        from tpu_llm_torch.models.llama import load_model

        dparams, dcfg = load_model(GGUFFile(args.draft), dtype_policy=args.dtype,
                                   device=device)
        if mesh is not None and mesh.model > 1 and dcfg.n_kv_heads % mesh.model:
            raise SystemExit(f"--tp {mesh.model} must divide the draft model's "
                             f"n_kv_heads={dcfg.n_kv_heads}")
        draft = (dparams, ModelAdapter.llama(dcfg, cache_dtype=torch.bfloat16,
                                             bos_id=bos_id, device=device))
    if args.paged:
        from tpu_llm_torch.runtime.paged_engine import PagedEngine

        bs = args.block_size or (32 if args.cache_dtype == "int8" else 16)
        n_blocks = args.n_blocks or (1 + args.batch * ((max_seq + bs - 1) // bs))
        eng = PagedEngine(params, cfg, batch=args.batch, n_blocks=n_blocks,
                          block_size=bs, max_seq=max_seq, cache_dtype=cache_dtype,
                          speculative_k=args.spec, bos_id=bos_id, eos_id=eos_id,
                          draft=draft, device=device)
    else:
        adapter = ModelAdapter.llama(cfg, cache_dtype=cache_dtype, bos_id=bos_id,
                                     device=device)
        eng = BatchEngine(params, adapter, batch=args.batch, max_seq=max_seq,
                          eos_id=eos_id, speculative_k=args.spec, draft=draft)
    if mesh is None:
        return eng
    from tpu_llm_torch.parallel.serving import shard_engine

    try:
        return shard_engine(eng, cfg, mesh, draft_cfg=dcfg if draft else None)
    except ValueError as e:
        raise SystemExit(str(e))


def spawn_or_mesh(main, argv, args):
    """The serving front ends' world: (exit code, None) when done (ranks
    spawned, or a refusal), else (None, mesh or None)."""
    from tpu_llm_torch.parallel.distributed import front_end_mesh

    if args.tp * args.dp > 1:
        # the JAX front end's refusals that need no model, before any spawn
        if args.model.endswith(".bin"):
            print("--tp/--dp require a llama-family target", file=sys.stderr)
            return 1, None
        if args.batch % args.dp:
            print(f"--batch {args.batch} must divide by --dp {args.dp}", file=sys.stderr)
            return 1, None
    return front_end_mesh(main, argv, args.tp, args.dp, args.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    import torch

    from tpu_llm_torch.runtime.batching import Request

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        return 1
    rc, mesh = spawn_or_mesh(main, argv, args)
    if rc is not None:
        return rc
    lead = mesh is None or mesh.index == 0       # the one rank that prints
    device = mesh.device if mesh is not None else torch.device(args.device)

    prompts = list(args.prompt)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts += [ln.rstrip("\n") for ln in f if ln.strip()]
    if not prompts:
        print("no prompts (-p or -f)", file=sys.stderr)
        return 1

    t_load = time.perf_counter()
    try:
        params, cfg, tokenizer = _load(args, device if mesh is None else "cpu")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 1
    if args.verbose and lead:
        if mesh is not None:
            print(mesh.describe(), file=sys.stderr)
        print(f"config: {cfg}", file=sys.stderr)
        print(f"device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda"
                 else ""), file=sys.stderr)
        print(f"loaded weights in {time.perf_counter() - t_load:.2f}s", file=sys.stderr)
    prompt_ids = [tokenizer.encode(t) for t in prompts]
    ctx_cap = getattr(cfg, "seq_len", 4096)     # Mamba: O(1) state, no cap
    # default context: the longest prompt (+BOS) + the budget
    need = max(len(ids) for ids in prompt_ids) + 1 + args.num_tokens
    max_seq = args.max_seq or min(ctx_cap, max(need, 256))
    if args.paged and max_seq > 256 and max_seq % 256:
        # a 256-multiple keeps long-prompt prefill on the flash kernel's
        # route (S % 256 gate)
        max_seq = min(-(-max_seq // 256) * 256, ctx_cap)
    try:
        engine = make_engine(args, params, cfg, tokenizer, max_seq, device, mesh)
    except SystemExit as e:
        if lead:
            print(e, file=sys.stderr)
        return 1
    del params

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
            top_k=args.top_k, top_p=args.top_p, min_p=args.min_p,
            stream=_mark_first(i))))

    steps = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if not lead:
        return 0

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
        "speculative_k": args.spec,
    }
    if args.spec and engine.stats["spec_forwards"]:
        summary["spec_tokens_per_forward"] = round(
            engine.stats["spec_tokens"] / engine.stats["spec_forwards"], 2)
    if args.paged and engine.prefix is not None and engine.prefix.queries:
        summary["prefix_cache_hit_rate"] = round(
            engine.prefix.hits / engine.prefix.queries, 3)
        summary["hbm_blocks_in_use"] = engine.hbm_blocks_in_use
    print(json.dumps(summary), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
