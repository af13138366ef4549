"""Rank functions of the port's multi-process tests, spawned by
``tpu_llm_torch.parallel.distributed.launch`` on CPU gloo groups. A
spawned rank imports this module by name, so it imports only torch,
numpy and the port (never JAX): the tests compute their JAX references
in their own process and compare what the ranks return.

Every rank runs each scenario in the same order (the meshes are made
collectively); a scenario on a smaller mesh than the world is skipped by
the ranks it leaves out. Rank 0's results are the ones compared.
"""

from __future__ import annotations

import torch


def _mesh(dp: int, tp: int):
    from tpu_llm_torch.parallel.mesh import make_mesh

    return make_mesh(dp, tp, device="cpu", ranks=list(range(dp * tp)))


def tp_decode_rank(rank: int, cases):
    """``cases``: [(name, numpy params tree, config kwargs, tp, dp, tokens,
    fused, steps)] -> {name: [(this rank's data index, logits (B / dp, V)
    as numpy) a step]}: the explicit TP decode step greedy-fed from
    position 0."""
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.models.llama import params_from_numpy
    from tpu_llm_torch.parallel.tp_decode import (init_tp_cache, make_tp_decode_step,
                                                  repack_fused_for_tp, shard_tp_params)

    out = {}
    for name, tree, cfg_kw, tp, dp, tokens, fused, steps in cases:
        mesh = _mesh(dp, tp)
        if not mesh.member:
            continue
        cfg = LlamaConfig(**cfg_kw)
        params = params_from_numpy(tree)
        if fused:
            params = dict(params, layers=repack_fused_for_tp(params["layers"], cfg, tp))
        sh = shard_tp_params(params, cfg, mesh, fused=fused)
        cache = init_tp_cache(cfg, mesh, len(tokens), cfg.seq_len, dtype=torch.float32)
        step = make_tp_decode_step(cfg, mesh)
        b = len(tokens) // dp if dp > 1 else len(tokens)
        tok = torch.tensor(tokens, dtype=torch.int32)[mesh.data_index * b:][:b]
        got = []
        with torch.inference_mode():
            for pos in range(steps):
                logits, cache = step(sh, tok, cache, pos)
                got.append(logits.numpy().copy())
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out[name] = (mesh.data_index, got)
    return out


def engine_rank(rank: int, cases):
    """``cases``: [(name, numpy params tree or a GGUF path, config kwargs, tp,
    dp, engine kwargs, requests, draft tree)] -> {name: (token lists, spec
    stats)}:
    the port's BatchEngine ("dense") or PagedEngine ("paged") placed by
    shard_engine, each request (prompt, max_new, Request kwargs) run to
    its end."""
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.models.llama import params_from_numpy
    from tpu_llm_torch.parallel.serving import shard_engine
    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.paged_engine import PagedEngine

    out = {}
    for name, tree, cfg_kw, tp, dp, kw, requests, draft_tree in cases:
        mesh = _mesh(dp, tp)
        if not mesh.member:
            continue
        if isinstance(tree, str):            # a GGUF of any llama-family architecture
            from tpu_llm_torch.io.gguf import GGUFFile
            from tpu_llm_torch.models.llama import load_model

            params, cfg = load_model(GGUFFile(tree), "f32", "cpu")
        else:
            cfg, params = LlamaConfig(**cfg_kw), params_from_numpy(tree)
        kw = dict(kw)
        paged = kw.pop("engine") == "paged"
        cache = kw.pop("cache_dtype", torch.float32)
        draft = None
        if draft_tree is not None:
            draft = (params_from_numpy(draft_tree),
                     ModelAdapter.llama(cfg, bos_id=1, device="cpu"))
        if paged:
            eng = PagedEngine(params, cfg, bos_id=1, cache_dtype=cache, device="cpu",
                              draft=draft, **kw)
        else:
            eng = BatchEngine(params, ModelAdapter.llama(cfg, cache, bos_id=1, device="cpu"),
                              draft=draft, **kw)
        eng = shard_engine(eng, cfg, mesh, draft_cfg=cfg if draft is not None else None)
        with torch.inference_mode():
            reqs = [eng.submit(Request(prompt=list(p), max_new=n, **rkw))
                    for p, n, rkw in requests]
            eng.run()
        out[name] = ([list(r.tokens) for r in reqs], dict(eng.stats))
    return out


def server_rank(rank: int, model: str, argv, prompts, max_tokens: int):
    """llm-server's pieces on a 2-rank tp mesh (the first two ranks): the
    first serves HTTP and broadcasts each step's plan, the other follows;
    the first sends ``prompts`` as concurrent greedy completions and
    returns their token lists."""
    import json
    import threading
    import urllib.request

    from tpu_llm_torch.parallel.serving import make_tp_llama_adapter
    from tpu_llm_torch.runtime import serve_cli, server

    mesh = _mesh(1, 2)
    if not mesh.member:
        return None
    args = server.build_parser().parse_args(["-m", model, "--device", "cpu", *argv])
    params, cfg, tokenizer = serve_cli._load(args, "cpu")
    eng = serve_cli.make_engine(args, params, cfg, tokenizer, 64, mesh.device, mesh)
    emb = server.Embedder(eng.params, make_tp_llama_adapter(cfg, mesh), max_len=64)
    if mesh.index != 0:
        server.follow(eng, mesh, emb)
        return None
    httpd, loop = server.serve(eng, tokenizer, "127.0.0.1", 0, embedder=emb, mesh=mesh,
                               max_new_cap=32)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    out = [None] * len(prompts)

    def post(i, path, body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=post, args=(i, "/v1/completions",
                                                       {"prompt": p, "max_tokens": max_tokens}))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        vecs = _embed(port, prompts)
    finally:
        httpd.shutdown()
        loop.shutdown()
    return [r["tokens"] for r in out], vecs


def _embed(port: int, texts):
    import json
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/embeddings",
                                 data=json.dumps({"input": list(texts)}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return [d["embedding"] for d in json.loads(r.read())["data"]]


def fail_rank(rank: int, bad: int):
    """Raises on rank ``bad`` (the launcher must fail the run)."""
    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    import torch.distributed as dist

    dist.barrier()          # the other ranks wait on the failed one
    return rank
