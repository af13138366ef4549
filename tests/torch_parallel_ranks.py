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


# -- sequence and pipeline parallelism (parallel/ring, ulysses, sequence,
#    pipeline) ------------------------------------------------------------------

def _planes(cache):
    return {k: [p.numpy().copy() for p in cache[k]] for k in ("k", "v")}


def _shards(a, mesh, axis: int):
    """This rank's contiguous block of numpy ``a`` along ``axis`` over the
    model group, as a tensor."""
    n, r = mesh.model, mesh.model_index
    w = a.shape[axis] // n
    return torch.from_numpy(a.take(range(r * w, (r + 1) * w), axis=axis).copy())


def _case_collectives(mesh, kw):
    """Mesh.ppermute / all_to_all / reduce_scatter_model / send / recv /
    broadcast on this rank's block (x + 100 * rank, on kw["device"], the
    CPU by default), and its grid indices."""
    x = (torch.arange(48, dtype=torch.float32).reshape(2, 8, 3)
         + 100 * mesh.rank).to(kw.get("device", "cpu"))
    host = lambda t: t.cpu().numpy()  # noqa: E731
    out = dict(index=(mesh.pipe_index, mesh.data_index, mesh.model_index),
               ppermute=host(mesh.ppermute(x, mesh.model_group)),
               ppermute_back=host(mesh.ppermute(x, mesh.model_group, shift=-1)),
               all_to_all=host(mesh.all_to_all(x, 1, 2, mesh.model_group)),
               reduce_scatter=host(mesh.reduce_scatter_model(x, 1)),
               max=host(mesh.reduce_model(x, "max")),
               broadcast=host(mesh.broadcast(x.clone(), 1, mesh.pipe_group)))
    if mesh.pipe_index == 0:
        mesh.send(x, 1, mesh.pipe_group)
    else:
        out["recv"] = host(mesh.recv(x.shape, x.dtype, 0, mesh.pipe_group))
    out["counts"] = dict(mesh.counts)
    return out


def cuda_collectives_rank(rank: int):
    """The collectives of ``_case_collectives`` on a pipe 2 x model 2 mesh
    of a gloo world whose ranks' device is the card: on CUDA tensors (the
    host route gloo takes) and on CPU tensors -> (card, cpu) results."""
    from tpu_llm_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, 2, pipe=2, device="cuda", ranks=[0, 1, 2, 3])
    card = _case_collectives(mesh, {"device": mesh.device})
    mesh.counts.clear()
    return card, _case_collectives(mesh, {})


def _case_ring_attention(mesh, kw):
    from tpu_llm_torch.parallel.ring import ring_gqa_attention

    q, k, v = (_shards(kw[n], mesh, 1) for n in ("q", "k", "v"))
    B, Sl = k.shape[:2]
    out = ring_gqa_attention(q, k, v.reshape(B, Sl, -1), mesh.model_index * Sl, mesh)
    return out.numpy()


def _case_ulysses_attention(mesh, kw):
    from tpu_llm_torch.parallel.ulysses import ulysses_gqa_attention

    q, k, v = (_shards(kw[n], mesh, 1) for n in ("q", "k", "v"))
    B, Sl = k.shape[:2]
    return ulysses_gqa_attention(q, k.reshape(B, Sl, -1), v, mesh).numpy()


def _model(kw):
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.models.llama import params_from_numpy

    return params_from_numpy(kw["tree"]), LlamaConfig(**kw["cfg"])


def _case_prefill(mesh, kw):
    """ring / ulysses / sequence-parallel prefill of kw["tokens"] (this rank's
    batch rows); its hidden rows and cache planes."""
    from tpu_llm_torch.parallel import ring, sequence, ulysses
    from tpu_llm_torch.parallel.serving import shard_llama_params
    from tpu_llm_torch.parallel.sharding import data_rows
    from tpu_llm_torch.parallel.tp_decode import init_tp_cache

    params, cfg = _model(kw)
    tokens = torch.tensor(kw["tokens"])
    B, T = tokens.shape
    tokens = tokens[data_rows(mesh, B)]
    if kw["how"] == "sp":
        params = shard_llama_params(params, cfg, mesh)
        cache = init_tp_cache(cfg, mesh, B, T, torch.float32)
        fn = sequence.prefill_sequence_parallel
    else:
        cache = ring.init_cp_cache(cfg, mesh, B, T)
        fn = ring.prefill_context_parallel if kw["how"] == "ring" else ulysses.prefill_ulysses
    hidden, cache = fn(params, cfg, tokens, cache, mesh)
    return dict(hidden=hidden.numpy(), cache=_planes(cache), counts=dict(mesh.counts))


def _case_cp_decode(mesh, kw):
    """decode_step_context_parallel over a fresh sequence-sharded cache,
    fed kw["feed"] (a (B,) token row a step)."""
    from tpu_llm_torch.parallel import ring
    from tpu_llm_torch.parallel.sharding import data_rows

    params, cfg = _model(kw)
    B = len(kw["feed"][0])
    rows = data_rows(mesh, B)
    cache = ring.init_cp_cache(cfg, mesh, B, cfg.seq_len)
    logits = []
    for pos, tok in enumerate(kw["feed"]):
        lg, cache = ring.decode_step_context_parallel(params, cfg, torch.tensor(tok)[rows],
                                                      cache, pos, mesh)
        logits.append(lg.numpy())
    return dict(logits=logits, cache=_planes(cache), counts=dict(mesh.counts))


def _case_ulysses_decode(mesh, kw):
    """prefill_ulysses, reshard_cache_for_decode to kw["max_seq"], then the
    greedy steps fed kw["feed"]."""
    from tpu_llm_torch.parallel import ring, ulysses
    from tpu_llm_torch.parallel.sharding import data_rows

    params, cfg = _model(kw)
    tokens = torch.tensor(kw["tokens"])
    B, T = tokens.shape
    rows = data_rows(mesh, B)
    cache = ring.init_cp_cache(cfg, mesh, B, T)
    hidden, cache = ulysses.prefill_ulysses(params, cfg, tokens[rows], cache, mesh)
    cache = ulysses.reshard_cache_for_decode(cache, kw["max_seq"], mesh)
    logits = []
    for i, tok in enumerate(kw["feed"]):
        lg, cache = ulysses.decode_ulysses(params, cfg, torch.tensor(tok)[rows], cache,
                                           T + i, mesh)
        logits.append(lg.numpy())
    return dict(hidden=hidden.numpy(), logits=logits, cache=_planes(cache))


def _case_pipeline(mesh, kw):
    """prefill_pipelined of kw["tokens"] (if any), then the decode steps fed
    kw["feed"] from position T (decode_step_pp_tp where mesh.model > 1)."""
    from tpu_llm_torch.parallel import pipeline
    from tpu_llm_torch.parallel.sharding import data_rows

    params, cfg = _model(kw)
    params = pipeline.stage_params(params, cfg, mesh)
    B = len(kw["feed"][0])
    rows = data_rows(mesh, B)
    cache = pipeline.init_stage_cache(cfg, mesh, B, cfg.seq_len)
    out, T = {}, 0
    if kw.get("tokens") is not None:
        tokens = torch.tensor(kw["tokens"])[rows]
        T = tokens.shape[1]
        hidden, cache = pipeline.prefill_pipelined(params, cfg, tokens, cache, mesh,
                                                   microbatches=kw["microbatches"])
        out["hidden"] = hidden.numpy()
    step = pipeline.decode_step_pp_tp if mesh.model > 1 else pipeline.decode_step_pipelined
    out["logits"] = []
    for i, tok in enumerate(kw["feed"]):
        lg, cache = step(params, cfg, torch.tensor(tok)[rows], cache, T + i, mesh)
        out["logits"].append(lg.numpy())
    out.update(cache=_planes(cache), counts=dict(mesh.counts))
    return out


def _case_smoke_phase(mesh, kw):
    """chip_smoke.py phase seq_pipe_full_width's rank side on CPU tensors
    (its cases make their own meshes over the same world)."""
    import chip_smoke

    return chip_smoke.seq_pipe_rank(mesh.rank, kw["npz"], kw["prompts"], device="cpu")


SEQ_PIPE_CASES = dict(collectives=_case_collectives, ring_attention=_case_ring_attention,
                      ulysses_attention=_case_ulysses_attention, prefill=_case_prefill,
                      cp_decode=_case_cp_decode, ulysses_decode=_case_ulysses_decode,
                      pipeline=_case_pipeline, smoke_phase=_case_smoke_phase)


def seq_pipe_rank(rank: int, cases):
    """``cases``: [(name, kind, (pipe, dp, tp), kwargs)] -> {name: (this rank's
    (pipe, data, model) index, the case's result)}: each case on a fresh
    mesh of pipe x dp x tp ranks, its function from SEQ_PIPE_CASES."""
    from tpu_llm_torch.parallel.mesh import make_mesh

    out = {}
    for name, kind, (pipe, dp, tp), kw in cases:
        mesh = make_mesh(dp, tp, pipe=pipe, device="cpu",
                         ranks=list(range(pipe * dp * tp)))
        if not mesh.member:
            continue
        with torch.inference_mode():
            out[name] = ((mesh.pipe_index, mesh.data_index, mesh.model_index),
                         SEQ_PIPE_CASES[kind](mesh, kw))
    return out
