"""Pipeline parallelism (tpu_llm_torch.parallel.pipeline) on CPU gloo groups
of 4 ranks (one spawn for every case), against the JAX package: the
pipelined prefill (4 stages, and 2 stages x dp 2, 4 sequence chunks) and
the decode step after it, and PP x TP decode (pipe 2 x tp 2, 4 greedy
steps). The pipe 2 x dp 2 decode step is held against the JAX package's
own decode_step_pipelined (from the same cache); the others against its
single-device forward / decode_step, which its own tests hold the
pipelined functions equal to (tests/test_pipeline.py; its unrolled
prefill_pipelined compile is left out here). Tolerances are that file's:
2e-4 for hidden states and the PP logits, 1e-5 for caches, 2e-5 for the
PP x TP logits."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.test_pipeline import CFG, make_params
from tests.test_torch_llama import to_numpy
from tests.test_torch_ring import flat, jax_decode
from tests.torch_parallel_ranks import seq_pipe_rank
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.models import llama as JM
from tpu_llm.parallel import llama_param_specs, shard_pytree
from tpu_llm.parallel import make_mesh as jmake_mesh
from tpu_llm.parallel.pipeline import decode_step_pipelined
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.parallel import pipeline
from tpu_llm_torch.parallel.distributed import launch
from tpu_llm_torch.parallel.mesh import Mesh

T = 16
TP_CFG = dict(dim=32, hidden_dim=64, n_layers=4, n_heads=4, n_kv_heads=2, vocab_size=64,
              seq_len=16)


def tp_params(seed=9):
    """tests/test_pipeline.py::test_pp_tp_composed_decode_matches_dense's
    weights."""
    cfg = JConfig(**TP_CFG)
    rng = np.random.default_rng(seed)
    s = lambda *sh: jnp.asarray((rng.standard_normal(sh) * 0.05).astype(np.float32))  # noqa: E731
    L, E, F, V, KV = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    return {"tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
            "layers": {"attn_norm": s(L, E) + 1.0, "ffn_norm": s(L, E) + 1.0,
                       "wq": s(L, E, E), "wk": s(L, E, KV), "wv": s(L, E, KV),
                       "wo": s(L, E, E), "w1": s(L, E, F), "w3": s(L, E, F),
                       "w2": s(L, F, E)}}


@pytest.fixture(scope="module")
def refs():
    cfg = JConfig(**CFG)
    p3 = make_params(3)
    tokens = np.random.default_rng(8).integers(0, CFG["vocab_size"], (2, T)).astype(np.int32)
    hidden0, cache0 = JM.forward(p3, cfg, jnp.asarray(tokens),
                                 JM.init_cache(cfg, 2, CFG["seq_len"]), jnp.int32(0))
    # the JAX package's own pipelined step, pipe 2 x dp 2, from the same cache
    mesh = jmake_mesh(data=2, model=1, pipe=2)
    spec = NamedSharding(mesh, P("pipe", "data", None, None, None))
    pcache = jax.tree_util.tree_map(lambda a: jax.device_put(a, spec), cache0)
    pp_logits, _ = decode_step_pipelined(
        shard_pytree(p3, llama_param_specs(cfg, pipe=True), mesh), cfg,
        jnp.asarray(tokens[:, -1]), pcache, jnp.int32(T), mesh)
    logits0, cache1 = JM.decode_step(p3, cfg, jnp.asarray(tokens[:, -1]), cache0, jnp.int32(T))
    tp = tp_params()
    feed, tp_logits, tp_cache = jax_decode(tp, JConfig(**TP_CFG), [3, 9], 4)
    return dict(p3=p3, tokens=tokens, hidden0=hidden0, logits0=np.asarray(logits0),
                pp_logits=np.asarray(pp_logits), cache1=cache1,
                tp=(tp, feed, tp_logits, tp_cache))


# chip_smoke.py's phase seq_pipe_full_width at a tiny width (its prompts and
# cache rows as they are: 2048 rows; n_kv_heads 4 for Ulysses degree 4)
SMOKE_CFG = dict(dim=64, hidden_dim=128, n_layers=4, n_heads=8, n_kv_heads=4, vocab_size=256,
                 seq_len=2048)


@pytest.fixture(scope="module")
def smoke_npz(tmp_path_factory):
    from tpu_llm_torch.io.weight_cache import save_weight_cache

    cfg = TConfig(**SMOKE_CFG)
    rng = np.random.default_rng(0)
    s = lambda *sh: torch.from_numpy((rng.standard_normal(sh) * 0.08).astype(np.float32))  # noqa: E731
    E, F, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    params = {"tok_emb": s(V, E).bfloat16(), "final_norm": 1 + 0.1 * s(E), "wcls": s(E, V),
              "layers": [{"attn_norm": 1 + 0.1 * s(E), "ffn_norm": 1 + 0.1 * s(E),
                          "wqkv": s(E, E + 2 * KV), "wo": s(E, E), "w13": s(E, 2 * F),
                          "w2": s(F, E)} for _ in range(cfg.n_layers)]}
    path = str(tmp_path_factory.mktemp("smoke") / "tiny.npz")
    save_weight_cache(path, params, cfg)
    return path


@pytest.fixture(scope="module")
def ranks(refs, smoke_npz):
    import chip_smoke

    pp = dict(tree=to_numpy(refs["p3"]), cfg=CFG, tokens=refs["tokens"],
              feed=[refs["tokens"][:, -1].tolist()])
    tp, feed, _, _ = refs["tp"]
    cases = [("pp_4x1", "pipeline", (4, 1, 1), dict(pp, microbatches=0)),
             ("pp_2x2", "pipeline", (2, 2, 1), dict(pp, microbatches=4)),
             ("pp_tp", "pipeline", (2, 1, 2), dict(tree=to_numpy(tp), cfg=TP_CFG, feed=feed)),
             ("smoke", "smoke_phase", (1, 1, 4),
              dict(npz=smoke_npz, prompts=chip_smoke.seq_pipe_prompts(SMOKE_CFG["vocab_size"])))]
    return launch(seq_pipe_rank, 4, cases, device="cpu", timeout=600)


def stage_cache(ranks, name, heads: bool = False):
    """Per layer (B, S, Hkv * D) planes reassembled: layers by pipe index,
    batch rows by data index, kv heads by model index (``heads``)."""
    got = {idx: res["cache"] for idx, res in (r[name] for r in ranks if name in r)}
    pipe = 1 + max(p for p, _, _ in got)
    data = 1 + max(d for _, d, _ in got)
    model = 1 + max(m for _, _, m in got)
    out = {}
    for kk in ("k", "v"):
        out[kk] = []
        for p in range(pipe):
            for i in range(len(got[(p, 0, 0)][kk])):
                rows = [np.concatenate([got[(p, d, m)][kk][i] for m in range(model)], axis=2)
                        if heads else got[(p, d, 0)][kk][i] for d in range(data)]
                out[kk].append(np.concatenate(rows, axis=0))
    return out


@pytest.mark.parametrize("name", ["pp_4x1", "pp_2x2"])
def test_pp_prefill_and_decode_match_jax(name, refs, ranks):
    """Every stage returns the whole final-normed hidden state and the
    step's logits; the cache's first T + 1 rows reassemble to the JAX
    cache. pipe 2 x dp 2's step against the JAX decode_step_pipelined,
    pipe 4's against decode_step."""
    want_logits = refs["pp_logits"] if name == "pp_2x2" else refs["logits0"]
    for (p, d, m), res in (r[name] for r in ranks if name in r):
        b = 1 if name == "pp_2x2" else 2
        np.testing.assert_allclose(res["hidden"], np.asarray(refs["hidden0"])[d * b:(d + 1) * b],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["logits"][0], want_logits[d * b:(d + 1) * b],
                                   rtol=2e-4, atol=2e-4)
        # 4 chunks and a step hop once between each pair of stages; one
        # broadcast of the last stage's rows each
        pipe = 2 if name == "pp_2x2" else 4
        hops = 5 * ((p > 0) + (p < pipe - 1))
        c = res["counts"]
        assert (c.get("send", 0) + c.get("recv", 0), c["broadcast"]) == (hops, 2), c
    got = stage_cache(ranks, name)
    for kk in ("k", "v"):
        for i, plane in enumerate(got[kk]):
            np.testing.assert_allclose(plane[:, :T + 1], flat(refs["cache1"][kk][i])[:, :T + 1],
                                       rtol=1e-5, atol=1e-5)


def test_pp_tp_decode_matches_jax(refs, ranks):
    """pipe 2 x tp 2: four greedy steps from a fresh cache; each rank's
    logits against the JAX decode_step; per step and rank 2 all-reduces a
    layer of its stage, one hop, one broadcast, one logits gather."""
    _, feed, want, cache = refs["tp"]
    L = TP_CFG["n_layers"] // 2
    for (p, d, m), res in (r["pp_tp"] for r in ranks):
        for lg, ref in zip(res["logits"], want, strict=True):
            np.testing.assert_allclose(lg, ref, rtol=2e-5, atol=2e-5)
        c = res["counts"]
        assert (c["all_reduce"], c.get("send", 0) + c.get("recv", 0), c["broadcast"],
                c["gather"]) == (2 * L * 4, 4, 4, 4), c
    got = stage_cache(ranks, "pp_tp", heads=True)
    for kk in ("k", "v"):
        for i, plane in enumerate(got[kk]):
            np.testing.assert_allclose(plane, flat(cache[kk][i]), rtol=1e-5, atol=1e-5)


def test_refusals_before_any_collective():
    """Indivisible layers and chunks raise ValueError naming "divisible" in
    one process (no process group)."""
    cfg3 = TConfig(**{**CFG, "n_layers": 3})
    mesh = Mesh(1, 1, 0, torch.device("cpu"), "gloo", ranks=list(range(4)), pipe=4)
    tok = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.decode_step_pipelined({}, cfg3, tok, {}, 0, mesh)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.decode_step_pp_tp({}, cfg3, tok, {}, 0, mesh)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.stage_params({"layers": []}, cfg3, mesh)
    with pytest.raises(ValueError, match="divisible"):
        pipeline.prefill_pipelined({}, TConfig(**CFG), torch.zeros((1, 10), dtype=torch.long),
                                   {}, mesh, microbatches=4)
    assert not mesh.counts


def test_smoke_phase_holds_on_cpu(ranks):
    """chip_smoke.py's phase seq_pipe_full_width, its rank side on CPU
    tensors: every first-token logits row and cache part it holds is
    within the phase's bounds (here, with no near-tie row, every cache
    row it wrote within 1e-3 * max|k|; a CP rank keeps the rows it does
    not own), the ranks of a batch row generate the same
    greedy tokens, and each case's collectives are the ones the code
    places (L layers, 16 greedy steps)."""
    import chip_smoke as S

    L, n = SMOKE_CFG["n_layers"], S.SP_NEW
    want = {"ring_prefill": {"ppermute": 3 * L}, "cp_decode": {"all_reduce": 2 * L * n},
            "ulysses_prefill": {"all_to_all": 3 * L + 1, "broadcast": 1},
            "ulysses_decode": {"gather": L * n},
            "sp_prefill": {"gather": 2 * L + 1, "reduce_scatter": 2 * L, "broadcast": 1},
            "pp_prefill": {"hop": 2, "broadcast": 1}, "pp_decode": {"hop": n, "broadcast": n},
            "pp_tp_decode": {"all_reduce": L * n, "hop": n, "broadcast": n, "gather": n}}
    res = [r["smoke"][1] for r in ranks]
    for name, counts in want.items():
        for x in (r[name] for r in res):
            got = {k: v for k, v in x["collectives"].items() if not k.endswith("_bytes")}
            got["hop"] = got.pop("send", 0) + got.pop("recv", 0)
            assert {k: got.get(k, 0) for k in counts} == counts, (name, got)
            assert sum(got.values()) == sum(counts.values()), (name, got)
    held = 0
    for name in res[0]:
        if name == "backend":
            continue
        rows = {}
        for x in (r[name] for r in res):
            if "logits_err" in x:
                held += 1
                assert x["logits_err"] <= x["logits_tol"] and x["top1"] == x["top1_ref"], name
            for kk in ("k", "v"):
                if f"cache_rel_{kk}" in x:
                    held += 1
                    assert x[f"cache_rel_{kk}"] <= S.SP_CACHE_REL, (name, kk)
            if "cache_rows" in x:       # no near-tie row: the kernel path is the plain one here
                S.hold_cache_rows(torch, name, x, {kk: torch.zeros(S.SP_MAX_SEQ) for kk in "kv"})
            if name == "cp_decode":
                assert x["cache_kept"], name
            if "tokens" in x:
                rows.setdefault(x["index"][1], []).append([x["tok0"]] + x["tokens"])
        for seqs in rows.values():
            assert all(sq == seqs[0] for sq in seqs) and len(seqs[0]) == n + 1, name
    # logits: ring 1 rank, CP 4, Ulysses 1, SP 4, PP 4, PP x TP 4; caches: 5 cases x 4
    # ranks x 2, and CP's 2 ranks that own a row of the 16 it wrote
    assert held == 18 + 44
