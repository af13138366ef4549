"""The port's engines on a mesh (tpu_llm_torch.parallel.serving) on CPU gloo
groups: one spawn of 4 ranks runs every engine case, each rank its own
shards, and the greedy tokens equal the JAX package's UNSHARDED engines'
(whose sharded engines its own tests hold equal to them:
tests/test_serving_tp.py): the dense BatchEngine at tp 2 and tp 2 x dp 2
over q4_0 weights, the dense int8 cache, PagedEngine with f32 and int8
pools (tp 2, and tp 2 x dp 2), two-model speculation, and the qwen2,
gemma, phi-2 and MoE layouts from tiny GGUFs. Sampled requests at tp 2 x
dp 2 give the port's unsharded engine's streams. `llm-server`'s pieces on
a 2-rank mesh answer concurrent completions and embeddings like the JAX
server's engine; `llm-serve --tp 2` (spawning its own ranks) prints the
JAX front end's completions; the validations carry the JAX messages."""

import json
import types

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.make_tiny_gguf import build, build_moe
from tests.test_serving_tp import N_NEW, PROMPTS
from tests.test_torch_families import _jax_load, write_family
from tests.test_torch_llama import jax_params, to_numpy
from tests.torch_parallel_ranks import engine_rank, server_rank
from tpu_llm.config import LlamaConfig as JConfig
from tpu_llm.runtime import batching as JB
from tpu_llm.runtime import engine as JE
from tpu_llm.runtime.paged_engine import PagedEngine as JPaged
from tpu_llm_torch.config import LlamaConfig as TConfig
from tpu_llm_torch.models.llama import params_from_numpy
from tpu_llm_torch.parallel.distributed import launch
from tpu_llm_torch.parallel.mesh import Mesh
from tpu_llm_torch.parallel.serving import shard_engine
from tpu_llm_torch.runtime import batching as TB
from tpu_llm_torch.runtime import engine as TE

# hidden 128: the row-parallel w2's K cut (64) stays on whole q4_0 blocks
CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96,
           seq_len=64)
REQS = [(p, n, {}) for p, n in zip(PROMPTS, N_NEW)]
SAMPLED = [([5, 11], 4, dict(temperature=0.8, seed=7)), ([3], 6, {}),
           ([9, 2], 3, dict(temperature=0.5, seed=1)), ([4, 4, 8], 5, {})]
SPEC_REQS = [([5, 11], 8, {}), ([3, 9, 2], 6, {})]


def _jax_tokens(eng, reqs):
    rs = [eng.submit(JB.Request(prompt=list(p), max_new=n, **kw)) for p, n, kw in reqs]
    eng.run()
    return [r.tokens for r in rs]


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_tp")
    out = {}
    for arch in ("qwen2", "gemma", "phi2"):
        out[arch] = str(d / f"{arch}.gguf")
        write_family(out[arch], arch)
    out["moe"] = str(d / "moe.gguf")
    build_moe(out["moe"])
    return out


@pytest.fixture(scope="module")
def cases(families):
    """name -> (the rank's case, the JAX unsharded engine's tokens)."""
    jcfg = JConfig(**CFG)
    jq, jd, jdraft = jax_params("q4_0", cfg=CFG), jax_params("dense", cfg=CFG), \
        jax_params("dense", seed=3, cfg=CFG)
    q, d, draft = to_numpy(jq), to_numpy(jd), to_numpy(jdraft)
    dense = lambda cache=None: JB.BatchEngine(  # noqa: E731
        jq, JE.ModelAdapter.llama(jcfg, bos_id=1, **({"cache_dtype": cache} if cache else {})),
        batch=4, max_seq=64)
    paged = lambda cache="f32", bs=4: JPaged(  # noqa: E731
        jq, jcfg, batch=4, n_blocks=64, block_size=bs, max_seq=64, bos_id=1,
        **({"cache_dtype": "int8"} if cache == "int8" else {}))
    out = {
        "dense_tp2": ((q, 2, 1, dict(engine="dense", batch=4, max_seq=64), REQS, None),
                      _jax_tokens(dense(), REQS)),
        "dense_tp2_dp2": ((q, 2, 2, dict(engine="dense", batch=4, max_seq=64), REQS, None),
                          _jax_tokens(dense(), REQS)),
        "dense_int8_tp2": ((q, 2, 1, dict(engine="dense", batch=4, max_seq=64,
                                          cache_dtype="int8"), REQS, None),
                           _jax_tokens(dense("int8"), REQS)),
        "paged_tp2": ((q, 2, 1, dict(engine="paged", batch=4, n_blocks=64, block_size=4,
                                     max_seq=64), REQS, None),
                      _jax_tokens(paged(), REQS)),
        "paged_tp2_dp2": ((q, 2, 2, dict(engine="paged", batch=4, n_blocks=64, block_size=4,
                                         max_seq=64), REQS, None),
                          _jax_tokens(paged(), REQS)),
        "paged_int8_tp2": ((q, 2, 1, dict(engine="paged", batch=4, n_blocks=16, block_size=32,
                                          max_seq=64, cache_dtype="int8"), REQS, None),
                           _jax_tokens(paged("int8", 32), REQS)),
        "spec_draft_tp2": ((d, 2, 1, dict(engine="dense", batch=2, max_seq=64, speculative_k=3),
                            SPEC_REQS, draft),
                           _jax_tokens(JB.BatchEngine(
                               jd, JE.ModelAdapter.llama(jcfg, bos_id=1), batch=2, max_seq=64,
                               speculative_k=3,
                               draft=(jdraft, JE.ModelAdapter.llama(jcfg, bos_id=1))),
                               SPEC_REQS)),
    }
    # the sampled streams: the port's own unsharded engine (the packages'
    # random streams differ by design)
    teng = TB.BatchEngine(params_from_numpy(q), TE.ModelAdapter.llama(TConfig(**CFG),
                                                                      device="cpu"),
                          batch=4, max_seq=64)
    trs = [teng.submit(TB.Request(prompt=list(p), max_new=n, **kw)) for p, n, kw in SAMPLED]
    teng.run()
    out["sampled_tp2_dp2"] = ((q, 2, 2, dict(engine="dense", batch=4, max_seq=64), SAMPLED,
                               None), [r.tokens for r in trs])
    fam_reqs = [([4, 7, 9], 5, {}), ([5, 8], 6, {}), ([4, 7, 3, 3], 4, {})]
    for arch, path in families.items():
        jp, jc = _jax_load(path, "f32")
        jeng = JB.BatchEngine(jp, JE.ModelAdapter.llama(jc, bos_id=1), batch=2, max_seq=32)
        out[f"{arch}_tp2"] = ((path, 2, 1, dict(engine="dense", batch=2, max_seq=32),
                               fam_reqs, None), _jax_tokens(jeng, fam_reqs))
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    spec = [(name, tree, CFG, tp, dp, kw, reqs, draft)
            for name, ((tree, tp, dp, kw, reqs, draft), _) in cases.items()]
    return launch(engine_rank, 4, spec, device="cpu", timeout=900)


@pytest.mark.parametrize("name", ["dense_tp2", "dense_tp2_dp2", "dense_int8_tp2", "paged_tp2",
                                  "paged_tp2_dp2", "paged_int8_tp2", "spec_draft_tp2",
                                  "sampled_tp2_dp2", "qwen2_tp2", "gemma_tp2", "phi2_tp2",
                                  "moe_tp2"])
def test_sharded_engine_matches_jax_unsharded(name, cases, ranks):
    (_, tp, dp, *_), want = cases[name]
    got = [r[name] for r in ranks if name in r]
    assert len(got) == tp * dp
    for tokens, stats in got:               # every rank's host loop took the same tokens
        assert tokens == want
        if name.startswith("spec"):
            assert stats["spec_forwards"] > 0


def _fake_mesh(data, model):
    return Mesh(data, model, 0, torch.device("cpu"), "gloo", ranks=list(range(data * model)))


def test_shard_engine_validates_degrees():
    params = params_from_numpy(to_numpy(jax_params("dense", cfg=CFG)))
    cfg = TConfig(**CFG)              # 2 kv heads
    mk = lambda b, **kw: TB.BatchEngine(  # noqa: E731
        params, TE.ModelAdapter.llama(cfg, device="cpu"), batch=b, max_seq=64, **kw)
    with pytest.raises(ValueError, match="n_kv_heads"):
        shard_engine(mk(4), cfg, _fake_mesh(1, 4))
    with pytest.raises(ValueError, match="dp=2 must divide engine batch=3"):
        shard_engine(mk(3), cfg, _fake_mesh(2, 2))
    draft = (params, TE.ModelAdapter.llama(cfg, device="cpu"))
    with pytest.raises(NotImplementedError, match="draft_cfg"):
        shard_engine(mk(2, speculative_k=3, draft=draft), cfg, _fake_mesh(1, 2))


def test_serve_cli_validations(tmp_path, capsys):
    from tpu_llm_torch.runtime import serve_cli

    path = str(tmp_path / "tiny.gguf")
    build(path)
    assert serve_cli.main(["-m", path, "-p", "a", "--batch", "3", "--dp", "2",
                           "--device", "cpu"]) == 1
    assert "--batch 3 must divide by --dp 2" in capsys.readouterr().err
    args = types.SimpleNamespace(cache_dtype="f32", batch=2, paged=False, draft=path, spec=3,
                                 dtype="f32", block_size=None, n_blocks=None)
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models.llama import load_model

    params, cfg = load_model(GGUFFile(path), "f32", "cpu")
    with pytest.raises(SystemExit, match="must divide the draft model's n_kv_heads=2"):
        serve_cli.make_engine(args, params, cfg, None, 64, "cpu", _fake_mesh(1, 4))


def test_llm_serve_tp2_matches_jax(tmp_path, capfd):
    """llm-serve --tp 2 (dense, then --paged) spawns its two ranks and
    prints the JAX front end's completions."""
    from tpu_llm.runtime import serve_cli as jserve
    from tpu_llm_torch.runtime import serve_cli as tserve

    path = str(tmp_path / "tiny.gguf")
    build(path)
    base = ["-m", path, "-p", "abc", "-p", "ab", "-n", "6", "--batch", "2", "--dtype", "f32",
            "--cache-dtype", "f32"]

    def run(main, argv):            # the spawned ranks write to the inherited fd 1
        capfd.readouterr()
        assert main(argv) == 0
        return [json.loads(ln)["completion"] for ln in capfd.readouterr().out.splitlines()
                if ln.startswith("{")]

    want = run(jserve.main, base)
    assert run(tserve.main, base + ["--tp", "2", "--device", "cpu"]) == want


def test_server_pieces_on_a_mesh(tmp_path):
    """llm-server's loop on the first rank broadcasts each step's plan and
    the second follows: concurrent completions give the JAX engine's
    greedy tokens, and the embeddings the unsharded port's."""
    from tpu_llm.io.gguf import GGUFFile as JGGUF
    from tpu_llm.models.llama import load_gguf as jload
    from tpu_llm.tokenizers.bpe import BPETokenizer as JTok
    from tpu_llm_torch.io.gguf import GGUFFile
    from tpu_llm_torch.models.llama import load_model
    from tpu_llm_torch.runtime.server import Embedder

    path = str(tmp_path / "tiny.gguf")
    build(path)
    prompts = ["abc", "ab ab", "c"]
    got = launch(server_rank, 2, path, ["--batch", "2", "--dtype", "f32", "--tp", "2"],
                 prompts, 5, device="cpu", timeout=300)[0]
    jg = JGGUF(path)
    jp, jc = jload(jg)
    tok = JTok.from_gguf(jg)
    eng = JB.BatchEngine(jp, JE.ModelAdapter.llama(jc, bos_id=1), batch=2, max_seq=64)
    want = _jax_tokens(eng, [(tok.encode(p), 5, {}) for p in prompts])
    assert got[0] == want
    tp, tc = load_model(GGUFFile(path), "f32", "cpu")
    emb = Embedder(tp, TE.ModelAdapter.llama(tc, device="cpu"), max_len=64)
    for vec, p in zip(got[1], prompts):
        np.testing.assert_allclose(vec, emb.embed(tok.encode(p)), atol=1e-5)
