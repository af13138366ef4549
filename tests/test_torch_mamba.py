"""The port's Mamba (tpu_llm_torch.models.mamba and the programs around it)
on the CPU against the JAX package, at MambaConfig(d_model=32, n_layers=2,
vocab_size=64) with tests/test_mamba.py's seeded weights:

- the packed files: write_packed's bytes equal, read_packed's arrays the
  JAX reader's (x @ W orientation), convert_hf_mamba's output file and
  --convert-tokenizer's tokenizer.bin byte-equal to JAX's;
- softplus equal to jax.nn.softplus over [-30, 60] (past the threshold of
  20 too);
- decode (T = 1) against JAX and the Fortran-step oracle
  (tests/reference_impl.ref_mamba_step) at 1e-5; the time-parallel
  prefill against JAX's parallel path and its sequential oracle at
  rtol = atol = 2e-4, with and without padding masked by ``length``, the
  state after ``length`` tokens included; forward(sequential=True) against
  JAX's at 1e-5; cast_weights' values equal to JAX's, and its forward
  within bf16's rounding (2e-2 relative) of JAX's;
- params_from_numpy over the JAX package's stacked and unstacked trees;
- Engine.generate greedy tokens equal to JAX's (step loop, graph step), a
  5-token prompt (padded to 16) equal to the unpadded sequential path
  (the ``length`` repair), BatchEngine's batch against per-request JAX
  runs with slot reuse;
- llm-ssm, llm-serve -m X.bin and the server's embeddings against the JAX
  programs."""

import json
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

import jax
import jax.numpy as jnp

from tests import reference_impl as ref
from tests.test_mamba import CFG, make_torch_arrays, oracle_cfg, to_oracle_weights
from tpu_llm.io import mamba_ckpt as JC
from tpu_llm.models import mamba as JM
from tpu_llm_torch.config import MambaConfig
from tpu_llm_torch.io import mamba_ckpt as TC
from tpu_llm_torch.models import mamba as TM

TCFG = MambaConfig(d_model=32, n_layers=2, vocab_size=64)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mamba") / "m.bin")
    JC.write_packed(path, make_torch_arrays(1), CFG)
    return path


@pytest.fixture(scope="module")
def models(packed):
    jp, jc = JC.read_packed(packed)
    tp, tc = TM.load_packed(packed)
    return jp, jc, tp, tc


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


# -- files ------------------------------------------------------------------

def test_write_packed_bytes_equal_and_read_matches(tmp_path, models):
    arrays = make_torch_arrays(2)
    a, b = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    JC.write_packed(a, arrays, CFG)
    TC.write_packed(b, arrays, TCFG)
    assert open(a, "rb").read() == open(b, "rb").read()
    jp, jc, tp, tc = models
    assert dataclass_dict(tc) == dataclass_dict(jc)
    for k in ("tok_emb", "norm_f", "wcls"):
        np.testing.assert_array_equal(_np(tp[k]), _np(jp[k]))
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == set(jp["layers"])
        for k, v in lp.items():
            np.testing.assert_array_equal(_np(v), _np(jp["layers"][k][i]))


def dataclass_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


def test_softplus_matches_jax():
    from tpu_llm_torch.ops.activations import softplus

    x = np.linspace(-30.0, 60.0, 9001, dtype=np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)
    big = np.asarray([20.0, 20.5, 25.0, 40.0, 88.0], np.float32)
    np.testing.assert_array_equal(softplus(torch.from_numpy(big)).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(big))))


def _hf_dir(tmp_path, seed=3):
    """A HF Mamba directory: config.json and a torch.save'd state dict in
    the HF names (conv1d as (d_inner, 1, d_conv), tied classifier)."""
    a = make_torch_arrays(seed)
    sd = {"backbone.embedding.weight": a["tok_emb"], "backbone.norm_f.weight": a["norm_f"]}
    for i in range(CFG.n_layers):
        p = f"backbone.layers.{i}."
        sd.update({p + "mixer.D": a["D"][i], p + "mixer.in_proj.weight": a["in_proj"][i],
                   p + "mixer.conv1d.weight": a["conv_w"][i][:, None, :],
                   p + "mixer.conv1d.bias": a["conv_b"][i],
                   p + "mixer.x_proj.weight": a["x_proj"][i],
                   p + "mixer.dt_proj.weight": a["dt_proj"][i],
                   p + "mixer.dt_proj.bias": a["dt_bias"][i], p + "mixer.A_log": a["A_log"][i],
                   p + "mixer.out_proj.weight": a["out_proj"][i],
                   p + "norm.weight": a["norm"][i]})
    d = tmp_path / "hf"
    d.mkdir()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               str(d / "pytorch_model.bin"))
    (d / "config.json").write_text(json.dumps({"d_model": CFG.d_model,
                                               "n_layer": CFG.n_layers}))
    return str(d)


# a byte-level BPE tokenizer.json: 62 single characters (GPT-2's byte
# strings: "Ġ" is the space), two merges, one special added token
_CHARS = [chr(c) for c in range(ord("a"), ord("z") + 1)] + \
    [chr(c) for c in range(ord("A"), ord("Z") + 1)] + list("0123456") + ["Ġ", "Ċ", "."]


def write_tokenizer_json(path):
    vocab = {c: i for i, c in enumerate(_CHARS)}
    vocab["ab"], vocab["Ġa"] = len(vocab), len(vocab) + 1
    added = [{"id": 63, "content": "<|endoftext|>", "special": True}]
    with open(path, "w") as f:
        json.dump({"model": {"vocab": vocab, "merges": ["a b", "Ġ a"]},
                   "added_tokens": added}, f)


def test_convert_and_convert_tokenizer_byte_equal(tmp_path, capsys):
    from tpu_llm.runtime import mamba_cli as jcli
    from tpu_llm_torch.runtime import mamba_cli as tcli

    hf = _hf_dir(tmp_path)
    tj = str(tmp_path / "tokenizer.json")
    write_tokenizer_json(tj)
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        m, t = str(tmp_path / f"{name}.bin"), str(tmp_path / f"{name}_tok.bin")
        capsys.readouterr()
        assert main(["--convert", hf, "-m", m]) == 0
        assert main(["--convert-tokenizer", tj, "-s", t]) == 0
        outs[name] = (open(m, "rb").read(), open(t, "rb").read(),
                      capsys.readouterr().out.replace(name, ""))
    assert outs["jax"] == outs["port"]


# -- the model ----------------------------------------------------------------

def test_decode_matches_jax_and_fortran_oracle(models):
    """Five decode steps (T = 1) from a zero state: logits against JAX's
    and the Fortran-step oracle's at 1e-5."""
    jp, jc, tp, tc = models
    ow, ocfg = to_oracle_weights(make_torch_arrays(1)), oracle_cfg()
    conv = np.zeros((CFG.n_layers, CFG.d_conv, CFG.d_inner), np.float32)
    ssm = np.zeros((CFG.n_layers, CFG.d_state, CFG.d_inner), np.float32)
    js, ts = JM.init_state(jc, 1), TM.init_state(tc, 1)
    for tok in (5, 17, 40, 2, 63):
        want, _ = ref.ref_mamba_step(tok, None, ow, ocfg, conv, ssm)
        jh, js = JM.forward(jp, jc, jnp.asarray([[tok]]), js)
        th, ts2 = TM.forward(tp, tc, torch.tensor([[tok]]), ts)
        assert ts2 is ts                                    # state written in place
        got = TM.lm_head(tp, tc, th)[0, 0].numpy()
        np.testing.assert_allclose(got, np.asarray(JM.lm_head(jp, jc, jh))[0, 0], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(np.stack([_np(s[0]) for s in ts[k]]),
                                   np.asarray(js[k])[:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T,length", [(13, 13), (16, 5), (16, 16), (33, 20)],
                         ids=["T13", "pad16_len5", "T16", "pad33_len20"])
def test_parallel_prefill_matches_jax(models, T, length):
    """The doubling scan against JAX's associative_scan path and its
    sequential oracle (rtol = atol = 2e-4), from a nonzero incoming state
    (a decode step first), batch 2: the real rows' hidden states and the
    state after ``length`` tokens."""
    jp, jc, tp, tc = models
    toks = np.random.default_rng(T + length).integers(0, 64, (2, T))
    js, ts = JM.init_state(jc, 2), TM.init_state(tc, 2)
    _, js = JM.forward(jp, jc, jnp.asarray([[3], [9]]), js)
    TM.forward(tp, tc, torch.tensor([[3], [9]]), ts)
    jh, jst = JM.forward(jp, jc, jnp.asarray(toks), js, length=length)
    jhs, jsts = JM.forward(jp, jc, jnp.asarray(toks), js, length=length, sequential=True)
    th, tst = TM.forward(tp, tc, torch.from_numpy(toks), ts, length=length)
    for want_h, want_s in ((jh, jst), (jhs, jsts)):
        np.testing.assert_allclose(th.numpy()[:, :length], np.asarray(want_h)[:, :length],
                                   rtol=2e-4, atol=2e-4)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(np.stack([_np(s) for s in tst[k]]),
                                       np.asarray(want_s[k]), rtol=2e-4, atol=2e-4)


def test_sequential_matches_jax(models):
    jp, jc, tp, tc = models
    toks = np.random.default_rng(4).integers(0, 64, (1, 9))
    jh, jst = JM.forward(jp, jc, jnp.asarray(toks), JM.init_state(jc, 1), length=6,
                         sequential=True)
    th, tst = TM.forward(tp, tc, torch.from_numpy(toks), TM.init_state(tc, 1), length=6,
                         sequential=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(np.stack([_np(s) for s in tst[k]]), np.asarray(jst[k]),
                                   rtol=1e-5, atol=1e-6)


def test_cast_weights(models):
    """Every value is JAX's cast value; the projections, embedding and
    classifier are stored bf16, the rest f32; a prefill and a decode step
    agree with JAX's bf16 model within bf16 rounding (2e-2 relative to
    the largest logit)."""
    jp, jc, tp, tc = models
    # the JAX package runs bf16 weights unstacked (its llm-ssm does)
    jb, tb = JM.unstack_layers(JM.cast_weights(jp)), TM.cast_weights(tp)
    for k in ("tok_emb", "norm_f", "wcls"):
        np.testing.assert_array_equal(_np(tb[k].float()), _np(jb[k].astype(jnp.float32)))
    for lp, jl in zip(tb["layers"], jb["layers"]):
        for k, v in lp.items():
            assert v.dtype == (torch.bfloat16 if k in TM._MATRICES else torch.float32)
            np.testing.assert_array_equal(_np(v.float()), _np(jl[k].astype(jnp.float32)))
    toks = np.random.default_rng(5).integers(0, 64, (1, 7))
    jh, js = JM.forward(jb, jc, jnp.asarray(toks), JM.init_state(jc, 1, stacked=False))
    th, ts = TM.forward(tb, tc, torch.from_numpy(toks), TM.init_state(tc, 1))
    jh, _ = JM.forward(jb, jc, jnp.asarray([[7]]), js)
    th, _ = TM.forward(tb, tc, torch.tensor([[7]]), ts)
    want = np.asarray(JM.lm_head(jb, jc, jh))
    got = TM.lm_head(tb, tc, th).numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_params_from_numpy(models, stacked):
    jp, jc, tp, tc = models
    tree = jp if stacked else JM.unstack_layers(jp)
    carried = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    for k in ("tok_emb", "norm_f", "wcls"):
        assert torch.equal(carried[k], tp[k])
    for a, b in zip(carried["layers"], tp["layers"]):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    bf = TM.params_from_numpy(jax.tree_util.tree_map(np.asarray, JM.cast_weights(tree)))
    cast = TM.cast_weights(tp)
    assert bf["wcls"].dtype == torch.bfloat16 and torch.equal(bf["wcls"], cast["wcls"])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(bf["layers"], cast["layers"])
               for k in a)


# -- the engines --------------------------------------------------------------

def _engines(models):
    from tpu_llm.runtime.engine import Engine as JEngine, ModelAdapter as JAdapter
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    jp, jc, tp, tc = models
    return (JEngine(jp, JAdapter.mamba(jc), max_seq=48),
            Engine(tp, ModelAdapter.mamba(tc, "cpu"), max_seq=48, device="cpu"))


@pytest.mark.parametrize("use_scan", [False, True], ids=["step_loop", "graph_step"])
def test_engine_greedy_tokens_match_jax(models, use_scan):
    """Greedy tokens of Engine.generate (a 21-token prompt: bucket 32)
    equal JAX's; the graph step (eager on the CPU, over the static state)
    twice, so the second run starts from a dirty static state."""
    jeng, teng = _engines(models)
    prompt = [int(t) for t in np.random.default_rng(6).integers(0, 64, 21)]
    want = jeng.generate(prompt, n_total=40, add_bos=False).tokens
    for _ in range(2 if use_scan else 1):
        got = teng.generate(prompt, n_total=40, add_bos=False, use_scan=use_scan)
        assert got.tokens == want
    if use_scan:
        assert teng._graph_params()["layers"][0]["in_proj"] is \
            teng.params["layers"][0]["in_proj"]           # dense leaves pass through


def test_padded_prompt_matches_unpadded_sequential_path(tmp_path):
    """A 5-token prompt is padded to the 16-token bucket: its greedy tokens
    equal the unpadded sequential path's (teacher-forced one token at a
    time, then fed back). Without ``length`` the state would advance
    through the 11 padding tokens. The weights have a long memory (A =
    -0.02, so dA ~ 0.99 a step) and projections 3x the others', so such a
    state changes the tokens (14 of the 15 here); with the short memory of
    the other tests' weights the padding decays before it shows."""
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    arrays = make_torch_arrays(1)
    arrays["A_log"][:] = np.log(0.02)
    for k in ("in_proj", "x_proj", "out_proj", "tok_emb", "wcls"):
        arrays[k] *= 3.0
    TC.write_packed(str(tmp_path / "m.bin"), arrays, TCFG)
    tp, tc = TM.load_packed(str(tmp_path / "m.bin"))
    prompt = [54, 41, 33, 17, 20]
    eng = Engine(tp, ModelAdapter.mamba(tc, "cpu"), max_seq=48, device="cpu")
    got = eng.generate(prompt, n_total=20, add_bos=False).tokens
    state = TM.init_state(tc, 1)
    h, _ = TM.forward(tp, tc, torch.tensor([prompt]), state, sequential=True)
    want = list(prompt)
    nxt = int(TM.lm_head(tp, tc, h[:, -1:]).argmax())
    while len(want) < 20:
        want.append(nxt)
        h, _ = TM.forward(tp, tc, torch.tensor([[nxt]]), state)
        nxt = int(TM.lm_head(tp, tc, h).argmax())
    assert got == want


def test_batch_engine_matches_per_request_jax(models):
    """Batch 2 over 5 requests (slots reused, prompts of 3-23 tokens): each
    request's tokens equal a single-stream JAX Engine run, and a reused
    slot starts from a zeroed state."""
    from tpu_llm.runtime.engine import Engine as JEngine, ModelAdapter as JAdapter
    from tpu_llm_torch.runtime.batching import BatchEngine, Request
    from tpu_llm_torch.runtime.engine import ModelAdapter

    jp, jc, tp, tc = models
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(0, 64, n)] for n in (3, 23, 9, 5, 17)]
    eng = BatchEngine(tp, ModelAdapter.mamba(tc, "cpu"), batch=2, max_seq=64, eos_id=-1,
                      speculative_k=3)
    assert eng.spec_k == 0                        # recurrent: no speculation
    reqs = [eng.submit(Request(prompt=p, max_new=6)) for p in prompts]
    eng.run()
    jeng = JEngine(jp, JAdapter.mamba(jc), max_seq=64)
    for p, r in zip(prompts, reqs):
        want = jeng.generate(p, n_new=6, add_bos=False).tokens[len(p):]
        assert r.tokens == want


# -- the programs -------------------------------------------------------------

@pytest.fixture(scope="module")
def tok_bin(tmp_path_factory):
    from tpu_llm_torch.tokenizers.bpe import BPETokenizer
    from tpu_llm_torch.tokenizers.tokenizer_bin import write_tokenizer_bin

    d = tmp_path_factory.mktemp("tok")
    write_tokenizer_json(str(d / "tokenizer.json"))
    tok = BPETokenizer.from_hf_tokenizer_json(str(d / "tokenizer.json"))
    write_tokenizer_bin(str(d / "tokenizer.bin"), tok.tokens, tok.scores)
    return str(d / "tokenizer.bin")


@pytest.mark.parametrize("extra", [[], ["--scan"], ["--dtype", "bf16"],
                                   ["-t", "0.8", "--seed", "3"]],
                         ids=["greedy", "scan", "bf16", "sampled"])
def test_llm_ssm_matches_jax(packed, tok_bin, extra, capfdbinary, monkeypatch):
    """llm-ssm --device cpu streams the JAX CLI's text (greedy, --scan and
    bf16 greedy; a sampled run only keeps the contract: its draws come
    from another generator), then a blank line and the timing lines."""
    from tpu_llm.runtime import mamba_cli as jcli
    from tpu_llm_torch.runtime import mamba_cli as tcli

    monkeypatch.setenv("TPU_LLM_NO_COMPILE_CACHE", "1")
    args = ["-m", packed, "-s", tok_bin, "-p", "abc ab", "-n", "24"] + extra
    capfdbinary.readouterr()
    assert jcli.main(args) == 0
    want = capfdbinary.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = capfdbinary.readouterr().out
    # the streamed text (its tokens may hold newlines), then the report
    text, _, report = got.partition(b"\n Inference time:")
    assert text.startswith(b"abc ab") and len(text) > 6 and report
    if "-t" not in extra:
        assert text == want.partition(b"\n Inference time:")[0]
    lines = report.decode().splitlines()
    assert "tokens/second (decode)" in lines[1] and lines[2].startswith(" TTFT:")


def test_llm_ssm_refusals(packed, tok_bin, capsys):
    from tpu_llm_torch.runtime import mamba_cli as tcli

    assert tcli.main(["-m", packed, "-s", tok_bin, "-p", "", "--device", "cpu"]) == 1
    assert "empty prompt" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert tcli.main(["-m", packed, "-s", tok_bin, "-p", "abc"]) == 1
        assert "--device cpu" in capsys.readouterr().err


def _serve(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, [json.loads(ln) for ln in cap.out.splitlines() if ln.startswith("{")], cap.err


def test_llm_serve_mamba_matches_jax(packed, tok_bin, capsys, monkeypatch):
    """llm-serve -m X.bin: the dense engine's completions equal JAX's;
    --paged and --draft exit 1 with JAX's reasons."""
    from tpu_llm.runtime import serve_cli as jcli
    from tpu_llm_torch.runtime import serve_cli as tcli

    monkeypatch.setenv("TPU_LLM_NO_COMPILE_CACHE", "1")
    argv = ["-m", packed, "-s", tok_bin, "-p", "abc", "-p", "ab Ab", "-p", "Zz aab",
            "-n", "6", "--batch", "2"]
    rc, want, _ = _serve(jcli.main, argv, capsys)
    assert rc == 0
    rc, got, _ = _serve(tcli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0
    assert [(r["completion"], r["n_tokens"]) for r in got] == \
        [(r["completion"], r["n_tokens"]) for r in want]
    for flag, why in ((["--paged"], "KV-cache"), (["--draft", packed], "llama-family")):
        rc, rows, err = _serve(tcli.main, argv + flag + ["--device", "cpu"], capsys)
        assert rc == 1 and not rows and why in err


def test_server_embeddings_through_mamba_adapter(models):
    """The server's Embedder over ModelAdapter.mamba equals the JAX
    package's over its Mamba adapter (1e-5), a 5-token input padded to 16."""
    from tpu_llm.runtime.engine import ModelAdapter as JAdapter
    from tpu_llm.runtime.server import Embedder as JEmbedder
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.server import Embedder

    jp, jc, tp, tc = models
    ids = [4, 19, 2, 50, 7]
    want = np.asarray(JEmbedder(jp, JAdapter.mamba(jc)).embed(ids))
    got = Embedder(tp, ModelAdapter.mamba(tc, "cpu")).embed(ids)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=1e-5, atol=1e-5)


def test_bin_route_needs_no_gguf(packed, tok_bin):
    """serve_cli routes a .bin to the packed reader (no GGUF parse)."""
    import argparse

    from tpu_llm_torch.runtime import serve_cli as tcli

    args = argparse.Namespace(model=packed, tokenizer=tok_bin, dtype="native")
    params, cfg, tok = tcli._load(args, torch.device("cpu"))
    assert isinstance(cfg, MambaConfig) and len(params["layers"]) == cfg.n_layers
    assert tok.vocab_size == 64 and os.path.exists(packed)
