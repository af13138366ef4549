"""The port's checkpoint tools on the CPU against the JAX package, on the
tiny GGUFs of tests/make_tiny_gguf.py (f32 and Q4_0):

- ``write_ak`` (llm-load -o) and llm-load -t's tokenizer.bin byte-equal to
  JAX's; ``llm --ak -s tok.bin`` prints the port's GGUF first line and the
  JAX CLI's --ak first line;
- the ``.npz`` weight cache both ways: a JAX-written cache (stacked
  layers, fused and unfused, f32 and native Q4_0) runs in the port's
  ``llm -m X.npz`` with the port's GGUF tokens; a port-written cache (the
  per-layer list) loads in the JAX package's ``llm -m X.npz`` with JAX's
  GGUF tokens, and back in the port (fused, as the GGUF loader makes it)
  with every plane and dtype equal;
- a 2-shard gguf-split file equal, tensor for tensor, to the single file
  (and read alike by the JAX reader), plus the JAX reader's error cases;
- ``compute_ppl`` within rel 1e-4 of JAX's (f32; a llama GGUF, a short
  last window masked by ``length``, and Mamba); ``dtype_table``'s f32 /
  q8_0 / q4_0 rows against JAX's: f32 at ppl rel 1e-4 and logit deltas
  1e-4 abs; the quantized rows run the native policy's bf16 activations
  in both packages, so ppl rel 2e-3 and logit deltas 5e-3 abs;
  ``eval_stream`` equal; the ``llm-ppl`` line equal to JAX's."""

import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.make_tiny_gguf import build
from tpu_llm.runtime import cli as jcli
from tpu_llm.runtime import convert_cli as jconv
from tpu_llm_torch.io import gguf as tgg
from tpu_llm_torch.runtime import cli as tcli
from tpu_llm_torch.runtime import convert_cli as tconv


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    out = {}
    for name, quant in (("f32", False), ("q4_0", True)):
        out[name] = str(d / f"{name}.gguf")
        build(out[name], quant=quant)
    return out


def _first_line(main, args, capfdbinary):
    capfdbinary.readouterr()
    assert main(args) == 0
    return capfdbinary.readouterr().out.split(b"\n")[0]


PROMPT = ["-p", "abc", "-n", "12"]


# -- ak and tokenizer.bin -------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "q4_0"])
def test_llm_load_files_byte_equal(ggufs, kind, tmp_path, capsys):
    files = {}
    for name, main in (("jax", jconv.main), ("port", tconv.main)):
        ak, tok = str(tmp_path / f"{name}.ak"), str(tmp_path / f"{name}.tok")
        assert main(["-i", ggufs[kind], "-o", ak, "-t", tok]) == 0
        files[name] = (open(ak, "rb").read(), open(tok, "rb").read())
    assert files["jax"] == files["port"] and len(files["port"][0]) > 28
    assert tconv.main(["-i", ggufs[kind]]) == 1          # nothing to do
    assert "nothing to do" in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["f32", "q4_0"])
def test_llm_ak_matches_gguf_and_jax(ggufs, kind, tmp_path, capfdbinary):
    ak, tok = str(tmp_path / "m.ak"), str(tmp_path / "tok.bin")
    assert tconv.main(["-i", ggufs[kind], "-o", ak, "-t", tok]) == 0
    got = _first_line(tcli.main, ["-m", ak, "--ak", "-s", tok, *PROMPT, "--device", "cpu"],
                      capfdbinary)
    gguf_line = _first_line(tcli.main, ["-m", ggufs[kind], *PROMPT, "--dtype", "f32",
                                        "--device", "cpu"], capfdbinary)
    jax_line = _first_line(jcli.main, ["-m", ak, "--ak", "-s", tok, *PROMPT], capfdbinary)
    assert got == gguf_line == jax_line and got.startswith(b"abc") and len(got) > 3


def test_ak_needs_a_tokenizer_and_a_card(ggufs, tmp_path, capsys):
    ak = str(tmp_path / "m.ak")
    assert tconv.main(["-i", ggufs["f32"], "-o", ak]) == 0
    assert tcli.main(["-m", ak, "--ak", *PROMPT, "--device", "cpu"]) == 1
    assert "tokenizer" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert tcli.main(["-m", ak, "--ak", *PROMPT]) == 1
        assert "--device cpu" in capsys.readouterr().err


def test_load_ak_tree(ggufs, tmp_path):
    """load_ak: the header honoured, a negative vocab an untied classifier,
    fused projections, bf16 weights with f32 norms under the bf16 policy."""
    from tpu_llm_torch.io.ak import load_ak
    from tpu_llm_torch.models.llama import load_gguf

    ak = str(tmp_path / "m.ak")
    assert tconv.main(["-i", ggufs["f32"], "-o", ak]) == 0
    params, cfg = load_ak(ak)
    ref, rcfg = load_gguf(ggufs["f32"])
    assert cfg.dim == rcfg.dim and cfg.n_kv_heads == rcfg.n_kv_heads
    assert not cfg.tie_embeddings and params["wcls"] is not None
    for k in ("wqkv", "wo", "w13", "w2", "attn_norm"):
        assert torch.equal(params["layers"][1][k], ref["layers"][1][k]), k
    bf, _ = load_ak(ak, "bf16")
    assert bf["layers"][0]["wqkv"].dtype == torch.bfloat16
    assert bf["layers"][0]["attn_norm"].dtype == torch.float32


# -- the .npz weight cache -------------------------------------------------------

@pytest.mark.parametrize("dtype,fuse", [("f32", False), ("f32", True), ("native", False),
                                        ("native", True)],
                         ids=["f32", "f32_fused", "native", "native_fused"])
def test_jax_written_cache_runs_in_the_port(ggufs, dtype, fuse, tmp_path, capfdbinary):
    src = ggufs["f32" if dtype == "f32" else "q4_0"]
    npz, tok = str(tmp_path / "c.npz"), str(tmp_path / "tok.bin")
    assert jconv.main(["-i", src, "--cache-out", npz, "-t", tok, "--dtype", dtype]
                      + (["--fuse"] if fuse else [])) == 0
    got = _first_line(tcli.main, ["-m", npz, "-s", tok, *PROMPT, "--device", "cpu"],
                      capfdbinary)
    want = _first_line(tcli.main, ["-m", src, *PROMPT, "--dtype", dtype, "--device", "cpu"],
                       capfdbinary)
    assert got == want and len(got) > 3


@pytest.mark.parametrize("dtype", ["f32", "bf16", "native"])
def test_port_written_cache_loads_in_both(ggufs, dtype, tmp_path, capfdbinary):
    from tpu_llm.io.weight_cache import load_weight_cache as jload
    from tpu_llm_torch.io.weight_cache import load_weight_cache
    from tpu_llm_torch.models.llama import load_gguf
    from tpu_llm_torch.quant.qtensor import QTensor

    src = ggufs["f32" if dtype != "native" else "q4_0"]
    npz, tok = str(tmp_path / "c.npz"), str(tmp_path / "tok.bin")
    assert tconv.main(["-i", src, "--cache-out", npz, "-t", tok, "--dtype", dtype]) == 0
    ref, rcfg = load_gguf(src, dtype_policy=dtype)       # fused, as the cache loads
    got, cfg = load_weight_cache(npz)
    assert cfg == rcfg and isinstance(got["layers"], list)

    def same(a, b):
        if isinstance(a, QTensor):
            return a.kind == b.kind and same(a.q, b.q) and same(a.scales, b.scales)
        return (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))

    for k in ("tok_emb", "final_norm", "wcls"):
        assert same(got[k], ref[k]), k
    assert all(same(lp[k], rp[k]) for lp, rp in zip(got["layers"], ref["layers"]) for k in rp)
    jparams, jcfg = jload(npz)
    assert jcfg.dim == cfg.dim and isinstance(jparams["layers"], list)
    # the JAX CLI on the port's cache (its list of layers) prints its own
    # GGUF path's line
    want = _first_line(jcli.main, ["-m", src, *PROMPT, "--dtype", dtype], capfdbinary)
    assert _first_line(jcli.main, ["-m", npz, "-s", tok, *PROMPT], capfdbinary) == want


# -- gguf-split -------------------------------------------------------------------

def test_split_gguf_equals_single_file(ggufs, tmp_path):
    from tpu_llm.io import gguf as jgg

    whole = tgg.GGUFFile(ggufs["q4_0"])
    paths = tgg.write_gguf_split(whole, str(tmp_path / "m"), 2)
    assert [os.path.basename(p) for p in paths] == ["m-00001-of-00002.gguf",
                                                    "m-00002-of-00002.gguf"]
    for reader in (tgg.GGUFFile, jgg.GGUFFile):
        merged = reader(paths[0])
        assert list(merged.tensors) == list(whole.tensors)
        for n, t in whole.tensors.items():
            m = merged.tensors[n]
            assert (m.dims, m.ggml_type) == (t.dims, t.ggml_type)
            assert bytes(merged.raw(n)) == bytes(whole.raw(n)), n
        assert merged.metadata["tokenizer.ggml.tokens"] == whole.metadata[
            "tokenizer.ggml.tokens"]


def test_split_gguf_errors(ggufs, tmp_path):
    """The JAX reader's errors: a split file not named -NNNNN-of-NNNNN, a
    shard other than 00001, a name that disagrees with split.count, and a
    missing shard."""
    whole = tgg.GGUFFile(ggufs["f32"])
    paths = tgg.write_gguf_split(whole, str(tmp_path / "m"), 2)
    bad = str(tmp_path / "renamed.gguf")
    os.link(paths[0], bad)
    with pytest.raises(ValueError, match="shard convention"):
        tgg.GGUFFile(bad)
    with pytest.raises(ValueError, match="open shard 00001"):
        tgg.GGUFFile(paths[1])
    three = str(tmp_path / "m-00001-of-00003.gguf")
    os.link(paths[0], three)
    with pytest.raises(ValueError, match="filename says 3 shards"):
        tgg.GGUFFile(three)
    os.remove(paths[1])
    with pytest.raises(FileNotFoundError, match="missing GGUF shard"):
        tgg.GGUFFile(paths[0])


# -- perplexity ---------------------------------------------------------------------

@pytest.mark.parametrize("n,window", [(200, 64), (100, 128)], ids=["windows", "one_short"])
def test_compute_ppl_matches_jax(ggufs, n, window):
    from tpu_llm.models.llama import load_gguf as jload
    from tpu_llm.runtime.engine import ModelAdapter as JAdapter
    from tpu_llm.runtime.perplexity import compute_ppl as jppl, eval_stream as jstream
    from tpu_llm_torch.models.llama import load_gguf
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.perplexity import compute_ppl, eval_stream

    ids = eval_stream(n, vocab=32)
    assert ids == jstream(n, vocab=32)
    jp, jc = jload(ggufs["f32"], dtype_policy="f32")
    want = jppl(jp, JAdapter.llama(jc), ids, window=window)
    tp, tc = load_gguf(ggufs["f32"])
    got = compute_ppl(tp, ModelAdapter.llama(tc, device="cpu"), ids, window=window,
                      device="cpu")
    assert got.n_tokens == want.n_tokens
    np.testing.assert_allclose(got.ppl, want.ppl, rtol=1e-4)


def test_compute_ppl_mamba_matches_jax(tmp_path):
    """A recurrent model: the short last window's padding masked by
    ``length``."""
    from tests.test_mamba import CFG, make_torch_arrays
    from tpu_llm.io.mamba_ckpt import read_packed, write_packed
    from tpu_llm.runtime.engine import ModelAdapter as JAdapter
    from tpu_llm.runtime.perplexity import compute_ppl as jppl
    from tpu_llm_torch.models.mamba import load_packed
    from tpu_llm_torch.runtime.engine import ModelAdapter
    from tpu_llm_torch.runtime.perplexity import compute_ppl, eval_stream

    path = str(tmp_path / "m.bin")
    write_packed(path, make_torch_arrays(2), CFG)
    ids = eval_stream(90, vocab=64)
    jp, jc = read_packed(path)
    want = jppl(jp, JAdapter.mamba(jc), ids, window=32)
    tp, tc = load_packed(path)
    got = compute_ppl(tp, ModelAdapter.mamba(tc, "cpu"), ids, window=32, device="cpu")
    assert got.n_tokens == want.n_tokens
    np.testing.assert_allclose(got.ppl, want.ppl, rtol=1e-4)


def test_dtype_table_matches_jax(ggufs):
    from tpu_llm.runtime.perplexity import dtype_table as jtable
    from tpu_llm_torch.runtime.perplexity import dtype_table, eval_stream, format_table

    ids = eval_stream(150, vocab=32)
    fmts = ("f32", "q8_0", "q4_0")
    want = jtable(ggufs["f32"], ids, window=64, formats=fmts)
    got = dtype_table(ggufs["f32"], ids, window=64, formats=fmts, device="cpu")
    assert [r["format"] for r in got] == list(fmts)
    # f32: rel 1e-4; the quantized rows run the native policy's bf16
    # activations, rounded differently by K1's plain twin and by XLA: ppl
    # rel 2e-3, logit deltas 5e-3 abs (bf16's rounding of logits near 1)
    for g, w in zip(got, want):
        q = g["format"] != "f32"
        assert g["n_tokens"] == w["n_tokens"]
        np.testing.assert_allclose(g["ppl"], w["ppl"], rtol=2e-3 if q else 1e-4)
        for k in ("logit_max_abs_delta", "logit_mean_abs_delta"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-3 if q else 1e-4)
        # a difference of two ppls: within the ppl tolerance of the row
        np.testing.assert_allclose(g["ppl_delta_vs_f32"], w["ppl_delta_vs_f32"],
                                   rtol=0, atol=(2e-3 if q else 1e-4) * w["ppl"])
    assert got[2]["logit_max_abs_delta"] > got[1]["logit_max_abs_delta"] > 0
    assert format_table(got).count("\n") == 4
    with pytest.raises(ValueError, match="FIRST row"):
        dtype_table(ggufs["f32"], ids, formats=("q4_0",), device="cpu")


def test_llm_ppl_line_matches_jax(ggufs, tmp_path, capsys):
    from tpu_llm.runtime import perplexity as jp
    from tpu_llm_torch.runtime import perplexity as tp

    text = tmp_path / "t.txt"
    text.write_text("abc ab abc bc a b c abc " * 8)
    args = ["-m", ggufs["f32"], "-f", str(text), "--window", "32"]
    capsys.readouterr()
    assert jp.main(args) == 0
    want = capsys.readouterr().out
    assert tp.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.startswith("ppl = ")
    if not torch.cuda.is_available():
        assert tp.main(args) == 1
