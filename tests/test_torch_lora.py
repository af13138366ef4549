"""The port's LoRA merge (tpu_llm_torch.io.lora) against tpu_llm.io.lora on
the CPU: read_lora's deltas; apply_lora on dense f32 weights (rtol 1e-5,
tests/test_lora.py's tolerance) and on q4_0, q8_0 and Q6_K weights, whose
requantized planes equal the JAX package's bit for bit; the errors; and
`llm --lora` / `llm-serve --lora` at --dtype f32 printing the JAX front
ends' output."""

import json

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.make_tiny_gguf import build
from tests.test_lora import _write_adapter
from tests.test_torch_kquant import build_quant_gguf
from tpu_llm.io import gguf as jgg
from tpu_llm.io import lora as JL
from tpu_llm.models import llama as JM
from tpu_llm.quant.qtensor import QTensor as JQTensor
from tpu_llm_torch.io import lora as TL
from tpu_llm_torch.models import llama as TM
from tpu_llm_torch.quant.qtensor import QTensor

DIMS = {"attn_q": "q", "attn_k": "kv", "attn_v": "kv", "attn_output": "q_in",
        "ffn_gate": "f", "ffn_up": "f", "ffn_down": "f_in"}


def _targets(cfg, layers=(0, 1), output=True):
    """Every projection of ``layers`` (and output.weight): {base: (out, in)}."""
    E, KV, F, V = cfg.dim, cfg.kv_dim, cfg.hidden_dim, cfg.vocab_size
    shape = {"q": (E, E), "kv": (KV, E), "q_in": (E, E), "f": (F, E), "f_in": (E, F)}
    out = {f"blk.{i}.{n}.weight": shape[k] for i in layers for n, k in DIMS.items()}
    if output:
        out["output.weight"] = (V, E)
    return out


def test_read_lora_deltas_match_jax(tmp_path):
    path = str(tmp_path / "ad.gguf")
    _write_adapter(path, {"blk.0.attn_q.weight": (8, 16), "output.weight": (32, 16)})
    want, wa = JL.read_lora(path)
    got, ga = TL.read_lora(path)
    assert ga == wa == 16.0 and got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _plane(p):
    return p.view(torch.int16).numpy() if p.dtype == torch.bfloat16 else p.numpy()


def _jplane(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("kind", ["f32", "q4_0", "q8_0", "q6_k"])
def test_apply_lora_matches_jax(kind, tmp_path):
    """Every projection of both layers and the classifier merged: dense
    planes at rtol 1e-5, the requantized planes bit for bit."""
    base = str(tmp_path / "base.gguf")
    if kind == "q6_k":
        build_quant_gguf(base, jgg.GGML_Q6_K, gg=jgg)
    elif kind == "q8_0":
        build_quant_gguf(base, jgg.GGML_Q8_0, gg=jgg)
    else:
        build(base, quant=kind == "q4_0")
    policy = "f32" if kind == "f32" else "native"
    jp, jcfg = JM.load_gguf(base, dtype_policy=policy)
    tp, _ = TM.load_gguf(base, dtype_policy=policy, fuse=False)
    ad = str(tmp_path / "ad.gguf")
    _write_adapter(ad, _targets(jcfg), alpha=16.0)
    jm, tm = JL.apply_lora(jp, ad), TL.apply_lora(tp, ad)
    for i, lp in enumerate(tm["layers"]):
        for key, w in lp.items():
            jw = jm["layers"][key]
            if isinstance(w, QTensor):
                assert isinstance(jw, JQTensor) and w.kind == jw.kind
                for name in ("q", "scales", "mins"):
                    a, b = getattr(w, name), getattr(jw, name)
                    assert (a is None) == (b is None)
                    if a is not None:
                        np.testing.assert_array_equal(_plane(a), _jplane(b)[i], err_msg=key)
            else:
                np.testing.assert_allclose(w.numpy(), np.asarray(jw[i]), rtol=1e-5, atol=1e-6,
                                           err_msg=key)
    if kind == "f32":
        np.testing.assert_allclose(tm["wcls"].numpy(), np.asarray(jm["wcls"]), rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(_plane(tm["wcls"].q), _jplane(jm["wcls"].q))


def test_lora_errors_match_jax(tmp_path):
    base = str(tmp_path / "base.gguf")
    build(base)
    tp, cfg = TM.load_gguf(base, fuse=False)
    ad = str(tmp_path / "bad.gguf")
    _write_adapter(ad, {"blk.0.nope.weight": (8, 8)})
    with pytest.raises(ValueError, match="unsupported LoRA target"):
        TL.apply_lora(tp, ad)
    with pytest.raises(ValueError, match="no .lora_a"):
        TL.read_lora(base)
    ad2 = str(tmp_path / "ad.gguf")
    _write_adapter(ad2, {"blk.0.attn_q.weight": (cfg.dim, cfg.dim)})
    fused, _ = TM.load_gguf(base)
    with pytest.raises(ValueError, match="needs unfused params"):
        TL.apply_lora(fused, ad2)
    with pytest.raises(ValueError, match="not a LoRA adapter GGUF"):
        jgg.write_gguf(str(tmp_path / "t.gguf"), {"general.type": "model"},
                       {"a.lora_a": np.zeros((2, 4), np.float32)})
        TL.read_lora(str(tmp_path / "t.gguf"))
    half = str(tmp_path / "half.gguf")
    jgg.write_gguf(half, {"general.type": "adapter"},
                   {"blk.0.attn_q.weight.lora_a": np.zeros((2, 4), np.float32)})
    with pytest.raises(ValueError, match="incomplete LoRA pair"):
        TL.read_lora(half)


def test_llm_lora_matches_jax(tmp_path, capfdbinary):
    """`llm --lora` at --dtype f32 prints the JAX CLI's first line; the
    adapter changes it."""
    from tpu_llm.runtime import cli as jcli
    from tpu_llm_torch.runtime import cli as tcli

    base = str(tmp_path / "base.gguf")
    build(base)
    ad = str(tmp_path / "ad.gguf")
    # a large classifier delta reliably changes the greedy stream
    _write_adapter(ad, {"output.weight": (32, 64), "blk.1.ffn_down.weight": (64, 96)},
                   alpha=64.0, seed=3)
    argv = ["-m", base, "-p", "abc", "-n", "10", "--dtype", "f32"]

    def first(main, extra):
        capfdbinary.readouterr()
        assert main(argv + extra) == 0
        return capfdbinary.readouterr().out.split(b"\n")[0]

    want = first(jcli.main, ["--lora", ad])
    assert first(tcli.main, ["--lora", ad, "--device", "cpu"]) == want
    assert first(tcli.main, ["--device", "cpu"]) != want


def test_llm_serve_lora_matches_jax(tmp_path, capsys):
    from tpu_llm.runtime import serve_cli as jserve
    from tpu_llm_torch.runtime import serve_cli as tserve

    base = str(tmp_path / "base.gguf")
    build(base)
    ad = str(tmp_path / "ad.gguf")
    _write_adapter(ad, {"output.weight": (32, 64), "blk.0.attn_v.weight": (32, 64)},
                   alpha=64.0, seed=3)
    argv = ["-m", base, "-p", "abc", "-p", "ab", "-n", "5", "--batch", "2", "--dtype", "f32",
            "--cache-dtype", "f32", "--lora", ad]

    def run(main, extra):
        capsys.readouterr()
        assert main(argv + extra) == 0
        return [json.loads(ln)["completion"] for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("{")]

    assert run(tserve.main, ["--device", "cpu"]) == run(jserve.main, [])


def test_lora_refused_for_phi2(tmp_path, capsys):
    """--lora merges into the llama family only (the JAX llm-serve's
    refusal)."""
    from tests.test_torch_families import write_family
    from tpu_llm_torch.runtime import serve_cli as tserve

    path = str(tmp_path / "phi2.gguf")
    write_family(path, "phi2")
    ad = str(tmp_path / "ad.gguf")
    _write_adapter(ad, {"output.weight": (40, 64)})
    assert tserve.main(["-m", path, "-p", "a", "--lora", ad, "--device", "cpu"]) == 1
    assert "--lora supports the llama family" in capsys.readouterr().err
