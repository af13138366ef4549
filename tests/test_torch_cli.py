"""The port's CLI (run on the CPU) prints byte-identical greedy output to
tpu_llm.runtime.cli on the tiny test GGUFs (f32, Q4_0, and K-quant and
legacy-quant files), with and without --fold-norms, and with --scan,
--spec, --spec --draft and --scan --spec, and over the int8 cache
(--cache-dtype int8); --timings prints the five buckets, --profile DIR
writes a trace."""

import pytest

from tests.make_tiny_gguf import build as build_tiny_gguf
from tpu_llm.runtime import cli as jcli
from tpu_llm_torch.runtime import cli as tcli


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q4_0"])
def test_greedy_output_byte_identical(tmp_path, capfdbinary, quant):
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=quant)
    capfdbinary.readouterr()
    args = ["-m", path, "-p", "abc", "-n", "12", "--dtype", "f32"]
    assert jcli.main(args) == 0
    want = capfdbinary.readouterr().out
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = capfdbinary.readouterr().out
    assert got.split(b"\n")[0] == want.split(b"\n")[0]
    assert got.startswith(b"abc") and len(got.split(b"\n")[0]) > 3
    # the rest of the output contract: blank-line-separated timing report
    lines = got.decode().splitlines()
    assert lines[1].startswith(" Inference time:")
    assert "tokens/second" in lines[2] and lines[3].startswith(" TTFT:")


def test_sampled_output_reproducible_per_seed(tmp_path, capfdbinary):
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path)
    capfdbinary.readouterr()
    args = ["-m", path, "-p", "abc", "-n", "16", "-t", "0.9", "--seed", "42",
            "--device", "cpu"]
    outs = []
    for _ in range(2):
        assert tcli.main(args) == 0
        outs.append(capfdbinary.readouterr().out.split(b"\n")[0])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("flag", [["--top-k", "5"], ["--top-p", "0.9"], ["--min-p", "0.1"]],
                         ids=["top-k", "top-p", "min-p"])
def test_flags_outside_the_slice_are_refused(flag):
    """The sampling filters stay refused (argparse exits 2)."""
    with pytest.raises(SystemExit) as e:
        tcli.build_parser().parse_args(["-m", "x.gguf", *flag])
    assert e.value.code == 2


@pytest.mark.parametrize("flag,attr,value", [(["--scan"], "scan", True),
                                             (["--spec", "2"], "spec", 2),
                                             (["--cache-dtype", "int8"], "cache_dtype", "int8"),
                                             (["--profile", "x"], "profile", "x")],
                         ids=["scan", "spec", "cache-dtype-int8", "profile"])
def test_slice_flags_parse(flag, attr, value):
    """--scan and --spec parse since the --scan slice, --cache-dtype int8
    and --profile since the dense int8 slice."""
    args = tcli.build_parser().parse_args(["-m", "x.gguf", *flag])
    assert getattr(args, attr) == value


def _first_lines(capfdbinary, args, port_flags=()):
    capfdbinary.readouterr()
    assert jcli.main(args) == 0
    want = capfdbinary.readouterr().out.split(b"\n")[0]
    assert tcli.main(args + list(port_flags) + ["--device", "cpu"]) == 0
    got = capfdbinary.readouterr().out.split(b"\n")[0]
    return got, want


@pytest.mark.parametrize("ttype", ["Q4_K", "Q6_K", "Q5_0"])
def test_quant_gguf_greedy_output_matches_jax(tmp_path, capfdbinary, ttype):
    from tests.test_torch_kquant import build_quant_gguf
    from tpu_llm_torch.io import gguf as tgg

    path = str(tmp_path / "q.gguf")
    build_quant_gguf(path, getattr(tgg, f"GGML_{ttype}"))
    got, want = _first_lines(capfdbinary, ["-m", path, "-p", "abc", "-n", "12",
                                           "--dtype", "f32"])
    assert got == want and got.startswith(b"abc") and len(got) > 3


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q4_0"])
def test_fold_norms_matches_jax(tmp_path, capfdbinary, quant):
    """With dense weights (--dtype f32) the fold is exact up to f32
    rounding, so --fold-norms keeps the JAX CLI's greedy text. (The JAX
    CLI's own --fold-norms stops in unstack_layers on the None norms it
    leaves, so the comparison is with its unfolded run.)"""
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=quant)
    got, want = _first_lines(capfdbinary, ["-m", path, "-p", "abc", "-n", "12",
                                           "--dtype", "f32"], ["--fold-norms"])
    assert got == want and got.startswith(b"abc") and len(got) > 3


def test_fold_norms_native_kquant_runs(tmp_path, capfdbinary):
    """--fold-norms over native K-quant weights requantizes them (q4_1
    planes from Q4_K, q6_k) and decodes."""
    from tests.test_torch_kquant import build_quant_gguf
    from tpu_llm_torch.io import gguf as tgg

    path = str(tmp_path / "q.gguf")
    build_quant_gguf(path, tgg.GGML_Q4_K)
    capfdbinary.readouterr()
    assert tcli.main(["-m", path, "-p", "abc", "-n", "12", "--dtype", "native",
                      "--fold-norms", "--device", "cpu"]) == 0
    out = capfdbinary.readouterr().out
    assert out.startswith(b"abc") and len(out.split(b"\n")[0]) > 3


@pytest.mark.parametrize("flags", [["--scan"], ["--spec", "3"], ["--spec", "3", "--draft", None],
                                   ["--scan", "--spec", "3"]],
                         ids=["scan", "spec", "spec_draft", "scan_spec"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q4_0"])
def test_scan_and_spec_match_jax(tmp_path, capfdbinary, quant, flags):
    """The graph loop (eager on the CPU) and every speculative mode print
    the JAX CLI's first line; --draft takes the same file."""
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=quant)
    flags = [path if f is None else f for f in flags]         # --draft: the same file
    got, want = _first_lines(capfdbinary, ["-m", path, "-p", "abc", "-n", "12",
                                           "--dtype", "f32", *flags])
    assert got == want and got.startswith(b"abc") and len(got) > 3


def test_timings_prints_the_five_buckets(tmp_path, capfdbinary):
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=True)
    capfdbinary.readouterr()
    assert tcli.main(["-m", path, "-p", "abc", "-n", "8", "--dtype", "f32", "--timings",
                      "--device", "cpu"]) == 0
    lines = capfdbinary.readouterr().out.decode().splitlines()
    at = lines.index(" Timings (ms/token, per-phase on-device)")
    rows = lines[at + 1:at + 6]
    assert [r.split()[1] for r in rows] == ["qkv", "rope", "attention", "ffn", "classifier"]
    assert all(float(r.split()[2]) == float(r.split()[2]) for r in rows)     # not NaN


@pytest.mark.parametrize("flags", [[], ["--scan"], ["--spec", "3"]],
                         ids=["step", "scan", "spec"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q4_0"])
def test_int8_cache_matches_jax(tmp_path, capfdbinary, quant, flags):
    """--cache-dtype int8 (the dense QuantKV cache) prints the JAX CLI's
    first line, in the step loop, the graph loop and speculation."""
    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=quant)
    got, want = _first_lines(capfdbinary, ["-m", path, "-p", "abc", "-n", "12",
                                           "--dtype", "f32", "--cache-dtype", "int8",
                                           *flags])
    assert got == want and got.startswith(b"abc") and len(got) > 3


def test_profile_writes_a_trace(tmp_path, capfdbinary):
    """--profile DIR on the CPU: the same text, a Chrome trace in DIR that
    holds the model's ops, and the line that names DIR."""
    import json

    path = str(tmp_path / "tiny.gguf")
    build_tiny_gguf(path, quant=True)
    out_dir = tmp_path / "prof"
    got, want = _first_lines(capfdbinary, ["-m", path, "-p", "abc", "-n", "8",
                                           "--dtype", "f32"], ["--profile", str(out_dir)])
    assert got == want
    trace = json.loads((out_dir / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("matmul" in n or "mm" in n for n in names)
    capfdbinary.readouterr()
    assert tcli.main(["-m", path, "-p", "abc", "-n", "4", "--dtype", "f32",
                      "--profile", str(out_dir), "--device", "cpu"]) == 0
    lines = capfdbinary.readouterr().out.decode().splitlines()
    assert lines[-1] == f" Timings: torch.profiler trace written to {out_dir}"
