"""The port's CLI (run on the CPU) prints byte-identical greedy output to
tpu_llm.runtime.cli on the tiny test GGUF."""

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


@pytest.mark.parametrize("flag", [["--scan"], ["--top-k", "5"], ["--spec", "2"],
                                  ["--cache-dtype", "int8"]])
def test_flags_outside_the_slice_are_refused(flag):
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["-m", "x.gguf", *flag])
