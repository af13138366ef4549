"""The port's `llm-serve` (python -m tpu_llm_torch.runtime.serve_cli) on a
tiny GGUF on the CPU against tpu_llm.runtime.serve_cli with the same
flags: per-request completions and token counts identical, the summary
with the same keys (dense, paged, int8 dense planes and pools, --spec,
--spec --paged, --spec --draft, the sampling filters); --lora, --tp and
--dp parse, a flag the JAX front end lacks is refused."""

import json

import pytest

from tests.make_tiny_gguf import build
from tpu_llm.runtime import serve_cli as jcli
from tpu_llm_torch.runtime import serve_cli as tcli
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    cap = capsys.readouterr()
    rows = [json.loads(ln) for ln in cap.out.strip().splitlines() if ln.startswith("{")]
    summary = json.loads([ln for ln in cap.err.strip().splitlines()
                          if ln.startswith("{")][-1])
    return rows, summary


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "tiny.gguf")
    build(path)
    return path


@pytest.mark.parametrize("mode", [[], ["--paged", "--block-size", "4"],
                                  ["--paged", "--cache-dtype", "int8"],
                                  ["--cache-dtype", "int8"], ["--spec", "3"],
                                  ["--spec", "3", "--paged", "--block-size", "4"],
                                  ["--spec", "3", "--draft", None]],
                         ids=["dense", "paged", "paged_int8", "dense_int8", "spec",
                              "spec_paged", "spec_draft"])
def test_completions_match_jax(tiny, mode, capsys, monkeypatch):
    monkeypatch.setenv("TPU_LLM_NO_COMPILE_CACHE", "1")
    mode = [tiny if f is None else f for f in mode]        # --draft: the same file
    argv = ["-m", tiny, "-p", "abc", "-p", "ab", "-p", "abc abc ab", "-p", "abc abc b",
            "-n", "6", "--batch", "2"] + mode
    want, wsum = _run(jcli.main, argv, capsys)
    got, gsum = _run(tcli.main, argv + ["--device", "cpu"], capsys)
    assert [(r["prompt"], r["completion"], r["n_tokens"]) for r in got] == \
        [(r["prompt"], r["completion"], r["n_tokens"]) for r in want]
    assert all(r["n_tokens"] == 6 for r in got) and len(got) == 4
    assert sorted(gsum) == sorted(wsum)
    for k in ("requests", "generated_tokens", "engine_steps", "engine",
              "prefix_cache_hit_rate", "hbm_blocks_in_use", "speculative_k",
              "spec_tokens_per_forward"):
        assert gsum.get(k) == wsum.get(k), k
    if "--spec" in mode:
        assert gsum["spec_tokens_per_forward"] >= 1


def test_prompts_file_and_stop_at_eos(tiny, tmp_path, capsys):
    pf = tmp_path / "prompts.txt"
    pf.write_text("abc\nab\n\n")
    rows, summary = _run(tcli.main, ["-m", tiny, "-f", str(pf), "-n", "4", "--batch", "2",
                                     "--stop-at-eos", "--device", "cpu"], capsys)
    assert [r["prompt"] for r in rows] == ["abc", "ab"] and summary["requests"] == 2


@pytest.mark.parametrize("flag", [["--lora", "x"], ["--tp", "2"], ["--dp", "2"]])
def test_flags_outside_the_slice_are_refused(flag):
    """LoRA and the parallel flags parse since the parallel slice (they
    were refused before it); a flag the JAX front end does not have is
    still refused (argparse exits 2)."""
    args = tcli.build_parser().parse_args(["-m", "x.gguf", "-p", "a"] + flag)
    assert getattr(args, flag[0][2:]) == (flag[1] if flag[0] == "--lora" else int(flag[1]))
    with pytest.raises(SystemExit) as e:
        tcli.build_parser().parse_args(["-m", "x.gguf", "-p", "a", flag[0] + "-x", flag[1]])
    assert e.value.code == 2


@pytest.mark.parametrize("flag,attr,value", [(["--spec", "2"], "spec", 2),
                                             (["--draft", "x.gguf"], "draft", "x.gguf")],
                         ids=["spec", "draft"])
def test_spec_and_draft_parse(flag, attr, value):
    """--spec and --draft parse since the speculation slice."""
    args = tcli.build_parser().parse_args(["-m", "x.gguf", "-p", "a"] + flag)
    assert getattr(args, attr) == value


def test_dense_int8_serves(tiny, capsys):
    """Dense --cache-dtype int8 serves on the CPU: exit 0, one row."""
    rows, summary = _run(tcli.main, ["-m", tiny, "-p", "a", "--cache-dtype", "int8",
                                     "--device", "cpu"], capsys)
    assert len(rows) == 1 and summary["engine"] == "dense"


def test_dense_int8_and_missing_card_exit_1(tiny, capsys):
    """Without a card and without --device cpu the CLI exits 1, dense
    int8 or not, naming --device cpu."""
    import torch

    if not torch.cuda.is_available():
        for extra in ([], ["--cache-dtype", "int8"]):
            assert tcli.main(["-m", tiny, "-p", "a", *extra]) == 1
            assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [[], ["--paged", "--block-size", "4"]], ids=["dense", "paged"])
def test_filters_match_jax(tiny, mode, capsys, monkeypatch):
    """--top-k 1 with a temperature gives the JAX front end's greedy
    completions; --top-p / --min-p at temperature 0 too."""
    monkeypatch.setenv("TPU_LLM_NO_COMPILE_CACHE", "1")
    argv = ["-m", tiny, "-p", "abc", "-p", "ab", "-n", "6", "--batch", "2"] + mode
    want, _ = _run(jcli.main, argv, capsys)
    for flags in (["-t", "0.9", "--top-k", "1"], ["--top-p", "0.5", "--min-p", "0.2"]):
        got, _ = _run(tcli.main, argv + flags + ["--device", "cpu"], capsys)
        assert [r["completion"] for r in got] == [r["completion"] for r in want]
    args = tcli.build_parser().parse_args(argv + ["--top-k", "5", "--top-p", "0.9",
                                                  "--min-p", "0.1"])
    assert (args.top_k, args.top_p, args.min_p) == (5, 0.9, 0.1)
