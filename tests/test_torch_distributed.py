"""Multi-process bring-up of the port (tpu_llm_torch.parallel.distributed)
on the CPU: init_distributed as a no-op in one process; the two-process
--selftest (a dp-sharded decode step against the local one, the
counterpart of tests/test_multiprocess.py); the launcher failing a run
whose rank fails; `llm --tp 2` (and --tp 2 --dp 2 with --scan --spec)
spawning its own ranks, and `llm --tp 2` as two processes started with
--coordinator / --num-processes / --process-id, printing the JAX CLI's
first line from rank 0 alone; the refusals."""

import os
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.make_tiny_gguf import build
from tests.torch_parallel_ranks import fail_rank
from tpu_llm.runtime import cli as jcli
from tpu_llm_torch.parallel import distributed as D
from tpu_llm_torch.runtime import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["-p", "abc", "-n", "12", "--dtype", "f32"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "tiny.gguf")
    build(path)
    return path


@pytest.fixture(scope="module")
def jax_line(tiny):
    import contextlib
    import io

    buf = io.BytesIO()
    text = io.TextIOWrapper(buf, write_through=True)
    with contextlib.redirect_stdout(text):
        assert jcli.main(["-m", tiny, *ARGV]) == 0
    return buf.getvalue().split(b"\n")[0]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TPU_LLM_") and k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _two_processes(argv_of):
    procs = [subprocess.Popen([sys.executable, "-m", *argv_of(i)], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], outs


def test_init_distributed_single_process_noop(monkeypatch):
    for k in ("TPU_LLM_COORDINATOR", "TPU_LLM_NUM_PROCESSES", "TPU_LLM_PROCESS_ID",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert D.init_distributed() == (0, 1)
    assert D.configured_world() == 1


def test_two_process_selftest():
    port = D.free_port()
    rcs, outs = _two_processes(lambda i: [
        "tpu_llm_torch.parallel.distributed", "--selftest", "--rank", str(i), "--nprocs", "2",
        "--port", str(port)])
    for rank, (rc, (out, err)) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {rank}: {err.decode()[-2000:]}"
        assert b"SELFTEST OK" in out and b"backend=gloo" in out


def test_a_failing_rank_fails_the_launch():
    with pytest.raises(RuntimeError, match="ranks failed.*rank 1 fails on purpose"):
        D.launch(fail_rank, 2, 1, device="cpu", timeout=120)


@pytest.mark.parametrize("extra", [["--tp", "2"],
                                   ["--tp", "2", "--dp", "2", "--scan", "--spec", "3"]],
                         ids=["tp2", "tp2_dp2_scan_spec"])
def test_llm_spawns_its_ranks(extra, tiny, jax_line, capfdbinary):
    capfdbinary.readouterr()
    assert tcli.main(["-m", tiny, *ARGV, "--device", "cpu", *extra]) == 0
    out = capfdbinary.readouterr().out            # the ranks' inherited fd 1
    assert out.split(b"\n")[0] == jax_line
    assert out.count(b"Inference time") == 1       # rank 0 alone prints


def test_llm_with_the_multi_process_flags(tiny, jax_line):
    port = D.free_port()
    rcs, outs = _two_processes(lambda i: [
        "tpu_llm_torch.runtime.cli", "-m", tiny, *ARGV, "--device", "cpu", "-v", "--tp", "2",
        "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id", str(i)])
    assert rcs == [0, 0], outs[0][1].decode()[-2000:] + outs[1][1].decode()[-2000:]
    assert outs[0][0].split(b"\n")[0] == jax_line
    assert outs[1][0] == b""
    assert b"mesh: dp=1 tp=2 backend=gloo" in outs[0][1]


def test_refusals(tiny, capsys):
    assert tcli.main(["-m", tiny, *ARGV, "--device", "cpu", "--tp", "2", "--timings"]) == 2
    assert "--timings" in capsys.readouterr().err
    # the world the flags configure must hold tp * dp ranks
    rc, mesh = D.front_end_mesh(tcli.main, [], 2, 1, "cpu", coordinator="localhost:1",
                                num_processes=1, process_id=0)
    assert (rc, mesh) == (2, None)
    assert "--tp 2 --dp 1 needs 2 ranks; the world has 1" in capsys.readouterr().err
