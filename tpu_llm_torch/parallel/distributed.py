"""Multi-process bring-up on ``torch.distributed``
(``tpu_llm/parallel/distributed.py``).

Every rank runs the same program and joins one process group before any
collective. The world is configured by flags or by the environment:

- ``--coordinator HOST:PORT --num-processes N --process-id I``, or
- ``TPU_LLM_COORDINATOR`` / ``TPU_LLM_NUM_PROCESSES`` / ``TPU_LLM_PROCESS_ID``,
  or
- torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
  (the counterpart of the JAX package's auto-detection).

``init_distributed`` calls ``init_process_group(init_method="tcp://...")``
and returns (rank, world), or (0, 1) when nothing is configured. The
backend is NCCL when every rank on the host has a GPU of its own, gloo
otherwise (ranks sharing one card, or the CPU); ``mesh.describe()`` names
it.

``launch(fn, n)`` is the single-host launcher: it spawns n ranks on
localhost (``torch.multiprocessing``, spawn), each joining the world
before it calls ``fn(rank, *args)``, and returns their results in rank
order; a rank that fails (an exception, a non-zero exit) fails the
launch, and the other ranks are stopped. ``spawn_main`` runs a CLI's
``main(argv)`` on every rank, rank 0 alone keeping its stdout: the front
ends call it when ``--tp`` / ``--dp`` ask for more ranks than the world
has. Each spawned rank takes ``torch.get_num_threads() // n`` intra-op
threads of its parent's (at least one).

``--selftest`` (``python -m tpu_llm_torch.parallel.distributed --selftest
--rank I --nprocs 2 --port P``) runs one rank of a localhost two-process
check: a dp-sharded llama decode step over a mesh spanning both
processes, held against the same step computed locally.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import sys
import traceback
from typing import Any, Callable, List, Optional, Tuple

import torch

# a collective still waiting after this (a rank is gone) raises
TIMEOUT = datetime.timedelta(seconds=600)


def _configured(coordinator, num_processes, process_id):
    coordinator = coordinator or os.environ.get("TPU_LLM_COORDINATOR")
    if num_processes is None and os.environ.get("TPU_LLM_NUM_PROCESSES"):
        num_processes = int(os.environ["TPU_LLM_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TPU_LLM_PROCESS_ID"):
        process_id = int(os.environ["TPU_LLM_PROCESS_ID"])
    if coordinator is None and num_processes is None and os.environ.get("WORLD_SIZE"):
        coordinator = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", "0"))
    return coordinator, num_processes, process_id


def backend_for(device_type: str, world: int) -> str:
    """NCCL when each rank of this host has a GPU of its own, else gloo."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device: str = "cuda"
                     ) -> Tuple[int, int]:
    """Join the configured world (see the module docstring): (rank, world),
    (0, 1) when single process; a world already joined is returned as it
    is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator, n, pid = _configured(coordinator, num_processes, process_id)
    if coordinator is None and n is None:
        return 0, 1
    if coordinator is None or n is None or pid is None:
        raise ValueError("a multi-process world needs the coordinator (HOST:PORT), "
                         "the number of processes and this process's id")
    if n == 1:
        return 0, 1
    dist.init_process_group(backend=backend_for(device, n),
                            init_method=f"tcp://{coordinator}", world_size=n, rank=pid,
                            timeout=TIMEOUT)
    if device == "cuda" and torch.cuda.is_available():
        from tpu_llm_torch.parallel.mesh import rank_device

        torch.cuda.set_device(rank_device("cuda", pid))
    return pid, n


def configured_world() -> int:
    """The world size the flags' environment configures (1 if none)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return _configured(None, None, None)[1] or 1


# -- the single-host launcher --------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _put(results, item) -> None:
    """Hand a rank's result to the launcher and wait until it is sent (the
    queue's feeder thread would die with an os._exit)."""
    results.put(item)
    results.close()
    results.join_thread()


def _rank_main(fn, rank: int, n: int, port: int, threads: int, device: str, args,
               results, quiet: bool):
    os.environ.update(TPU_LLM_COORDINATOR=f"localhost:{port}",
                      TPU_LLM_NUM_PROCESSES=str(n), TPU_LLM_PROCESS_ID=str(rank))
    torch.set_num_threads(threads)
    if rank != 0:
        # an interrupt stops rank 0, which stops the others (a server's
        # plan, or a closed connection)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        if quiet:
            sys.stdout = open(os.devnull, "w")
    try:
        init_distributed(device=device)
        out = fn(rank, *args)
        _put(results, (rank, True, out))
    except BaseException as e:     # noqa: BLE001 — handed to the launcher
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        _put(results, (rank, False, f"{type(e).__name__}: {e}"))
        os._exit(1)
    import torch.distributed as dist

    try:
        dist.destroy_process_group()
    except Exception:              # noqa: BLE001 — the results are in
        pass
    sys.stdout.flush()
    os._exit(0)


def launch(fn: Callable, n: int, *args, device: str = "cuda", quiet: bool = False,
           timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on n localhost ranks of one new world; their
    results in rank order. ``fn`` and ``args`` must pickle (a module-level
    function). RuntimeError names the ranks that failed."""
    import queue
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    threads = max(1, torch.get_num_threads() // n)
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, threads, device, args,
                                                  results, quiet), daemon=False)
             for r in range(n)]
    for p in procs:
        p.start()
    got, failed = {}, {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(got) + len(failed) < n:
            try:
                rank, ok, out = results.get(timeout=1.0)
                (got if ok else failed)[rank] = out
                if not ok:
                    break
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got and r not in failed]
                for r in dead:
                    failed[r] = f"exit code {procs[r].exitcode}"
                if dead:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    failed[-1] = f"timed out after {timeout} s"
                    break
        if not failed:
            for p in procs:
                p.join(timeout=120)
                if p.exitcode not in (0, None):
                    failed[procs.index(p)] = f"exit code {p.exitcode}"
    finally:
        for p in procs:
            if p.is_alive():
                p.join(timeout=0 if failed else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    return [got[r] for r in range(n)]


def _main_rank(rank: int, main: Callable, argv):
    return main(argv)


def spawn_main(main: Callable, argv, n: int, device: str) -> int:
    """A front end's ``main(argv)`` on n spawned ranks (rank 0 keeps its
    stdout): rank 0's exit code, or 1 when any rank failed."""
    try:
        rcs = launch(_main_rank, n, main, list(argv), device=device, quiet=True)
    except RuntimeError as e:
        print(f"distributed: {e}", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130
    return rcs[0] if all(rc == 0 for rc in rcs[1:]) else (rcs[0] or 1)


def front_end_mesh(main: Callable, argv, tp: int, dp: int, device: str,
                   coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None):
    """A front end's world from its flags: (exit code, None) when the front
    end is done (it spawned tp * dp ranks that ran ``main(argv)``, or the
    flags do not fit the world), else (None, mesh), the mesh None for a
    single process. A world of more ranks than tp * dp asks for, with
    neither --tp nor --dp, runs data-parallel replicas."""
    if (tp * dp > 1 and coordinator is None and num_processes is None
            and configured_world() == 1):
        return spawn_main(main, argv, tp * dp, device), None
    rank, world = init_distributed(coordinator, num_processes, process_id, device=device)
    if world == 1 and tp * dp == 1:
        return None, None
    if tp * dp == 1:
        dp = world
    if tp * dp != world:
        if rank == 0:
            print(f"--tp {tp} --dp {dp} needs {tp * dp} ranks; the world has {world}",
                  file=sys.stderr)
        return 2, None
    from tpu_llm_torch.parallel.mesh import make_mesh

    return None, make_mesh(dp, tp, device=device)


# -- localhost two-process selftest -------------------------------------------

def _selftest_rank(rank: int, nprocs: int, port: int) -> None:
    """One rank of the decode-parity selftest (CPU, gloo). Prints
    'SELFTEST OK ...' on success; any mismatch raises."""
    import numpy as np

    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.parallel.mesh import make_mesh
    from tpu_llm_torch.parallel.serving import make_tp_llama_adapter

    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", nprocs, rank, device="cpu")
    cfg = LlamaConfig(dim=32, hidden_dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=96, seq_len=32)
    rng = np.random.default_rng(0)       # identical on every rank
    s = lambda *sh: torch.from_numpy((rng.standard_normal(sh) * 0.05).astype(np.float32))  # noqa: E731
    E, F, V, KV = cfg.dim, cfg.hidden_dim, cfg.vocab_size, cfg.kv_dim
    params = {"tok_emb": s(V, E), "final_norm": s(E) + 1.0, "wcls": s(E, V),
              "layers": [{"attn_norm": s(E) + 1.0, "ffn_norm": s(E) + 1.0, "wq": s(E, E),
                          "wk": s(E, KV), "wv": s(E, KV), "wo": s(E, E), "w1": s(E, F),
                          "w3": s(E, F), "w2": s(F, E)} for _ in range(cfg.n_layers)]}
    batch = 2 * nprocs
    tokens = torch.from_numpy(rng.integers(0, V, (batch,)).astype(np.int64))
    # the local reference, before any collective
    ref, _ = M.decode_step(params, cfg, tokens, M.init_cache(cfg, batch, cfg.seq_len), 0)
    # dp-sharded over the processes: each rank decodes batch / nprocs rows
    mesh = make_mesh(data=nprocs, model=1, device="cpu")
    adapter = make_tp_llama_adapter(cfg, mesh)
    state = adapter.init_state(batch, cfg.seq_len)
    hidden, _ = adapter.apply(params, tokens[:, None], state, 0)
    got = adapter.lm_head(params, hidden)[:, 0, :]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    print(f"SELFTEST OK rank={rank}/{nprocs} devices={nprocs} logits={tuple(got.shape)} "
          f"maxdiff={(got - ref).abs().max().item():.2e} backend={mesh.backend}", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="tpu_llm_torch.parallel.distributed")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=12789)
    args = ap.parse_args(argv)
    if args.selftest:
        _selftest_rank(args.rank, args.nprocs, args.port)
        return 0
    ap.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
