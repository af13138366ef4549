"""Run one cell of the benchmark of tpu_llm_torch on the card this process
sees, and print its result as the last line of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``BENCHMARK.json``). The drawn traffic is printed on the
line before the result; the numbers that decide ``correct`` are the last
lines of standard error and the last key of the result. Exits non-zero,
printing no result, when the cell's configuration names no architecture
module (``arch``), without a CUDA card (or with fewer than the cell asks
for), without the program, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_llm")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (``tpu_llm_torch`` is not ``tpu_llm``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches at fixed paths inside the checkout; no library may load JAX
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
    sys.path.insert(0, ROOT)
    try:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    except (OSError, StopIteration, KeyError) as e:
        print(f"run.py: no workload {args.workload!r} in BENCHMARK.json ({e!r})",
              file=sys.stderr)
        return 2
    from benchmark import harness

    files = harness.cell_files(bench, args.workload)
    try:
        harness.load_arch(files[0])
    except harness.ArchError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import tpu_llm_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program tpu_llm_torch is missing ({e})", file=sys.stderr)
        return 2
    result, traffic = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T_START, files)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print("traffic: " + json.dumps(traffic))
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, n in result["checks"].items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
