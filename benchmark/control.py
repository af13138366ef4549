"""The control of a cell, on the card, at the cell's own size and load:

    python3 benchmark/control.py --workload qwen2-7b.chat-paged --seeds 1,2,3 --seconds 20

For each seed it runs the cell as a benchmark run does, for a short
window (``harness.run_program``), and judges on the run's own check
sample, by the comparison that decides a run's ``correct``
(``check.judged``), both the program and the control: the reference
with every projection's input in float8 e4m3, the step below the stated
bf16, put in the program's place at the same served positions (for a
mixture of experts on the program's experts for ``max_gap``, on its own
top k for ``route_gap``). It prints
both sets of numbers with their limits and verdicts, one line a seed. A
cell's limit lies above every seed's program reading and below every
seed's control reading. The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONTROL = "fp8"


def readings(workload: str, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One short run of the cell for ``seed``: the program's and the
    control's numbers, each with ``correct``."""
    import torch

    from benchmark import check, harness

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cfg_file, mix, limits = harness.cell_files(bench, workload)
    entry = harness.load_module("entries", mix["entry"])
    t0 = time.perf_counter()
    ctx = harness.Context(cfg_file, mix, seed, seconds, False, device, t0)
    run = harness.run_program(ctx, entry)
    t1 = time.perf_counter()
    judged = check.judged(ctx.arch, ctx.cfg, ctx.raw, run, mix, limits, seed, (CONTROL,))
    out = {"workload": workload, "seed": seed,
           "served_tokens": sum(len(r.tokens) for r in check.sample(
               run, mix["check"]["served_tokens"], seed))}
    for name, act in (("program", None), (CONTROL, CONTROL)):
        out[name] = dict(judged[act], correct=check.verdict(judged[act]))
    out.update(run_s=t1 - t0, check_s=time.perf_counter() - t1)
    del ctx, run
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
