"""The knee of an open-loop cell: the highest arrival rate the program
sustains without a growing backlog. One process draws the weights once
and runs the cell's entry at each rate in turn:

    python3 benchmark/knee.py --workload qwen2-7b.chat-paged --seed 7 --seconds 30 --rates 3,5,7

For each rate it prints one JSON line: the offered and completed request
rates, TTFT p50 / p95, the mean TTFT of the window's first and last
quarter of requests (a backlog that grows makes the last much larger),
and the requests still without a first token when the window closed.
The cell's mix file then states 0.8 x the knee as its ``rate_per_s``;
the benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    import torch

    from benchmark import harness
    from benchmark.record import percentile, ttfts
    from benchmark.traffic import generator

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cfg_file, mix, _ = harness.cell_files(bench, args.workload)
    entry = harness.load_module("entries", mix["entry"])
    ctx = harness.Context(cfg_file, mix, args.seed, args.seconds, False, "cuda",
                          time.perf_counter())
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.mix = dict(mix, rate_per_s=rate, drain_s=min(mix["drain_s"], 15))
        ctx.specs = generator.stream(ctx.mix, cfg_file["token_ids"], args.seed)
        run = entry.run(ctx)
        reqs = sorted(run.due_in_window(), key=lambda r: r.due)
        q = max(1, len(reqs) // 4)
        t = [(r.first if r.first is not None else run.t_end) - r.due for r in reqs]
        done = [r for r in reqs if r.done]
        print(json.dumps({
            "rate": rate, "offered_per_s": len(reqs) / run.window_s,
            "completed_per_s": len(done) / run.window_s,
            "output_tok_s": run.tokens_in_window() / run.window_s,
            "ttft_p50_ms": 1e3 * statistics.median(t), "ttft_p95_ms": 1e3 * percentile(ttfts(run), 95),
            "ttft_first_quarter_ms": 1e3 * statistics.mean(t[:q]),
            "ttft_last_quarter_ms": 1e3 * statistics.mean(t[-q:]),
            "no_first_token_at_close": sum(r.first is None or r.first >= run.t_close
                                           for r in reqs),
            "steps": len(run.steps)}), flush=True)
        run.release()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
