"""Tiny versions of the benchmark's configurations and mixes, for the CPU
tests: the same files with every size cut so that a run takes seconds."""

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_LIMIT = {"max_gap": 0.02, "route_gap": 0.02, "router_gap": 0.02}
# cells that no entry of BENCHMARK.json holds: they keep the BatchEngine
# entry, the route-following check and the MoE paths (masked at 16 rows,
# gather at one) tested here
LIBRARY = [{"name": "mixtral-8x7b.batch16", "config": "mixtral-8x7b", "traffic": "batch16"},
           {"name": "mixtral-8x7b.chat-scan", "config": "mixtral-8x7b", "traffic": "chat-scan"}]


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        c = copy.deepcopy(json.load(f))
    c["config"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
                       bos_token_id=1, eos_token_id=2)
    if "num_local_experts" in c["config"]:
        c["config"]["num_local_experts"] = 4
    c["token_ids"] = [3, 250]
    return c


def tiny_mix(name: str) -> dict:
    from benchmark.traffic import generator

    m = copy.deepcopy(generator.load_mix(name))
    m["prompt"].update(median=24, min=8, max=60)
    m["output"].update(median=8, min=4, max=16)
    if "prefix" in m:
        m["prefix"]["tokens"] = 16
    e = m["engine"]
    if "pool_tokens" in e:
        e.update(batch=4, pool_tokens=4 * 96, max_seq=96, prefill_chunk=32)
    elif "batch" in e:
        e.update(batch=4, max_seq=96)
    else:
        e.update(max_seq=96)
    if m["entry"] == "batch":
        m.update(steps=40, trace_end_s=1.0)
    if "ramp_s" in m:
        m["ramp_s"] = 0.5
    if "rate_per_s" in m:
        m["rate_per_s"] = 20.0
        m["sampling"]["greedy_share"] = 0.5
    m["check"]["served_tokens"] = 80
    return m


def run_tiny(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 3.0,
             trace: bool = False):
    from benchmark import harness

    b = bench()
    cell = next(w for w in b["workloads"] + LIBRARY if w["name"] == workload)
    files = tiny_config(cell["config"]), tiny_mix(cell["traffic"]), TINY_LIMIT
    return harness.run_cell(b, workload, seed, seconds, trace, "cpu", files=files)
