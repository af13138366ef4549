"""CUDA kernels in the profiler's trace over the output tokens delivered in
the traced sub-window."""


def read(run):
    t = run.trace
    if not t or not t["kernels"]:
        return None
    toks = sum(1 for r in run.requests for x in r.times if t["t0"] <= x < t["t1"])
    return t["kernels"] / toks if toks else None
