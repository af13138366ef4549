"""K1 (the fused q4_0 dequant-matmul): the sum of each call's bound time
(``roofline.k1_call`` at the bf16 peak) over the sum of K1's device time in
the trace."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t:
        return None
    dev = sum(s for name, s in t["totals"].items()
              if any(k in name for k in roofline.K1_KERNELS))
    if dev <= 0 or not t["k1"]:
        return None
    return sum(roofline.bound_s(ops, nb) for ops, nb in t["k1"]) / dev * 100
