"""K2-K6 (the attention kernels): the sum of each call's bound time (bf16
peak where q and the cache are both bf16, else f32) over the sum of their
device time in the trace."""

from benchmark import roofline


def read(run):
    t = run.trace
    if not t:
        return None
    dev = sum(s for name, s in t["totals"].items()
              if any(k in name for k in roofline.ATTN_KERNELS))
    if dev <= 0 or not t["attn"]:
        return None
    return sum(roofline.bound_s(ops, nb, peak) for ops, nb, peak in t["attn"]) / dev * 100
