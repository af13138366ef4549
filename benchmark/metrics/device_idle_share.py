"""The share of the traced sub-window in which no operation ran on the
device (``torch.profiler``'s device activity)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return max(0.0, 1.0 - t["busy_s"] / t["window_s"]) * 100
