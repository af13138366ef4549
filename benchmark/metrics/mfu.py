"""The whole step's share of the chip's peak: the sum of each forward's
bound time (``roofline.forward_cost``: the work the inputs need) over the
traced sub-window's seconds."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["forward_s"] <= 0:
        return None
    return t["forward_s"] / t["window_s"] * 100
