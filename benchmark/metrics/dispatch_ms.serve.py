"""The host's time to enqueue one decode step: the mean of the port's
``dispatch`` spans (offsets, forward, sampling, the start of the tokens'
copy) that start in the window."""

from benchmark.spans import durations


def read(run):
    v = durations(run, "dispatch")
    return sum(v) / len(v) * 1e3 if v else None
