"""The 95th percentile of a request's wait in the engine's queue: the
port's ``queued`` spans (``submit()`` to the start of its prefill) that
start in the window."""

from benchmark.record import percentile
from benchmark.spans import durations


def read(run):
    v = percentile(durations(run, "queued"), 95)
    return None if v is None else v * 1e3
