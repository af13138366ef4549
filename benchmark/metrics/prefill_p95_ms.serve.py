"""The 95th percentile of one request's admission: the port's ``prefill``
spans (block allocation and prefix match, every chunk, the tail and the
first token's host read) that start in the window."""

from benchmark.record import percentile
from benchmark.spans import durations


def read(run):
    v = percentile(durations(run, "prefill"), 95)
    return None if v is None else v * 1e3
