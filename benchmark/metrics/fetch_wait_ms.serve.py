"""The host's wait for the previous step's tokens, a step: the port's
``fetch_wait`` spans over its ``step`` spans, each that start in the
window."""

from benchmark.spans import durations, spans


def read(run):
    steps = spans(run, "step")
    return sum(durations(run, "fetch_wait")) / len(steps) * 1e3 if steps else None
