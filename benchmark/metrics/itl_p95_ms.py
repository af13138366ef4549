"""The 95th percentile of the gap between a request's consecutive output
tokens (their receipts on the host), over every token received in the
window."""

from benchmark.record import itls, percentile


def read(run):
    v = percentile(itls(run), 95)
    return None if v is None else v * 1e3
