"""The 95th percentile of time to first token over every request due in the
window, from its due time to the host's receipt of its first token; a
request that never got one counts as waiting until the run ended."""

from benchmark.record import percentile, ttfts


def read(run):
    v = percentile(ttfts(run), 95)
    return None if v is None else v * 1e3
