"""The median of ``GenerationResult.ttft_s`` (prefill and the first sampled
token) over the generations in the window."""

import statistics


def read(run):
    v = [c[2] for c in run.chats if run.t_open <= c[0] < run.t_close]
    return statistics.median(v) * 1e3 if v else None
