"""How late the open-loop generator sent the requests due in the window: the
95th percentile of send time minus due time (the loop sends between engine
steps)."""

from benchmark.record import percentile


def read(run):
    lags = [r.sent - r.due for r in run.due_in_window()]
    v = percentile(lags, 95)
    return None if v is None else v * 1e3
