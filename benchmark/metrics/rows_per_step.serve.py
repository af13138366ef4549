"""The mean number of live requests a step decoded, over the steps that
started in the window."""


def read(run):
    rows = [n for a, _, n in run.steps if run.t_open <= a < run.t_close]
    return sum(rows) / len(rows) if rows else None
