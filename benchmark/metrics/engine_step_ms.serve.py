"""The mean span of the engine's ``step()`` (admission with its prefills,
one batched decode, the previous step's host read) over the steps that
started in the window."""


def read(run):
    spans = [b - a for a, b, _ in run.steps if run.t_open <= a < run.t_close]
    return sum(spans) / len(spans) * 1e3 if spans else None
