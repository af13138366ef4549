"""The share of decode dispatches that began with the card's stream
drained, so that the card idled while the host enqueued the step: the
port's ``dispatch`` spans in the window whose ``drained`` is True, over
those where it was read (on a card, in a step that ran no prefill: an
admission's first-token read drains the stream by itself)."""

from benchmark.spans import spans


def read(run):
    seen = [s.attrs["drained"] for s in spans(run, "dispatch")
            if s.attrs.get("drained") is not None]
    return sum(seen) / len(seen) * 100 if seen else None
