"""The port's own spans (``tpu_llm_torch.runtime.trace``) for the metrics
that read them. Importing this module turns the port's recorder on: the
harness loads the per-layer readers only in a traced run, before it builds
the program, so a run with ``--trace 0`` never records a span. A program
without the recorder gives no spans, and its readers nothing."""

from __future__ import annotations

from typing import List

try:
    from tpu_llm_torch.runtime import trace
except ImportError:
    trace = None
else:
    trace.enable()


def spans(run, name: str) -> List:
    """The spans called ``name`` that start inside the run's window
    ([``t_open``, ``t_close``) on ``time.perf_counter``); none where the
    program has no recorder, or where its buffer dropped the window's start."""
    if trace is None:
        return []
    kept = trace.spans()
    if len(kept) >= trace.MAXLEN and kept[0].t0 > run.t_open:
        return []
    return [s for s in kept if s.name == name and run.t_open <= s.t0 < run.t_close]


def durations(run, name: str) -> List[float]:
    return [s.t1 - s.t0 for s in spans(run, name)]
