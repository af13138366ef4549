"""Slope timing (``tpu_llm/runtime/timing.py``).

Host timing of an N-step run includes a constant cost (the launch of the
first step, the final synchronize and fetch); ``total / steps`` overstates
the per-step time by that constant over N. ``slope_time_s`` runs the same
program at two lengths and reports the per-step slope, which cancels the
constant. Median over ``pairs`` interleaved pairs.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


def slope_time_s(
    make_run: Callable[[int], Callable[[], None]],
    n1: int,
    n2: int,
    pairs: int = 3,
) -> float:
    """Per-step seconds. ``make_run(n)`` returns a thunk that executes an
    n-step program AND syncs by fetching a result to host."""
    assert n2 > n1
    run1, run2 = make_run(n1), make_run(n2)
    for run in (run1, run2):  # build + warm
        run()
        run()
    slopes = []
    for _ in range(pairs):
        t0 = time.perf_counter()
        run1()
        t1 = time.perf_counter()
        run2()
        t2 = time.perf_counter()
        slopes.append(((t2 - t1) - (t1 - t0)) / (n2 - n1))
    return float(np.median(slopes))
