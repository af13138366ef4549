"""What a run recorded, on the host clock (``time.perf_counter``): the
window, every request with its due time and the receipt time of each of
its tokens, the engine's steps, the program's counters, and the traced
sub-window; for a mixture of experts, the experts the program chose.
Metric readers (``metrics/``) read only this."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from benchmark.traffic.generator import Spec


@dataclasses.dataclass
class Req:
    spec: Spec
    due: float                       # when it was due (open loop) or sent (closed loop)
    sent: float
    n_in: int                        # BOS + prompt
    times: List[float] = dataclasses.field(default_factory=list)   # token receipts
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    failed: bool = False
    rid: int = -1                    # the engine's request id (the route record's key)

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None


@dataclasses.dataclass
class Run:
    t_open: float
    t_close: float
    setup_s: float
    requests: List[Req] = dataclasses.field(default_factory=list)
    steps: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    # single-stream generations: (start, end, ttft_s, decode_s, decode steps)
    chats: List[Tuple[float, float, float, float, int]] = dataclasses.field(
        default_factory=list)
    trace: Optional[dict] = None
    memory_peak_bytes: int = 0
    t_end: float = 0.0               # when the run stopped waiting (drain's end)
    routes: Optional[object] = None  # the experts the program chose (routes.Routes)
    release: Callable[[], None] = lambda: None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, r: Req) -> bool:
        return self.t_open <= r.due < self.t_close

    def due_in_window(self) -> List[Req]:
        return [r for r in self.requests if self.in_window(r)]

    def attempted(self) -> int:
        return len(self.due_in_window())

    def failed(self) -> int:
        return sum(r.failed for r in self.due_in_window())

    def tokens_in_window(self) -> int:
        return sum(1 for r in self.requests for t in r.times
                   if self.t_open <= t < self.t_close)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (q in (0, 100]) of all ``values``."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def ttfts(run: Run) -> List[float]:
    """Time to first token of every request due in the window, from its due
    time; one that never got a token counts as waiting until the run ended."""
    return [(r.first if r.first is not None else run.t_end) - r.due
            for r in run.due_in_window()]


def itls(run: Run) -> List[float]:
    """Every gap between consecutive tokens of a request whose later token
    arrived inside the window."""
    out = []
    for r in run.requests:
        for a, b in zip(r.times, r.times[1:]):
            if run.t_open <= b < run.t_close:
                out.append(b - a)
    return out
