"""Spans on the host's clock at the boundaries of the serving engines' step
and of each request's path (``runtime/batching.py``,
``runtime/paged_engine.py``).

Off by default: ``span()`` then returns one shared no-op context manager
(no allocation, no clock read, no device call; only the flag is checked).
After ``enable()`` each span records its name, start and end on
``time.perf_counter()``, the span that encloses it (``parent``), the
``Request.rid`` it serves (or None) and a few counts (``attrs``), into a
bounded buffer in memory that ``spans()`` returns, oldest first; a span is
added when it ends, so a child comes before its parent. Nothing is written
out. The stack of open spans is the process's: one thread drives an
engine at a time.

The engines' spans, each with the per-layer metric that reads it
(``benchmark/metrics/``):

- ``step``: all of ``BatchEngine.step``; the count of steps in
  ``fetch_wait_ms.serve``.
- ``queued`` (rid): from ``submit()`` to the start of the request's
  ``prefill``; no parent. ``queue_wait_p95_ms.serve``.
- ``prefill`` (rid), in ``step``: one request's admission, from its block
  allocation and prefix match through every prefill chunk, the tail and the
  first token's host read. ``prefill_p95_ms.serve``.
- ``dispatch``, in ``step``: the decode's enqueue, from the offsets through
  the forward, the sampling, the logprob rows and the start of the tokens'
  copy to the host (a speculative step: its verify). ``dispatch_ms.serve``.
  Its attr ``drained`` (``drained_share.serve``) is True when the card had
  finished all the work queued before the dispatch began, so that it idled
  while the host enqueued; None off the card, and left out where the step
  had already drained the stream by a host read of its own (an admission's
  first token, the speculative step's read of the step before).
- ``fetch_wait``, in ``step`` (in ``dispatch`` where penalty counts are
  rebuilt): the wait for the previous step's tokens on the host.
  ``fetch_wait_ms.serve``.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional

MAXLEN = 1 << 17          # spans kept; the oldest go first

_on = False
_stack: list = []
_buf: collections.deque = collections.deque(maxlen=MAXLEN)


class Span:
    __slots__ = ("name", "t0", "t1", "parent", "rid", "attrs", "_kept")

    def __init__(self, name: str, rid: Optional[int] = None, t0: Optional[float] = None,
                 t1: Optional[float] = None, parent: Optional["Span"] = None,
                 attrs: Optional[dict] = None):
        self.name, self.rid, self.t0, self.t1, self.parent = name, rid, t0, t1, parent
        self.attrs = {} if attrs is None else attrs
        self._kept = True

    def __enter__(self) -> "Span":
        self.parent = _stack[-1] if _stack else None
        _stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        _stack.pop()
        if self._kept:
            _buf.append(self)
        return False

    def note(self, key: str, value) -> None:
        self.attrs[key] = value

    def drop(self) -> None:
        """Record nothing for this span (an admission that waits for blocks)."""
        self._kept = False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, rid={self.rid}, {self.t0}-{self.t1}, {self.attrs})"


class _Off:
    """The span of a recorder that is off: does nothing."""
    __slots__ = ()
    t0 = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, key: str, value) -> None:
        pass

    def drop(self) -> None:
        pass


OFF = _Off()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    _buf.clear()


def spans() -> List[Span]:
    return list(_buf)


def span(name: str, rid: Optional[int] = None):
    """A span around a ``with`` block, or ``OFF`` while the recorder is off."""
    return Span(name, rid) if _on else OFF


def now() -> Optional[float]:
    """The clock, to stamp where a span will start (None while off)."""
    return time.perf_counter() if _on else None


def add(name: str, t0: Optional[float], t1: Optional[float], rid: Optional[int] = None) -> None:
    """A span between two stamps taken apart (a request's wait in the queue);
    nothing when either was taken while the recorder was off."""
    if _on and t0 is not None and t1 is not None:
        _buf.append(Span(name, rid, t0, t1))
