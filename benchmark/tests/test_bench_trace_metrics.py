"""The readers of the port's spans (``benchmark/spans.py``) on a synthetic
span list: only spans that start in the window count, the tails are
``record.percentile``'s, a ``drained`` of None is not counted, and no spans
give no value. Then the tiny chat-paged cell on the CPU: traced, it reports
every span metric but ``drained_share.serve`` (no card); untraced, the
port's recorder stays off."""

import sys
import types

import pytest

import tiny_cells
from benchmark import harness
from benchmark.record import Run, percentile
from tpu_llm_torch.runtime import trace
from tpu_llm_torch.runtime.trace import Span

NAMES = ("queue_wait_p95_ms.serve", "prefill_p95_ms.serve", "dispatch_ms.serve",
         "fetch_wait_ms.serve", "drained_share.serve")


def metric(name):
    return harness.load_module("metrics", name).read


@pytest.fixture(autouse=True)
def recorder_off():
    yield
    trace.disable()
    trace.clear()


def fake_recorder(monkeypatch, kept, maxlen=1 << 17):
    """The readers' spans come from ``kept`` (None: no recorder)."""
    import benchmark.spans

    monkeypatch.setattr(benchmark.spans, "trace", None if kept is None else
                        types.SimpleNamespace(spans=lambda: list(kept), MAXLEN=maxlen))


def synthetic():
    """A window [0, 10); spans every 0.25 s from -2 to 12 s: queued i ms,
    prefill 2i ms, a step of 50 ms holding a dispatch of 20 ms (drained
    True, False, None in turn) and a fetch wait of 4 ms on every other
    step."""
    out = []
    for i in range(56):
        t = -2.0 + 0.25 * i
        out.append(Span("queued", i, t, t + 1e-3 * i))
        out.append(Span("prefill", i, t, t + 2e-3 * i))
        step = Span("step", None, t, t + 0.05)
        out.append(Span("dispatch", None, t, t + 0.02, step,
                        {"drained": (True, False, None)[i % 3]}))
        if i % 2:
            out.append(Span("fetch_wait", None, t + 0.03, t + 0.034, step))
        out.append(step)
    return out


def test_span_readers_on_a_window(monkeypatch):
    kept = synthetic()
    fake_recorder(monkeypatch, kept)
    run = Run(t_open=0.0, t_close=10.0, setup_s=1.0)
    inside = [i for i in range(56) if 0.0 <= -2.0 + 0.25 * i < 10.0]
    assert len(inside) == 40
    m = {n: metric(n)(run) for n in NAMES}
    assert m["queue_wait_p95_ms.serve"] == pytest.approx(percentile(inside, 95))
    assert m["prefill_p95_ms.serve"] == pytest.approx(2 * percentile(inside, 95))
    assert m["dispatch_ms.serve"] == pytest.approx(20.0)
    waits = sum(1 for i in inside if i % 2)
    assert m["fetch_wait_ms.serve"] == pytest.approx(4.0 * waits / len(inside))
    drained = [(True, False, None)[i % 3] for i in inside]
    seen = [d for d in drained if d is not None]
    assert m["drained_share.serve"] == pytest.approx(100.0 * sum(seen) / len(seen))

    # no value where the window holds no spans, or where a card never answered
    for k in kept:
        if k.name == "dispatch":
            k.attrs["drained"] = None
    assert metric("drained_share.serve")(run) is None
    late = Run(t_open=20.0, t_close=30.0, setup_s=1.0)
    assert all(metric(n)(late) is None for n in NAMES)
    fake_recorder(monkeypatch, [])
    assert all(metric(n)(run) is None for n in NAMES)


def test_no_readings_without_the_window_or_the_recorder(monkeypatch):
    kept = [s for s in synthetic() if s.t0 >= 1.0]
    run = Run(t_open=0.0, t_close=10.0, setup_s=1.0)
    fake_recorder(monkeypatch, kept, maxlen=len(kept))      # the window's start was dropped
    assert all(metric(n)(run) is None for n in NAMES)
    fake_recorder(monkeypatch, kept, maxlen=len(kept) + 1)
    assert metric("dispatch_ms.serve")(run) == pytest.approx(20.0)
    fake_recorder(monkeypatch, None)                        # a program without the recorder
    assert all(metric(n)(run) is None for n in NAMES)


def test_tiny_chat_paged_reports_the_spans():
    trace.disable()
    trace.clear()
    result, _ = tiny_cells.run_tiny("qwen2-7b.chat-paged")
    assert not trace.enabled() and trace.spans() == []
    assert not set(NAMES) & set(result["metrics"])

    sys.modules.pop("benchmark.spans", None)     # the readers' import turns the recorder on
    result, _ = tiny_cells.run_tiny("qwen2-7b.chat-paged", trace=True)
    m = result["metrics"]
    for name in NAMES[:4]:
        assert name in m and m[name]["value"] >= 0.0, name
    assert m["prefill_p95_ms.serve"]["value"] > 0 and m["dispatch_ms.serve"]["value"] > 0
    assert "drained_share.serve" not in m
    assert result["correct"], result["checks"]
