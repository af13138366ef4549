"""The port's span recorder (tpu_llm_torch.runtime.trace) in the serving
engines on the CPU: off, it hands out one shared no-op object and records
nothing; on, every admitted request has one ``queued`` and one ``prefill``
span, children lie inside their parents, a step has one ``dispatch`` and at
most one ``fetch_wait``, ``drained`` is read only on a step that did not
drain the stream itself, and the served tokens are those of an untraced
run."""

import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tests.test_torch_batching import CFG, _weights_q4_0
from tpu_llm_torch.config import LlamaConfig
from tpu_llm_torch.runtime import batching as TB
from tpu_llm_torch.runtime import trace
from tpu_llm_torch.runtime.engine import ModelAdapter
from tpu_llm_torch.runtime.paged_engine import PagedEngine

SHARED = [5, 11, 8, 3, 9, 2, 7, 4, 6, 1, 30, 31, 32, 33, 34]   # +BOS = 16 ids
# (prompt, max_new, temperature, seed): a shared prefix, a prompt longer
# than two chunks, a sampled request, and more requests than slots
REQUESTS = [(SHARED + [40, 41], 5, 0.0, 0), (list(range(2, 30)), 4, 0.0, 0),
            (SHARED + [42, 43, 44], 6, 0.8, 123), ([9, 2, 40], 4, 0.8, 7),
            (SHARED[:9] + [50], 3, 0.0, 0)]


@pytest.fixture(scope="module")
def params():
    return _weights_q4_0()[1]


@pytest.fixture(autouse=True)
def recorder_off():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def make(params, kind):
    if kind == "paged":
        return PagedEngine(params, LlamaConfig(**CFG), batch=2, n_blocks=64, block_size=4,
                           max_seq=CFG["seq_len"], prefill_chunk=8, device="cpu")
    ad = ModelAdapter.llama(LlamaConfig(**CFG), device="cpu")
    return TB.BatchEngine(params, ad, batch=2, max_seq=CFG["seq_len"],
                          speculative_k=3 if kind == "spec" else 0)


def serve(eng, rows=None):
    """Submit REQUESTS, two before the first step and the rest after it,
    and step until every one is done; the requests. ``rows`` gets each
    step's live slots."""
    rows = [] if rows is None else rows
    reqs = [TB.Request(prompt=p, max_new=n, temperature=t, seed=s)
            for p, n, t, s in REQUESTS]
    for r in reqs[:2]:
        eng.submit(r)
    rows.append(eng.step())
    for r in reqs[2:]:
        eng.submit(r)
    while eng._queue or eng.n_active:
        rows.append(eng.step())
    rows.append(eng.step())     # reads the last in-flight step
    return reqs


def test_off_records_nothing(params, monkeypatch):
    assert trace.span("step") is trace.span("dispatch", 3) is trace.OFF
    assert trace.now() is None

    class NoClock:
        def perf_counter(self):
            raise AssertionError("the recorder read the clock while off")

    monkeypatch.setattr(trace, "time", NoClock())
    reqs = serve(make(params, "paged"))
    assert all(r.done and r.submitted is None for r in reqs)
    assert trace.spans() == []


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def children(spans, parent, name):
    return [s for s in spans if s.name == name and s.parent is parent]


@pytest.mark.parametrize("kind", ["paged", "dense", "spec"])
def test_spans_of_the_serving_step(params, kind):
    trace.enable()
    eng = make(params, kind)
    rows = []
    reqs = serve(eng, rows)
    spans = trace.spans()

    # one queued and one prefill a request, the wait ending where the prefill starts
    for r in reqs:
        (q,) = [s for s in by_name(spans, "queued") if s.rid == r.rid]
        (p,) = [s for s in by_name(spans, "prefill") if s.rid == r.rid]
        assert q.t0 == r.submitted and q.t1 == p.t0 and q.t0 <= q.t1
        assert q.parent is None and p.parent.name == "step"
    assert len(by_name(spans, "queued")) == len(by_name(spans, "prefill")) == len(reqs)

    # every child inside its parent, each kind under the parent it belongs to
    parents = {"prefill": ("step",), "dispatch": ("step",),
               "fetch_wait": ("step", "dispatch"), "step": (None,), "queued": (None,)}
    for s in spans:
        assert s.t0 <= s.t1
        assert (s.parent.name if s.parent else None) in parents[s.name], s
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, (s, s.parent)
    assert {s.name for s in spans} == set(parents)

    # one dispatch a step that decoded, at most one wait for tokens; no
    # ``drained`` without a card
    steps = by_name(spans, "step")
    assert len(steps) == len(rows)
    for st, n in zip(steps, rows):
        assert len(children(spans, st, "dispatch")) == (1 if n else 0), st
        inside = children(spans, st, "fetch_wait") + [
            s for d in children(spans, st, "dispatch") for s in children(spans, d, "fetch_wait")]
        assert len(inside) <= 1
    assert all(d.attrs.get("drained") is None for d in by_name(spans, "dispatch"))
    assert TB._stream_drained(torch.device("cpu")) is None


@pytest.mark.parametrize("kind", ["paged", "dense", "spec"])
def test_drained_is_read_only_where_the_step_did_not_sync(params, kind, monkeypatch):
    """With a card that always reports its stream drained, a dispatch notes
    ``drained`` exactly where its step ran no prefill and read no earlier
    step before it (the speculative engine reads the pipelined step first)."""
    monkeypatch.setattr(TB, "_stream_drained", lambda device: True)
    trace.enable()
    serve(make(params, kind))
    spans = trace.spans()
    seen = 0
    for st in by_name(spans, "step"):
        for d in children(spans, st, "dispatch"):
            synced = bool(children(spans, st, "prefill")) or kind == "spec"
            assert d.attrs.get("drained") is (None if synced else True), (st, d)
            seen += not synced
    assert seen > 0 or kind == "spec"


def test_deferred_admission_records_one_prefill(params):
    """A request that waits for blocks gets no span for the attempt: its
    ``queued`` runs to the admission that succeeds, steps later."""
    trace.enable()
    eng = PagedEngine(params, LlamaConfig(**CFG), batch=2, n_blocks=5, block_size=4,
                      max_seq=CFG["seq_len"], prefix_caching=False, device="cpu")
    reqs = [eng.submit(TB.Request(prompt=[5, 11, 8, 3, 9], max_new=6)),
            eng.submit(TB.Request(prompt=[7, 4, 2, 6, 1], max_new=6))]
    eng.run()
    spans = trace.spans()
    for r in reqs:
        (q,) = [s for s in by_name(spans, "queued") if s.rid == r.rid]
        (p,) = [s for s in by_name(spans, "prefill") if s.rid == r.rid]
        assert q.t1 == p.t0
    first, second = (next(s for s in by_name(spans, "prefill") if s.rid == r.rid)
                     for r in reqs)
    assert second.parent is not first.parent          # admitted a later step
    (wait,) = [s for s in by_name(spans, "queued") if s.rid == reqs[1].rid]
    between = [st for st in by_name(spans, "step") if wait.t0 <= st.t0 and st.t1 <= wait.t1]
    assert between and not any(children(spans, st, "prefill") for st in between[1:])


@pytest.mark.parametrize("kind", ["paged", "dense", "spec"])
def test_tracing_leaves_the_tokens(params, kind):
    want = [r.tokens for r in serve(make(params, kind))]
    trace.enable()
    got = [r.tokens for r in serve(make(params, kind))]
    assert got == want
    assert all(want) and trace.spans()
