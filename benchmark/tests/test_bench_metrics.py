"""The readers of the end-to-end metrics on a synthetic window: percentiles
over every request and every token, rates over the whole window, a stall
inside the window counted in full."""

import pytest

import tiny_cells  # noqa: F401
from benchmark import harness
from benchmark.record import Req, Run, percentile
from benchmark.traffic.generator import Spec


def metric(name):
    return harness.load_module("metrics", name).read


def synthetic() -> Run:
    """A 10 s window; 20 requests due every 0.5 s, each answered 0.1 s after
    its due time with 5 tokens 0.1 s apart, except during a stall from 5.0
    to 7.0 s in which nothing arrives; one request due at 9.9 s is never
    answered."""
    run = Run(t_open=0.0, t_close=10.0, setup_s=3.0)
    run.t_end = 12.0
    for i in range(20):
        due = 0.5 * i
        times = [due + 0.1 * (j + 1) for j in range(5)]
        times = [t if not 5.0 <= t < 7.0 else 7.0 + 0.01 * k for k, t in enumerate(times)]
        times = sorted(times)
        run.requests.append(Req(spec=Spec(i, [1] * 8, 5), due=due, sent=due + 0.001 * i,
                                n_in=9, times=times, tokens=[3] * 5, done=True))
    run.requests.append(Req(spec=Spec(20, [1] * 8, 5), due=9.9, sent=9.9, n_in=9))
    run.requests.append(Req(spec=Spec(21, [1] * 8, 5), due=10.5, sent=10.5, n_in=9,
                            times=[10.6], tokens=[3]))
    return run


def test_percentile_is_nearest_rank_over_all_values():
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([5.0], 95) == 5.0
    assert percentile(list(range(1, 21)), 95) == 19
    assert percentile([], 95) is None


def test_output_rate_counts_every_token_over_the_whole_window():
    run = synthetic()
    in_window = sum(1 for r in run.requests for t in r.times if 0.0 <= t < 10.0)
    assert in_window == 100 - 1     # the last request's last token lands at 10.0
    assert metric("output_tok_s")(run) == pytest.approx(in_window / 10.0)


def test_ttft_tail_holds_the_stall_and_the_unanswered():
    run = synthetic()
    ttft = metric("ttft_p95_ms")(run)
    # 21 requests due in the window: the unanswered one waits until the
    # run ended (12.0 - 9.9 = 2.1 s), the request due at 5.0 s waits out the
    # stall (2.0 s)
    assert ttft == pytest.approx(2000.0)
    # answered at once, it leaves the stall's 2.0 s and 1.5 s on top
    run.requests[20].times, run.requests[20].tokens = [9.95], [3]
    assert metric("ttft_p95_ms")(run) == pytest.approx(1500.0)
    assert run.attempted() == 21


def test_itl_tail_holds_the_stall():
    run = synthetic()
    itl = metric("itl_p95_ms")(run)
    gaps = [b - a for r in run.requests for a, b in zip(r.times, r.times[1:])
            if 0.0 <= b < 10.0]
    # the request due at 4.5 s: its 4.9 s token, then the stall, then 7.04 s
    assert max(gaps) == pytest.approx(2.14)
    assert itl == pytest.approx(1e3 * percentile(gaps, 95))
    assert itl > 100.0


def test_setup_and_generator_lag():
    run = synthetic()
    assert metric("setup_s")(run) == 3.0
    # lags 0, 1, ..., 19 ms and the unanswered request's 0: the 20th of 21
    assert metric("gen_lag_p95_ms")(run) == pytest.approx(18.0)


def test_step_and_counter_readers():
    run = synthetic()
    run.steps = [(0.1 * i, 0.1 * i + 0.05, 8 if i % 2 else 4) for i in range(120)]
    assert metric("engine_step_ms.serve")(run) == pytest.approx(50.0)
    assert metric("rows_per_step.serve")(run) == pytest.approx(6.0)
    run.counters = dict(hits_open=10, hits_close=30, block_size=16, prompt_tokens=1280,
                        pool_blocks=100, blocks_peak=40)
    assert metric("prefix_hit_share")(run) == pytest.approx(25.0)
    assert metric("kv_blocks_peak_share")(run) == pytest.approx(40.0)


def test_device_readers_need_a_trace():
    run = synthetic()
    for name in ("k1_roofline", "attn_roofline", "mfu", "device_idle_share",
                 "kernels_per_token"):
        assert metric(name)(run) is None
    run.trace = dict(busy_s=0.0, window_s=2.0, t0=1.0, t1=3.0, kernels=0, totals={},
                     idle={}, k1=[], attn=[], forward_s=0.0)
    for name in ("k1_roofline", "attn_roofline", "mfu", "device_idle_share",
                 "kernels_per_token"):
        assert metric(name)(run) is None, name
    run.trace.update(busy_s=1.5, kernels=300,
                     totals={"void qmm_tc_kernel<1>(Args)": 0.5,
                             "void flash_decode_split_kernel<2>(A)": 0.1},
                     k1=[(0.0, 3.35e11)], attn=[(6.7e12, 0.0, "f32")], forward_s=0.4)
    assert metric("k1_roofline")(run) == pytest.approx(20.0)
    assert metric("attn_roofline")(run) == pytest.approx(100.0)
    assert metric("mfu")(run) == pytest.approx(20.0)
    assert metric("device_idle_share")(run) == pytest.approx(25.0)
    toks = sum(1 for r in run.requests for t in r.times if 1.0 <= t < 3.0)
    assert metric("kernels_per_token")(run) == pytest.approx(300 / toks)


def test_chat_readers():
    run = synthetic()
    run.chats = [(1.0, 3.0, 0.2, 1.5, 150), (3.0, 6.0, 0.4, 2.5, 250),
                 (11.0, 12.0, 9.0, 9.0, 9)]
    assert metric("ttft_p50_ms.chat")(run) == pytest.approx(300.0)
    assert metric("graph_step_ms.chat")(run) == pytest.approx(10.0)
