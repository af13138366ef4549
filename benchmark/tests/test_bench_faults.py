"""A run of each cell on the CPU at a tiny size, past the harness's look for
a card: sound, it comes out correct; with the timed path broken underneath,
``correct`` comes out false. The faults a serving cell can have: a token
altered where it is produced, a step that leaves its state (the KV cache)
unchanged, half of the batch left out. (One chip: no exchange to drop.)"""

import contextlib

import pytest
import torch

import tiny_cells

CELLS = [w["name"] for w in tiny_cells.bench()["workloads"] + tiny_cells.LIBRARY]


@contextlib.contextmanager
def patched(*swaps):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, make in swaps:
            setattr(mod, name, make(getattr(mod, name)))
        yield
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)


def altered(fn):
    def wrapped(*a, **k):
        return (fn(*a, **k) + 1) % 256
    return wrapped


def token_altered():
    from tpu_llm_torch.runtime import batching, engine

    return patched((batching, "_sample_step", altered),
                   (engine, "select_token", altered),
                   (engine, "select_token_counter", altered))


def state_unchanged():
    from tpu_llm_torch.models import llama
    from tpu_llm_torch.runtime import paged_engine

    return patched((llama, "update_kv_cache", lambda f: lambda kc, vc, k, v, off: (kc, vc)),
                   (paged_engine, "_paged_update_fn",
                    lambda f: lambda kc, vc, k, v, off: (kc, None)))


def half_batch():
    from tpu_llm_torch.models import llama

    def make(fwd):
        def forward(params, cfg, tokens, cache, offset, *a, **k):
            x, cache = fwd(params, cfg, tokens, cache, offset, *a, **k)
            if tokens.shape[0] > 1:
                x = x.clone()
                x[tokens.shape[0] // 2:] = 0
            return x, cache
        return forward

    return patched((llama, "forward", make))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, traffic = tiny_cells.run_tiny(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert traffic["requests"] == result["attempted"]
    assert result["metrics"]["output_tok_s"]["value"] > 0


# a single stream decodes one row: it has no half of a batch to leave out
CASES = [(w, f) for w in CELLS for f in (token_altered, state_unchanged, half_batch)
         if not (f is half_batch and "scan" in w)]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{f.__name__}-{w}" for w, f in CASES])
def test_broken_path_is_not_correct(workload, fault):
    with fault():
        result, _ = tiny_cells.run_tiny(workload)
    assert not result["correct"], result["checks"]


def test_traced_run_reports_the_host_readings():
    result, _ = tiny_cells.run_tiny("qwen2-7b.chat-paged", trace=True)
    m = result["metrics"]
    for name in ("gen_lag_p95_ms", "engine_step_ms.serve", "rows_per_step.serve",
                 "prefix_hit_share", "kv_blocks_peak_share", "mfu"):
        assert name in m, name
    assert "output_tok_s" not in m and list(result)[-1] == "checks"
    torch.testing.assert_close(result["device"]["busy_s"], 0.0)
