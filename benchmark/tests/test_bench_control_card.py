"""On the card: at each cell's own size and load, for a short window, the
program comes out correct and the control (the reference one precision
lower, fp8 projection inputs, in the program's place) comes out not
correct, both judged by the comparison that decides a run's ``correct``.

    python -m pytest -m cuda -s benchmark/tests/test_bench_control_card.py
"""

import json

import pytest

import tiny_cells

CELLS = [w["name"] for w in tiny_cells.bench()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the control runs at the cells' own size)")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, workload):
    from benchmark.control import CONTROL, readings

    out = readings(workload, 2 ** 31 + 101, 10.0)
    print(json.dumps(out))
    assert out["served_tokens"] > 0
    assert out["program"]["correct"], out
    assert not out[CONTROL]["correct"], out
