"""No module of the benchmark imports JAX, jaxlib, flax or the JAX package
(``tpu_llm``), comparing the top-level module name whole, and the
reference imports nothing of the program (``tpu_llm_torch``)."""

import ast
import os
import sys

import pytest

import tiny_cells
from benchmark import run as run_py

BENCH = os.path.join(tiny_cells.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_llm"}


def imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(folder=BENCH):
    for root, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not imported_top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(BENCH, "reference"))),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_names(path)
    assert "tpu_llm_torch" not in names and not names & FORBIDDEN
    assert names <= {"__future__", "typing", "torch", "numpy", "math"}, names


def test_whole_name_comparison():
    assert imported_top_names(os.path.join(BENCH, "weights.py")) >= {"torch"}
    saved = dict(sys.modules)
    try:
        sys.modules["tpu_llm_torch_fake.x"] = sys.modules["os"]
        assert "tpu_llm" not in run_py.loaded_forbidden()
        sys.modules["tpu_llm.models"] = sys.modules["os"]
        assert run_py.loaded_forbidden() == ["tpu_llm"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
