"""The port stands alone: importing tpu_llm_torch pulls in neither JAX nor
the JAX package, builds no kernel, and no file of the port (or
chip_smoke.py) imports them."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "tpu_llm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import tpu_llm_torch
names = [m.name for m in pkgutil.walk_packages(tpu_llm_torch.__path__, "tpu_llm_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "tpu_llm" or m.startswith("tpu_llm."))
from tpu_llm_torch.kernels import build
print(json.dumps({"modules": len(names), "bad": bad,
                  "built": build._lib is not None or build.build_seconds is not None}))
"""


def test_import_leaves_jax_and_tpu_llm_out():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["modules"] >= 15, res
    assert res["bad"] == [], res
    assert not res["built"], res


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpu_llm_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "tpu_llm"}, (path, roots)
