"""The benchmark of tpu_llm_torch: one cell a run (``run.py``), driven by
``BENCHMARK.json`` and the files it names (see ``harness.py``)."""
