"""One benchmark cell, driven by data: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and metrics, and the harness finds each by name
in a file of its own:

- ``configs/<config>.json``: the model's published config and its cut;
  its ``arch`` names the architecture module ``arch/<arch>.py``, through
  which the harness reaches everything that depends on the model's
  architecture (weights, the program's model and engines, the reference,
  the forward's cost, the kernel entries to wrap; see ``arch/llama.py``);
- ``traffic/<mix>.json``: the mix's parameters, read by the one generator
  (``traffic/generator.py``); its ``entry`` names the module under
  ``entries/`` that drives the program with it;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)`` -> a number,
  or None where the run has nothing for it to read;
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct``.

An entry builds the program around the benchmark's weights, warms up the
cell's own shapes, opens the window, drives the traffic for ``seconds``,
closes it, and returns the run's record (``record.Run``). Then the
harness reads the peak memory, frees the program and checks a sample of
what the window produced against the plain reference (``check.py``).

With ``trace`` the entry also runs ``torch.profiler`` over a sub-window
(``Tracer``) while a ``Recorder`` notes the shape of every kernel call,
by kind, the work of every forward and the host spans; the per-layer
metrics read those. Without it nothing is wrapped.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional

from benchmark import roofline
from benchmark.record import Run
from benchmark.traffic import generator

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# where ``load_module`` looks for ``<folder>/<name>.py``, in order (the
# tests put a directory of their own first)
PLACES = [HERE]
GAP_MIN_S = 20e-6            # device gaps shorter than this are launch spacing, not idle
BREAKDOWN_ROWS = 10
# what an architecture module has to define (``arch/llama.py`` documents each)
ARCH_NAMES = ("dims", "draw", "port_params", "port_config", "adapter", "paged_engine",
              "logits_at", "forward_cost", "attention_sites", "router_site")
# the attention entries (K2-K6) by their names in ops/flash_attention.py:
# how the Recorder reads a call's shape (decode: one query row a batch
# row; appended: K3 also writes the row; paged: through a block table)
ATTN_ENTRIES = {"flash_decode_attention": "decode", "flash_decode_fused": "appended",
                "paged_flash_decode_attention": "paged", "flash_gqa_attention": "prefill"}


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void tlt::flash_decode_split_kernel<...>(...)`` ->
    ``tlt::flash_decode_split_kernel``."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    name = name.replace("(anonymous namespace)::", "")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module (names may hold dots)."""
    paths = [os.path.join(d, folder, f"{name}.py") for d in PLACES]
    path = next((p for p in paths if os.path.isfile(p)), paths[-1])
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ArchError(Exception):
    """A configuration whose ``arch`` names no usable architecture module."""


def load_arch(cfg_file: dict):
    """The architecture module that a configuration file names (``arch``)."""
    name = cfg_file.get("arch")
    where = f"configuration {cfg_file.get('name')!r}"
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", name):
        raise ArchError(f"{where} names no architecture: its top-level 'arch' is {name!r}")
    if not any(os.path.isfile(os.path.join(d, "arch", f"{name}.py")) for d in PLACES):
        known = sorted(f[:-3] for d in PLACES if os.path.isdir(os.path.join(d, "arch"))
                       for f in os.listdir(os.path.join(d, "arch")) if f.endswith(".py"))
        raise ArchError(f"{where} names the architecture {name!r}, which has no module "
                        f"benchmark/arch/{name}.py (there are: {', '.join(known) or 'none'})")
    mod = load_module("arch", name)
    missing = [n for n in ARCH_NAMES if not hasattr(mod, n)]
    if missing:
        raise ArchError(f"benchmark/arch/{name}.py lacks {', '.join(missing)}")
    unknown = [n for _, n in mod.attention_sites if n not in ATTN_ENTRIES]
    if unknown:
        raise ArchError(f"benchmark/arch/{name}.py: no attention entry is named "
                        f"{', '.join(unknown)} (known: {', '.join(ATTN_ENTRIES)})")
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones; a metric without ``workloads`` belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


# -- tracing ---------------------------------------------------------------------

class Recorder:
    """The shapes of the program's kernel calls, the forwards' work and the
    host's spans, while ``active``. Calls made while a CUDA graph captures
    are kept as that graph's template and counted again at each replay.

    ``calls`` holds each kind's calls, as its ``cost(positions)`` gave them:
    ``k1`` (ops, bytes) of K1, ``attn`` (ops, bytes, peak) of K2-K6, and
    whatever kinds the architecture module's ``wrap`` notes."""

    def __init__(self, d: dict, arch):
        self.d = d
        self.arch = arch
        self.active = False
        self.calls: Dict[str, List[tuple]] = {"k1": [], "attn": []}
        self.forward_s = 0.0             # summed bound time of the forwards
        self.spans: List[tuple] = []     # (name, t0, t1) host perf_counter
        self.pos_hint: Optional[List[int]] = None   # decode positions of this step
        self.graph_pos = 0               # next position a replayed decode step runs at
        self._template: Optional[list] = None

    def note(self, kind: str, cost: Callable) -> None:
        """One kernel call of ``kind``; ``cost(positions)`` gives what is kept.
        Positions are resolved when the call is counted: at once for an
        eager call, at each replay for a captured one."""
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            if self._template is not None:
                self._template.append((kind, cost))
        elif self.active:
            self._count(kind, cost, self.pos_hint)

    def _count(self, kind, cost, positions):
        self.calls.setdefault(kind, []).append(cost(positions))

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.active:
                self.spans.append((name, t0, time.perf_counter()))

    def forward(self, groups, logit_rows: int, kv_bytes: int, act_peak: str) -> None:
        if self.active:
            self.forward_s += self.arch.forward_cost(self.d, groups, logit_rows, kv_bytes,
                                                     act_peak)

    def install(self) -> None:
        """Wrap the port's kernel entries (K1; K2-K6 where the architecture
        module's ``attention_sites`` say the model calls them) and its graph
        capture, then let the module wrap kernels of its own."""
        from tpu_llm_torch.quant import linear
        from tpu_llm_torch.runtime import graphs

        rec = self
        k1 = linear.qmatmul

        def qmatmul(x, qt, out_dtype=None, row_scale=None):
            out_dtype = out_dtype or x.dtype
            K, N = qt.shape[-2], qt.shape[-1]
            rows = x.numel() // x.shape[-1]
            args = (rows, K, N, x.element_size(), out_dtype.itemsize, qt.nbytes)
            rec.note("k1", lambda _p: roofline.k1_call(*args))
            return k1(x, qt, out_dtype=out_dtype, row_scale=row_scale)

        linear.qmatmul = qmatmul

        def decode(orig, paged=False, appended=False):
            def fn(q, kc, vc, *rest):
                B, _, H, D = q.shape
                plane = kc.shape[-1]
                Hkv = plane // D
                kvb = kc.element_size()
                shape = (H, Hkv, D, q.element_size(), kvb)

                def cost(pos):
                    pos = list(pos if pos is not None else [0] * B)[:B]
                    pos += [0] * (B - len(pos))
                    ops, nb = roofline.decode_attn_call(
                        pos, *shape, table_bytes=4 if paged else 0,
                        block=kc.shape[1] if paged else 0, appended=appended)
                    return ops, nb, roofline.attn_peak(shape[3], kvb)

                rec.note("attn", cost)
                return orig(q, kc, vc, *rest)
            return fn

        def prefill(orig):
            def fn(q, kc, vc, offset):
                B, T, H, D = q.shape
                Hkv = kc.shape[2] if kc.dim() == 4 else kc.shape[-1] // D
                args = (B, T, int(offset), H, Hkv, D, q.element_size(), kc.element_size())
                peak = roofline.attn_peak(q.element_size(), kc.element_size())
                rec.note("attn", lambda _p: (*roofline.prefill_attn_call(*args), peak))
                return orig(q, kc, vc, offset)
            return fn

        wraps = {"decode": decode, "appended": lambda f: decode(f, appended=True),
                 "paged": lambda f: decode(f, paged=True), "prefill": prefill}
        for module, name in self.arch.attention_sites:
            mod = importlib.import_module(module)
            setattr(mod, name, wraps[ATTN_ENTRIES[name]](getattr(mod, name)))
        base = graphs.CapturedStep

        class CapturedStep(base):
            def __init__(self, fn, device, warmup: int = 1):
                rec._template = []
                try:
                    super().__init__(fn, device, warmup)
                finally:
                    self._bench_calls, rec._template = rec._template, None

            def __call__(self):
                super().__call__()
                if rec.active:
                    pos = [rec.graph_pos]
                    for kind, cost in self._bench_calls:
                        rec._count(kind, cost, pos)
                rec.graph_pos += 1

        graphs.CapturedStep = CapturedStep
        if hasattr(self.arch, "wrap"):
            self.arch.wrap(self)


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start loads
    CUPTI, which took seconds on the card and, inside the window, held
    the traffic back and cut the traced span short."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Tracer:
    """torch.profiler (device activity only) over [t_from, t_to) of the
    host clock, started and stopped between units of work, each after a
    synchronize so that the device ops inside belong to the work recorded."""

    def __init__(self, rec: Recorder, t_from: float, t_to: float, on_card: bool = True):
        self.rec, self.t_from, self.t_to = rec, t_from, t_to
        self.on_card = on_card      # on the CPU (tests) only the host side is recorded
        self.prof = None
        self.done = False
        self.t0 = self.t1 = None

    def tick(self, now: float) -> None:
        import torch

        if self.done:
            return
        if self.prof is None and now >= self.t_from:
            from torch.profiler import ProfilerActivity, profile

            self.prof = contextlib.nullcontext()
            if self.on_card:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.anchor = (time.time_ns(), time.perf_counter())
            self.t0 = time.perf_counter()
            self.rec.active = True
        elif self.prof is not None and now >= max(self.t_to, self.t0 + self.t_to - self.t_from):
            self.stop()

    def stop(self) -> None:
        import torch

        if self.prof is None or self.done:
            return
        if self.on_card:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.rec.active = False
        self.prof.__exit__(None, None, None)
        self.done = True

    def read(self) -> dict:
        """The device ops of the traced sub-window: busy seconds, kernel count,
        seconds by kernel, idle seconds by the host span they fell in."""
        ns0, pc0 = self.anchor
        ops = []
        events = self.prof.profiler.kineto_results.events() if self.on_card else []
        for e in events:
            if e.device_type().name != "CUDA":
                continue
            t = pc0 + (e.start_ns() - ns0) / 1e9
            ops.append((t, e.duration_ns() / 1e9, e.name()))
        ops.sort()
        window = self.t1 - self.t0
        busy, totals, end, kernels = 0.0, {}, None, 0
        gaps = []
        for t, dur, name in ops:
            totals[short_name(name)] = totals.get(short_name(name), 0.0) + dur
            kernels += not name.startswith(("Memcpy", "Memset"))
            if end is None or t >= end:
                busy += dur
                if end is not None and t - end > GAP_MIN_S:
                    gaps.append((end, t))
                end = t + dur
            elif t + dur > end:
                busy += t + dur - end
                end = t + dur
        if ops:
            first, last = ops[0][0], end
            if first - self.t0 > GAP_MIN_S:
                gaps.append((self.t0, first))
            if self.t1 - last > GAP_MIN_S:
                gaps.append((last, self.t1))
        idle: Dict[str, float] = {}
        for a, b in gaps:
            label = self._label((a + b) / 2)
            idle[label] = idle.get(label, 0.0) + (b - a)
        return {"busy_s": busy, "window_s": window, "t0": self.t0, "t1": self.t1,
                "kernels": kernels, "totals": totals, "idle": idle}

    def _label(self, t: float) -> str:
        """The innermost host span at time t."""
        best = None
        for name, a, b in self.rec.spans:
            if a <= t < b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "between spans"


# -- the cell ----------------------------------------------------------------------

class Context:
    """What an entry needs: the configuration (Hugging Face dict, its
    architecture module ``arch``, sizes, the port's config), the weights
    (raw and as the port's parameters), the mix and its request stream, and
    the window's clock."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cfg_file = cfg_file
        self.cfg = cfg_file["config"]
        self.arch = load_arch(cfg_file)
        self.d = self.arch.dims(self.cfg)
        self.mix = mix
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.raw = self.arch.draw(self.cfg, seed, device)
        self.params = self.arch.port_params(self.raw)
        self.pcfg = self.arch.port_config(self.cfg)
        self.specs = generator.stream(mix, cfg_file["token_ids"], seed)
        self.rec = Recorder(self.d, self.arch) if trace else None
        self.tracer: Optional[Tracer] = None
        if trace:
            self.rec.install()
            if device == "cuda":
                warm_profiler()

    @property
    def bos_id(self) -> int:
        return int(self.cfg["bos_token_id"])

    @property
    def eos_id(self) -> int:
        return int(self.cfg["eos_token_id"])

    def span(self, name: str):
        return self.rec.span(name) if self.rec is not None else contextlib.nullcontext()

    def attn_peak(self, kv_bytes: int) -> str:
        """The peak attention runs against: bf16 where q and the cache are
        both bf16 (Qwen2's f32 biases make its q f32), else f32."""
        return "f32" if self.d["bias"] or kv_bytes == 4 else "bf16"

    def open_window(self, t_open: float, length: Optional[float] = None) -> float:
        """The window opens at ``t_open``; the traced sub-window is its last
        ``trace_s`` seconds, so that stopping the profiler and reading its
        events delay no request of the window. A fixed job, whose window is
        as long as its work takes, gives the ``length`` it traces up to."""
        if self.trace:
            length = self.seconds if length is None else length
            span = min(length, float(self.mix.get("trace_s", length)))
            end = t_open + length
            self.tracer = Tracer(self.rec, end - span, end, self.device == "cuda")
        return t_open

    def tick(self, now: float) -> None:
        if self.tracer is not None:
            self.tracer.tick(now)

    def finish_trace(self) -> Optional[dict]:
        """Stop the profiler if it still runs, and read what it traced."""
        if self.tracer is None or self.tracer.prof is None:
            return None
        self.tracer.stop()
        calls = self.rec.calls
        return dict(self.tracer.read(), k1=calls["k1"], attn=calls["attn"], calls=calls,
                    forward_s=self.rec.forward_s)


def cell_files(bench: dict, workload: str):
    """(configuration file, mix, limits) of a cell, read from its files."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (load_json(ROOT, cfg_entry["file"]), generator.load_mix(cell["traffic"]),
            load_json(HERE, "limits", f"{workload}.json"))


def run_program(ctx: Context, entry) -> Run:
    """Drive the program through the cell's entry, read the trace and the
    peak memory, then free the program's state (its weights stay: they are
    the benchmark's), so that the reference runs in what is left."""
    import torch

    run: Run = entry.run(ctx)
    run.trace = ctx.finish_trace()
    on_card = ctx.device == "cuda"
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() if on_card else 0
    run.release()
    ctx.params = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return run


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             files: Optional[tuple] = None):
    """Run one cell: (the result for the last stdout line, the drawn
    distribution of the window's requests). ``files`` replaces what
    ``cell_files`` reads (the tests run tiny configurations on the CPU)."""
    import torch

    from benchmark import check

    t_start = time.perf_counter() if t_start is None else t_start
    cfg_file, mix, limits = files or cell_files(bench, workload)
    entry = load_module("entries", mix["entry"])
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_module("metrics", m["name"]) for m in metrics}

    ctx = Context(cfg_file, mix, seed, seconds, trace, device, t_start)
    run = run_program(ctx, entry)
    on_card = device == "cuda"
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    numbers = check.check(ctx.arch, ctx.cfg, ctx.raw, run, mix, limits, seed)
    correct = check.verdict(numbers)
    traffic = generator.describe([r.spec for r in run.requests if run.in_window(r)])
    result = {"correct": correct, "attempted": run.attempted(), "failed": run.failed(),
              "metrics": values,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}}
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace["busy_s"]
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in run.trace["totals"].items()),
                                 key=lambda r: -r[1])[:BREAKDOWN_ROWS],
            "idle_gaps": sorted(([k, v] for k, v in run.trace["idle"].items()),
                                key=lambda r: -r[1])[:BREAKDOWN_ROWS]}
    result["checks"] = numbers
    return result, traffic
