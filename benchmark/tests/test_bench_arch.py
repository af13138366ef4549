"""The architecture modules (``benchmark/arch/``) on the CPU.

- The llama family's module gives the numbers the harness gave before it
  had one: the same checks (``max_gap``, ``route_gap``, ``router_gap``)
  of a tiny run as the plain reference called directly, bit for bit; the
  same forward costs at Qwen2-7B's and Mixtral-8x7B's widths; the same
  program (adapter, paged engine).
- A configuration without a usable ``arch`` fails loudly, and ``run.py``
  exits 2 for it with no result.
- A second architecture given only as new files (a module under a
  directory the loader is pointed at, a model module of the program's
  shape, metric readers) runs the tiny batch and scan cells end to end:
  the Recorder wraps its attention sites and notes its own kernel's calls
  under a kind it declares, and a metric file reads them.
- A static guard: outside the llama family's own files, no module of the
  harness reaches the llama model, its engines, weights or reference
  except through an architecture module.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import tiny_cells
from benchmark import check, harness, roofline, weights
from benchmark.reference import model as reference

BENCH = os.path.join(tiny_cells.ROOT, "benchmark")
SEED = 2 ** 31 + 41
LLAMA = harness.load_arch(tiny_cells.tiny_config("qwen2-7b"))


def parent_judged(cfg, raw, run, mix, limits, seed, controls=()):
    """``check.judged`` as it was before the architecture modules: the
    plain reference called directly."""
    reqs = check.sample(run, mix["check"]["served_tokens"], seed)
    overrun = sum(len(r.tokens) > r.spec.max_new for r in run.requests)
    routed = run.routes is not None
    keys = ("max_gap", "route_gap", "router_gap") if routed else ("max_gap",)
    found = {a: dict.fromkeys(keys, check.NO_SAMPLE) for a in (None, *controls)}
    seqs, spans, served = check.sequences(reqs, int(cfg["bos_token_id"]))
    got = [run.routes.of(r.rid, len(s)) for r, s in zip(reqs, seqs)] if routed else None
    if reqs and not (routed and any(x is None for x in got)):
        k = int(cfg.get("num_experts_per_tok", 0))
        routes = [g[:2] for g in got] if routed else None
        rl = [] if routed else None
        ref = reference.logits_at(cfg, raw, seqs, spans, "f32", routes, rl)
        found[None]["max_gap"] = check.gaps(ref, [torch.tensor(s) for s in served]).max().item()
        if routed:
            found[None]["route_gap"], found[None]["router_gap"] = check.router_gaps(
                rl, [torch.cat([g[2][li] for g in got]) for li in range(len(rl))], k)
        for act in controls:
            low_rl = [] if routed else None
            low = reference.logits_at(cfg, raw, seqs, spans, act, routes, low_rl)
            found[act]["max_gap"] = check.gaps(
                ref, [lg.argmax(dim=-1) for lg in low]).max().item()
            if routed:
                found[act]["route_gap"], found[act]["router_gap"] = check.router_gaps(
                    rl, low_rl, k)
    return {act: {**{n: {"value": v, "limit": limits[n]} for n, v in nums.items()},
                  "overrun": {"value": overrun, "limit": 0}}
            for act, nums in found.items()}


def tiny_run(config, traffic, trace=False):
    """A tiny run on the CPU: (run, context, mix)."""
    cfg_file, mix = tiny_cells.tiny_config(config), tiny_cells.tiny_mix(traffic)
    ctx = harness.Context(cfg_file, mix, SEED, 3.0, trace, "cpu", 0.0)
    run = harness.run_program(ctx, harness.load_module("entries", mix["entry"]))
    return run, ctx, mix


# -- the llama family's numbers are the parent's ----------------------------------

CELLS = [("qwen2-7b", "chat-paged"), ("qwen2-7b", "chat-scan"),
         ("mixtral-8x7b", "batch16"), ("mixtral-8x7b", "chat-scan")]


@pytest.mark.parametrize("config,traffic", CELLS, ids=[f"{c}.{t}" for c, t in CELLS])
def test_checks_equal_the_direct_reference(config, traffic):
    run, ctx, mix = tiny_run(config, traffic)
    assert ctx.arch.logits_at is reference.logits_at
    got = check.judged(ctx.arch, ctx.cfg, ctx.raw, run, mix, tiny_cells.TINY_LIMIT, SEED,
                       ("fp8",))
    want = parent_judged(ctx.cfg, ctx.raw, run, mix, tiny_cells.TINY_LIMIT, SEED, ("fp8",))
    assert got == want
    assert got[None]["max_gap"]["value"] < check.NO_SAMPLE
    # routes are recorded by the batch entry (a captured graph keeps none)
    assert ("route_gap" in got[None]) == (traffic == "batch16")
    assert check.check(ctx.arch, ctx.cfg, ctx.raw, run, mix, tiny_cells.TINY_LIMIT,
                       SEED) == want[None]


GROUPS = [[(0, 512)], [(999, 1)], [(p, 1) for p in range(0, 3000, 97)],
          [(256, 512), (0, 64), (1500, 7)], [(0, 1)] * 16, [(2047, 1), (0, 2048)]]


@pytest.mark.parametrize("name", ["qwen2-7b", "mixtral-8x7b"])
def test_forward_cost_equals_the_old_call(name):
    cfg = harness.load_json(BENCH, "configs", f"{name}.json")["config"]
    d = LLAMA.dims(cfg)
    assert d == weights.dims(cfg)
    for groups in GROUPS:
        for logit_rows in (0, 1, len(groups)):
            for kv_bytes, peak in ((2, "bf16"), (2, "f32"), (4, "f32")):
                assert LLAMA.forward_cost(d, groups, logit_rows, kv_bytes, peak) == \
                    roofline.forward_cost(weights.dims(cfg), groups, logit_rows, kv_bytes, peak)
    rec = harness.Recorder(d, LLAMA)
    rec.forward(GROUPS[2], 1, 2, "bf16")
    assert rec.forward_s == 0.0                      # inactive: nothing counted
    rec.active = True
    for groups in GROUPS:
        rec.forward(groups, 1, 2, "bf16")
    assert rec.forward_s == sum(roofline.forward_cost(d, g, 1, 2, "bf16") for g in GROUPS)


@pytest.mark.parametrize("name", ["qwen2-7b", "mixtral-8x7b"])
def test_adapter_is_the_programs_llama_adapter(name):
    from tpu_llm_torch.runtime.engine import ModelAdapter

    cfg = tiny_cells.tiny_config(name)["config"]
    params = LLAMA.port_params(LLAMA.draw(cfg, SEED, "cpu"))
    params["tok_emb"] = params["tok_emb"].float()
    pcfg = LLAMA.port_config(cfg)
    ours = LLAMA.adapter(pcfg, torch.float32, 1, "cpu")
    theirs = ModelAdapter.llama(pcfg, torch.float32, bos_id=1, device="cpu")
    assert (ours.bos_id, ours.vocab_size, ours.positional_state) == \
           (theirs.bos_id, theirs.vocab_size, theirs.positional_state)
    toks = torch.randint(3, 250, (2, 9), generator=torch.Generator().manual_seed(3))
    out = []
    for a in (ours, theirs):
        x, _ = a.apply(params, toks, a.init_state(2, 32), 0)
        out.append(a.lm_head(params, x))
    assert torch.equal(out[0], out[1])


def test_k1_kernels_match_both_bodies_and_nothing_else():
    names = ["qmm_tc_kernel", "qmm_tc_kernel_decode", "tlt::flash_decode_split_kernel",
             "flash_prefill_kernel", "ffn_tc_kernel", "at::native::elementwise_kernel",
             "at::native::vectorized_elementwise_kernel", "at::native::reduce_kernel",
             "at_cuda_detail::cub::DeviceRadixSortOnesweepKernel",
             "at::native::CatArrayBatchedCopy_vectorized", "elementwise_kernel_with_index"]
    k1 = [n for n in names if any(k in n for k in roofline.K1_KERNELS)]
    assert k1 == ["qmm_tc_kernel", "qmm_tc_kernel_decode"]
    attn = [n for n in names if any(k in n for k in roofline.ATTN_KERNELS)]
    assert attn == ["tlt::flash_decode_split_kernel", "flash_prefill_kernel"]


def test_traced_run_keeps_k1_and_attn_under_their_names():
    run, _, _ = tiny_run("qwen2-7b", "chat-scan", trace=True)
    t = run.trace
    assert t["k1"] is t["calls"]["k1"] and t["attn"] is t["calls"]["attn"]
    assert t["k1"] and t["attn"] and t["forward_s"] > 0
    assert all(len(c) == 2 for c in t["k1"]) and all(len(c) == 3 for c in t["attn"])


# -- a configuration without a usable architecture ----------------------------------

@pytest.mark.parametrize("arch,says", [(None, "names no architecture"),
                                       ("nope", "'nope', which has no module"),
                                       ("../arch/llama", "names no architecture"),
                                       (7, "names no architecture")])
def test_unknown_arch_fails_loudly(arch, says):
    cfg_file = tiny_cells.tiny_config("qwen2-7b")
    cfg_file.pop("arch")
    if arch is not None:
        cfg_file["arch"] = arch
    with pytest.raises(harness.ArchError, match=says):
        harness.load_arch(cfg_file)
    with pytest.raises(harness.ArchError):
        harness.Context(cfg_file, tiny_cells.tiny_mix("chat-scan"), SEED, 1.0, False, "cpu", 0.0)


def test_a_module_without_the_contract_fails_loudly(tmp_path, monkeypatch):
    (tmp_path / "arch").mkdir()
    (tmp_path / "arch" / "half.py").write_text("from benchmark import weights\n"
                                              "dims = weights.dims\n")
    (tmp_path / "arch" / "odd.py").write_text(
        open(os.path.join(BENCH, "arch", "llama.py")).read()
        + "\nattention_sites = ((MODEL, 'flash_something'),)\n")
    monkeypatch.setattr(harness, "PLACES", [str(tmp_path), harness.HERE])
    with pytest.raises(harness.ArchError, match="lacks draw, port_params"):
        harness.load_arch({"name": "x", "arch": "half"})
    with pytest.raises(harness.ArchError, match="flash_something"):
        harness.load_arch({"name": "x", "arch": "odd"})


def checkout(tmp_path, arch="keep"):
    """A directory holding only BENCHMARK.json and benchmark/, with the
    first cell's configuration naming ``arch`` (None: no key)."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    shutil.copy(os.path.join(tiny_cells.ROOT, "BENCHMARK.json"), root)
    bench = tiny_cells.bench()
    cell = bench["workloads"][0]
    cfg_path = root / next(c["file"] for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads(cfg_path.read_text())
    if arch is None:
        cfg.pop("arch")
    elif arch != "keep":
        cfg["arch"] = arch
    cfg_path.write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell["name"],
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=300)
    return p


@pytest.mark.parametrize("arch,says", [("nope", "'nope', which has no module"),
                                       (None, "names no architecture"),
                                       ("keep", "run.py: ")])
def test_run_exits_2_without_a_result(tmp_path, arch, says):
    p = checkout(tmp_path, arch)
    assert p.returncode == 2, p.stderr
    assert p.stdout == ""
    assert says in p.stderr
    if arch == "keep":          # here: no card; on the card: no program
        assert "CUDA" in p.stderr or "tpu_llm_torch is missing" in p.stderr


# -- a second architecture from new files only ------------------------------------

STUB_ARCH = '''"""A second architecture for the tests: the llama family's weights,
reference and costs, served by a model module of its own (``stub_model``,
the program's model under another name), whose norms are noted as a
kernel of a kind of their own (``norm``)."""

from benchmark import roofline, weights
from benchmark.reference import model as reference

MODEL = "stub_model"
dims = weights.dims
draw = weights.draw
port_params = weights.port_params
port_config = weights.port_config
logits_at = reference.logits_at
forward_cost = roofline.forward_cost
attention_sites = ((MODEL, "flash_decode_attention"), (MODEL, "flash_decode_fused"),
                   (MODEL, "flash_gqa_attention"))
router_site = (MODEL, "matmul")


def adapter(pcfg, cache_dtype, bos_id, device):
    import stub_model as M
    from tpu_llm_torch.runtime.engine import ModelAdapter

    return ModelAdapter(
        apply=lambda params, tokens, state, offset, length=None: M.forward(
            params, pcfg, tokens, state, offset),
        lm_head=lambda params, hidden: M.lm_head(params, pcfg, hidden),
        init_state=lambda batch, max_seq: M.init_cache(pcfg, batch, max_seq, cache_dtype,
                                                       device),
        bos_id=bos_id, vocab_size=pcfg.vocab_size)


def paged_engine(ctx, **kw):
    raise NotImplementedError("the stub architecture has no paged KV cache")


def wrap(rec):
    import stub_model as M

    norm = M.rmsnorm

    def rmsnorm(x, w, eps=1e-5):
        n, wb = x.numel(), 0 if w is None else w.numel() * w.element_size()
        rec.note("norm", lambda _pos: (4.0 * n, 2.0 * n * x.element_size() + wb))
        return norm(x, w, eps)

    M.rmsnorm = rmsnorm
'''

READERS = {
    "norm_bytes": '''def read(run):
    calls = (run.trace or {}).get("calls", {}).get("norm")
    return sum(nb for _, nb in calls) if calls else None
''',
    "attn_calls": '''def read(run):
    calls = (run.trace or {}).get("attn")
    return len(calls) if calls else None
'''}
STUB_CELLS = [("mixtral-8x7b", "batch16"), ("qwen2-7b", "chat-scan")]


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    """The stub's files in a directory of their own, the loader pointed there
    first, and its model module importable; all undone afterwards."""
    from tpu_llm_torch.models import llama

    d = tmp_path_factory.mktemp("stub")
    (d / "arch").mkdir()
    (d / "metrics").mkdir()
    (d / "arch" / "stub.py").write_text(STUB_ARCH)
    for name, src in READERS.items():
        (d / "metrics" / f"{name}.py").write_text(src)
    shutil.copy(llama.__file__, d / "stub_model.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "PLACES", [str(d), harness.HERE])
        mp.syspath_prepend(str(d))
        yield d
        sys.modules.pop("stub_model", None)


def stub_bench(names):
    b = tiny_cells.bench()
    b["workloads"] = [{"name": n, "config": n.split(".")[0], "traffic": n.split(".")[1],
                       "chips": 1, "why": "stub"} for n in names]
    b["per_layer"] += [{"name": m, "unit": "n", "better": "higher", "source": "device_trace",
                        "layer": "stub", "moves": "output_tok_s", "workloads": names}
                       for m in READERS]
    return b


@pytest.mark.parametrize("config,traffic", STUB_CELLS, ids=[f"{c}.{t}" for c, t in STUB_CELLS])
def test_a_new_architecture_runs_from_its_own_files(stub, config, traffic):
    name = f"{config}.{traffic}"
    cfg_file = dict(tiny_cells.tiny_config(config), arch="stub")
    files = cfg_file, tiny_cells.tiny_mix(traffic), tiny_cells.TINY_LIMIT
    bench = stub_bench([name])
    result, _ = harness.run_cell(bench, name, SEED, 3.0, True, "cpu", files=files)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["norm_bytes"]["value"] > 0 and m["attn_calls"]["value"] > 0, m
    assert "mfu" in m
    assert ("route_gap" in result["checks"]) == (config == "mixtral-8x7b")
    import stub_model

    assert harness.load_arch(cfg_file).router_site == ("stub_model", "matmul")
    from tpu_llm_torch.quant import linear

    assert stub_model.matmul is linear.matmul         # the route record let go of it
    result, _ = harness.run_cell(bench, name, SEED, 3.0, False, "cpu", files=files)
    assert result["correct"] and "output_tok_s" in result["metrics"]


def test_a_new_architecture_without_paged_kv_says_so(stub):
    cfg_file = dict(tiny_cells.tiny_config("qwen2-7b"), arch="stub")
    ctx = harness.Context(cfg_file, tiny_cells.tiny_mix("chat-paged"), SEED, 1.0, False,
                          "cpu", 0.0)
    with pytest.raises(NotImplementedError, match="no paged KV"):
        harness.load_module("entries", "paged").run(ctx)


# -- the static guard -----------------------------------------------------------------

# the llama family's own files; everything else reaches them through ``ctx.arch``
LLAMA_FILES = {"arch/llama.py", "weights.py", "reference/model.py", "roofline.py"}


def llama_bound(src: str) -> list:
    """What in ``src`` reaches the llama family around an architecture module:
    an import of its model, weights or reference; a call of
    ``ModelAdapter.llama``, ``PagedEngine``, ``weights.*`` or
    ``reference.logits_at``; a string naming its model module."""
    tree = ast.parse(src)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    found = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            found += [a.name for a in n.names
                      if a.name.startswith(("tpu_llm_torch.models.llama", "benchmark.weights",
                                            "benchmark.reference.model"))]
        elif isinstance(n, ast.ImportFrom) and n.module:
            full = [f"{n.module}.{a.name}" for a in n.names]
            found += [f for f in full
                      if f.startswith(("tpu_llm_torch.models.llama", "benchmark.weights",
                                       "benchmark.reference.model"))]
        elif isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name) and f.id == "PagedEngine":
                found.append("PagedEngine(")
            elif isinstance(f, ast.Attribute):
                base = f.value.id if isinstance(f.value, ast.Name) else \
                    f.value.attr if isinstance(f.value, ast.Attribute) else ""
                if f.attr == "PagedEngine" or (f.attr, base) in {("llama", "ModelAdapter"),
                                                                 ("logits_at", "reference")} \
                        or base == "weights":
                    found.append(f"{base}.{f.attr}(")
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
            if "models.llama" in n.value:
                found.append(repr(n.value))
    return found


def harness_sources():
    for root, dirs, files in os.walk(BENCH):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), BENCH)
            if f.endswith(".py") and rel not in LLAMA_FILES:
                yield rel


@pytest.mark.parametrize("rel", sorted(harness_sources()))
def test_nothing_outside_the_llama_files_is_bound_to_llama(rel):
    assert llama_bound(open(os.path.join(BENCH, rel)).read()) == []


@pytest.mark.parametrize("src", [
    "from tpu_llm_torch.models import llama as M",
    "import tpu_llm_torch.models.llama",
    "from tpu_llm_torch.models.llama import forward",
    "from benchmark import weights",
    "from benchmark.reference import model as reference",
    "a = ModelAdapter.llama(cfg, dt)",
    "e = PagedEngine(p, c)",
    "e = paged_engine.PagedEngine(p, c)",
    "d = weights.dims(cfg)",
    "r = reference.logits_at(cfg, raw, s, sp)",
    "site = ('tpu_llm_torch.models.llama', 'matmul')",
    "importlib.import_module('tpu_llm_torch.models.llama')",
])
def test_the_guard_finds_a_planted_llama_call(src):
    assert llama_bound(src), src


def test_the_guard_finds_the_llama_files_themselves():
    for rel in ("arch/llama.py", "harness.py"):
        src = open(os.path.join(BENCH, rel)).read()
        assert bool(llama_bound(src)) == (rel == "arch/llama.py"), rel
    assert llama_bound('"""models.llama in a docstring"""\nx = 1') == []
