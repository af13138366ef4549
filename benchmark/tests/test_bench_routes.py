"""The MoE check on the CPU at a tiny size: the route record holds the
experts the port's MoE FFN used in each of its three strategies and
nothing for a dense model; the reference follows given routes and is
unchanged without them; a dense cell's numbers are the plain reference's;
a sound tiny Mixtral run passes every number, a program with two experts'
planes swapped fails ``max_gap``, one with its router's columns permuted
fails ``route_gap`` and one with its router doubled (the same experts,
other gate weights) fails ``router_gap``; and the fixed batch job repeats its
steps."""

import contextlib
import copy

import pytest
import torch

import tiny_cells
from benchmark import check, harness, weights
from benchmark.reference import model as reference
from benchmark.routes import Routes

SEED = 2 ** 31 + 23
SITE = harness.load_arch(tiny_cells.tiny_config("mixtral-8x7b")).router_site


def moe_config(experts: int = 8) -> dict:
    cfg = tiny_cells.tiny_config("mixtral-8x7b")["config"]
    cfg["num_local_experts"] = experts
    return cfg


@contextlib.contextmanager
def topk_seen(n_experts: int):
    """Every top k taken over ``n_experts`` columns while inside: its indices."""
    seen, orig = [], torch.topk

    def topk(x, k, *a, **kw):
        out = orig(x, k, *a, **kw)
        if x.shape[-1] == n_experts:
            seen.append(out[1].clone())
        return out

    torch.topk = topk
    try:
        yield seen
    finally:
        torch.topk = orig


def forward_once(cfg, params, B, T):
    from tpu_llm_torch.models import llama as M

    pcfg = weights.port_config(cfg)
    cache = M.init_cache(pcfg, B, 32, torch.float32, "cpu")
    toks = torch.randint(3, 250, (B, T), generator=torch.Generator().manual_seed(B * 31 + T))
    M.forward(params, pcfg, toks, cache, 0)


# (B, T): one token gathers its experts; 2 or 3 tokens (2 x 2, 3 x 2 < 8) take
# the union of the selected; 4 x 4 tokens run every expert, masked
@pytest.mark.parametrize("B,T", [(1, 1), (1, 2), (3, 1), (4, 4)],
                         ids=["gather", "union-T2", "union-B3", "masked"])
def test_record_holds_the_experts_the_ffn_used(B, T):
    cfg = moe_config()
    params = weights.port_params(weights.draw(cfg, SEED, "cpu"))
    rec = Routes(params, cfg["num_experts_per_tok"], SITE)
    rec.install()
    try:
        rec.begin([(b, b, 0, T) for b in range(B)])
        with topk_seen(cfg["num_local_experts"]) as used:
            forward_once(cfg, params, B, T)
    finally:
        rec.uninstall()
    assert len(used) == cfg["num_hidden_layers"]
    got, gates, logits = rec._experts(0)
    for layer, want in enumerate(used):
        assert torch.equal(got[layer], want.reshape(B, T, -1))
        assert torch.equal(logits[layer], rec.calls[0][1][layer])
    torch.testing.assert_close(gates.sum(-1), torch.ones(gates.shape[:-1]))
    for b in range(B):
        idx, w, lg = rec.of(b, T)
        assert idx.shape == w.shape == (cfg["num_hidden_layers"], T, cfg["num_experts_per_tok"])
        assert lg.shape == (cfg["num_hidden_layers"], T, cfg["num_local_experts"])
        assert torch.equal(idx, got[:, b]) and torch.equal(w, gates[:, b])
        assert torch.equal(lg, logits[:, b])
    # a position no call covered has no route
    assert rec.of(0, T + 1) is None


def test_record_is_off_until_installed_and_after():
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.quant import linear

    cfg = moe_config()
    params = weights.port_params(weights.draw(cfg, SEED, "cpu"))
    rec = Routes(params, 2, SITE)
    rec.begin([(0, 0, 0, 2)])
    forward_once(cfg, params, 1, 2)
    assert M.matmul is linear.matmul
    assert all(lg is None for lg in rec.calls[0][1])
    rec.install()
    rec.uninstall()
    assert M.matmul is linear.matmul


def test_dense_forward_leaves_the_record_empty():
    cfg = tiny_cells.tiny_config("qwen2-7b")["config"]
    params = weights.port_params(weights.draw(cfg, SEED, "cpu"))
    rec = Routes(params, 2, SITE)
    assert rec.layer_of == {}
    rec.install()
    try:
        rec.begin([(0, 0, 0, 4)])
        forward_once(cfg, params, 1, 4)
    finally:
        rec.uninstall()
    assert all(lg is None for lg in rec.calls[0][1])


def test_reference_following_its_own_routes_is_unchanged():
    cfg = moe_config()
    raw = weights.draw(cfg, SEED, "cpu")
    seqs = [list(range(3, 30)), list(range(40, 52))]
    spans = [(0, len(s)) for s in seqs]
    rl = []
    plain = reference.logits_at(cfg, raw, seqs, spans, "f32", router_logits=rl)
    own = [torch.topk(torch.softmax(lg, dim=-1), cfg["num_experts_per_tok"], dim=-1)
           for lg in rl]
    own = ([c.indices for c in own], [c.values / c.values.sum(-1, keepdim=True) for c in own])
    n0 = len(seqs[0])
    routes = [tuple(torch.stack([o[:n0] for o in part]) for part in own),
              tuple(torch.stack([o[n0:] for o in part]) for part in own)]
    followed = reference.logits_at(cfg, raw, seqs, spans, "f32", routes)
    for a, b in zip(plain, followed):
        assert torch.equal(a, b)
    # other experts, or other weights, give other logits
    n = cfg["num_local_experts"]
    for other in ([((i + 1) % n, w) for i, w in routes], [(i, w.flip(-1)) for i, w in routes]):
        moved = reference.logits_at(cfg, raw, seqs, spans, "f32", other)
        assert not torch.equal(moved[0], plain[0])


def test_dense_numbers_are_the_plain_references():
    run, ctx, mix = tiny_run("qwen2-7b.chat-scan")
    got = check.judged(ctx.arch, ctx.cfg, ctx.raw, run, mix, tiny_cells.TINY_LIMIT, SEED,
                       ("fp8",))
    reqs = check.sample(run, mix["check"]["served_tokens"], SEED)
    seqs, spans, served = check.sequences(reqs, int(ctx.cfg["bos_token_id"]))
    ref = reference.logits_at(ctx.cfg, ctx.raw, seqs, spans, "f32")
    low = reference.logits_at(ctx.cfg, ctx.raw, seqs, spans, "fp8")
    assert list(got[None]) == list(got["fp8"]) == ["max_gap", "overrun"]
    assert got[None]["max_gap"]["value"] == check.gaps(
        ref, [torch.tensor(s) for s in served]).max().item()
    assert got["fp8"]["max_gap"]["value"] == check.gaps(
        ref, [lg.argmax(dim=-1) for lg in low]).max().item()


def tiny_run(workload, seed=SEED, params_fn=None):
    """A tiny run of ``workload`` on the CPU: (run, context, mix);
    ``params_fn`` changes the program's parameters (not the reference's)."""
    cell = next(w for w in tiny_cells.bench()["workloads"] + tiny_cells.LIBRARY
                if w["name"] == workload)
    cfg_file, mix = tiny_cells.tiny_config(cell["config"]), tiny_cells.tiny_mix(cell["traffic"])
    entry = harness.load_module("entries", mix["entry"])
    ctx = harness.Context(cfg_file, mix, seed, 3.0, False, "cpu", 0.0)
    if params_fn is not None:
        ctx.params = params_fn(ctx.params)
    run = harness.run_program(ctx, entry)
    return run, ctx, mix


def numbers(run, ctx, mix, seed=SEED):
    return check.check(ctx.arch, ctx.cfg, ctx.raw, run, mix, tiny_cells.TINY_LIMIT, seed)


def test_sound_moe_run_passes_every_number():
    run, ctx, mix = tiny_run("mixtral-8x7b.batch16")
    got = numbers(run, ctx, mix)
    assert set(got) == {"max_gap", "route_gap", "router_gap", "overrun"}
    assert check.verdict(got), got


def swapped_experts(params):
    """The program's experts 0 and 1 trade their planes (every layer)."""
    from tpu_llm_torch.quant.qtensor import qmap

    out = copy.copy(params)
    out["layers"] = [dict(lp) for lp in params["layers"]]
    for lp in out["layers"]:
        for n in ("w1e", "w3e", "w2e"):
            lp[n] = qmap(lambda p: p[[1, 0, *range(2, p.shape[0])]].contiguous(), lp[n])
    return out


def permuted_router(params):
    """The program's router columns rotated by one: it picks other experts."""
    out = copy.copy(params)
    out["layers"] = [dict(lp, router=lp["router"].roll(1, dims=-1).contiguous())
                     for lp in params["layers"]]
    return out


def scaled_router(params):
    """The program's router doubled: the same experts, sharper gate weights."""
    out = copy.copy(params)
    out["layers"] = [dict(lp, router=lp["router"] * 2) for lp in params["layers"]]
    return out


def test_swapped_expert_planes_fail_max_gap():
    got = numbers(*tiny_run("mixtral-8x7b.batch16", params_fn=swapped_experts))
    assert got["max_gap"]["value"] > got["max_gap"]["limit"], got


def test_permuted_router_fails_route_gap():
    got = numbers(*tiny_run("mixtral-8x7b.batch16", params_fn=permuted_router))
    assert got["route_gap"]["value"] > got["route_gap"]["limit"], got


def test_scaled_router_fails_router_gap():
    got = numbers(*tiny_run("mixtral-8x7b.batch16", params_fn=scaled_router))
    assert got["route_gap"]["value"] <= got["route_gap"]["limit"], got
    assert got["router_gap"]["value"] > got["router_gap"]["limit"], got


def test_a_run_missing_a_route_fails():
    run, ctx, mix = tiny_run("mixtral-8x7b.batch16")
    rid = check.sample(run, mix["check"]["served_tokens"], SEED)[0].rid
    first = next(c for c, (rows, _) in enumerate(run.routes.calls)
                 if any(r == rid for _, r, _, _ in rows))
    del run.routes.calls[first]           # the longest request's prefill
    got = numbers(run, ctx, mix)
    assert all(got[n]["value"] == check.NO_SAMPLE for n in ("max_gap", "route_gap", "router_gap"))


def test_fixed_job_repeats_its_steps():
    a, ctx, mix = tiny_run("mixtral-8x7b.batch16")
    b, _, _ = tiny_run("mixtral-8x7b.batch16")
    assert len(a.steps) == mix["steps"]
    assert [n for *_, n in a.steps] == [n for *_, n in b.steps]
    assert [(len(r.spec.prompt), r.tokens) for r in a.requests] == \
           [(len(r.spec.prompt), r.tokens) for r in b.requests]
    assert [rows for rows, _ in a.routes.calls] == [rows for rows, _ in b.routes.calls]
    assert a.tokens_in_window() == sum(len(r.tokens) for r in a.requests)
