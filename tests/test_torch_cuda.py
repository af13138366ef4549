"""The port's CUDA kernels against their plain PyTorch twins on the card,
at edge shapes the smoke run (chip_smoke.py, main-path shapes) does not
reach: every qmatmul kind with f32 and bf16 planes and row_scale, the FFN
megakernel at rows 1-8, ragged N (N % 4 != 0), odd row counts, head_dim 16 to 128, per-row
positions, bf16 caches, tile boundaries; for the paged decode kernels
position 0 and block boundaries, block sizes 8 to 64, a prefix block
shared across rows and poisoned unmapped blocks. Marked ``cuda``: each test skips
where there is no card. On a machine with one, run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
need not have; this file imports neither JAX nor the JAX package.)

Tolerances: f32 inputs 1e-4 * max|plain| (the kernel and its twin sum in
other orders); bf16 inputs 2e-2 * max|plain| (one bf16 rounding of
outputs near the max, plus rounding of intermediates)."""

import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a test process (xdist runs 6 on 8 cores)

from tpu_llm_torch.ops import flash_attention as FA
from tpu_llm_torch.quant.qmatmul import qmatmul, qmatmul_plain
from tpu_llm_torch.quant.qtensor import QTensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _close(got, want, bf16: bool):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    tol = (2e-2 if bf16 else 1e-4) * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


def _qt(g, kind, K, N):
    if kind == "q4_0":
        q = torch.randint(0, 256, (K // 2, N), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.uint8)
    else:
        q = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int32).to(torch.int8)
    s = torch.rand((K // 32, N), generator=g, device="cuda") * 0.009 + 0.001
    return QTensor(q.contiguous(), s.contiguous(), kind)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("K,N", [(32, 1), (64, 130), (96, 33), (2048, 2560),
                                 (5632, 2048)])
@pytest.mark.parametrize("rows", [1, 3, 8, 37])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_qmatmul_kernel_matches_plain(gen, kind, K, N, rows, xdt):
    w = _qt(gen, kind, K, N)
    x = torch.randn((rows, K), generator=gen, device="cuda").to(xdt)
    launches = qmatmul.launches
    got = qmatmul(x, w)
    assert qmatmul.launches == launches + 1 and got.dtype == xdt
    _close(got, qmatmul_plain(x, w), xdt == torch.bfloat16)
    f32_out = qmatmul(x, w, out_dtype=torch.float32)
    _close(f32_out, qmatmul_plain(x, w, out_dtype=torch.float32), False)


def test_qmatmul_kernel_refuses_bad_shapes(gen):
    w = _qt(gen, "q4_0", 64, 16)
    with pytest.raises(ValueError):
        qmatmul(torch.zeros((1, 32), device="cuda"), w)
    with pytest.raises(ValueError):
        qmatmul(torch.zeros((1, 64)), w)           # x on the CPU, weight on the card


@pytest.mark.parametrize("D,H,Hkv", [(16, 4, 2), (64, 32, 4), (128, 8, 8), (48, 6, 2)])
@pytest.mark.parametrize("qdt,cdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16q", "bf16"])
def test_decode_kernels_match_plain(gen, D, H, Hkv, qdt, cdt):
    B, S = 3, 200
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(qdt)
    kc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(cdt)
    vc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(cdt)
    k_cur = torch.randn((B, 1, Hkv * D), generator=gen, device="cuda").to(qdt)
    v_cur = torch.randn((B, 1, Hkv * D), generator=gen, device="cuda").to(qdt)
    bf16 = qdt == torch.bfloat16
    for pos in ([0, 63, 199], [64, 65, 127], [5, 5, 5]):
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        _close(FA.flash_decode_attention(q, kc, vc, p),
               FA.flash_decode_attention_plain(q, kc, vc, p), bf16)
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got, _, _ = FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)
        want, _, _ = FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)
        _close(got, want, bf16)
        assert torch.equal(k1, k2) and torch.equal(v1, v2)   # row pos only


_DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)]
_DTYPE_IDS = ["f32", "bf16q", "bf16", "f32q_bf16"]


def _edge_positions(S, rows):
    """0, S - 1, and each split edge e = rows * i with e - 1 and e + 1."""
    pos = {0, S - 1}
    for e in range(rows, S, rows):
        pos |= {e - 1, e, e + 1}
    return sorted(p for p in pos if 0 <= p < S)


@pytest.mark.parametrize("qdt,cdt", _DTYPE_PAIRS, ids=_DTYPE_IDS)
@pytest.mark.parametrize("B,S,case", [(8, 1024, "ragged"), (1, 2048, "edges"),
                                      (3, 1000, "edges"), (2, 64, "edges"),
                                      (1, 130, "edges")])
@pytest.mark.parametrize("D,H,Hkv", [(64, 32, 4), (128, 8, 2), (16, 6, 2), (64, 32, 2)])
def test_decode_split_kernel_matches_plain(gen, qdt, cdt, B, S, case, D, H, Hkv):
    """K2 split over the sequence (decode_splits): serving's ragged batch
    8, and positions on and around every split edge, against the plain
    twin and the plain split-and-combine."""
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(qdt)
    kc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(cdt)
    vc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(cdt)
    rows, n_split = FA.decode_splits(B, Hkv, S)
    assert n_split > 1 or S <= 64
    if case == "ragged":
        runs = [[15, 100, 255, 256, 511, 700, 1000, 1023][:B]]
    else:
        edge = _edge_positions(S, rows)
        runs = [[edge[(i + r) % len(edge)] for r in range(B)] for i in range(len(edge))]
    bf16 = qdt == torch.bfloat16
    for pos in runs:
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        launches = FA.flash_decode_attention.launches
        got = FA.flash_decode_attention(q, kc, vc, p)
        assert FA.flash_decode_attention.launches == launches + 1
        _close(got, FA.flash_decode_attention_plain(q, kc, vc, p), bf16)
        _close(got, FA.flash_decode_attention_split_plain(q, kc, vc, p), bf16)


def test_decode_split_kernel_replays_in_a_graph(gen):
    """K2 captured in a CUDA graph (the position in a device tensor, the
    split scratch from the graph's pool) and replayed at three positions:
    each replay equals the eager call there, and the merge counters are
    back at 0 after every launch."""
    B, S, H, Hkv, D = 1, 2048, 32, 4, 64
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda")
    vc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda")
    pos = torch.tensor([7], dtype=torch.int32, device="cuda")
    FA.flash_decode_attention(q, kc, vc, pos)              # builds and warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = FA.flash_decode_attention(q, kc, vc, pos)
    for p in (63, 64, 2047):
        pos.fill_(p)
        graph.replay()
        want = FA.flash_decode_attention(q, kc, vc, torch.tensor([p], dtype=torch.int32,
                                                                device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(out, want), p
    # every launch leaves the merge counters at 0 for the next one
    assert FA._split_counters[q.device].count_nonzero().item() == 0


@pytest.mark.parametrize("qdt,cdt", _DTYPE_PAIRS, ids=_DTYPE_IDS)
@pytest.mark.parametrize("B,S", [(1, 2048), (3, 1000), (2, 64), (1, 130), (1, 1024)])
@pytest.mark.parametrize("D,H,Hkv", [(64, 32, 4), (128, 8, 2), (16, 6, 2)])
def test_fused_split_kernel_matches_plain(gen, qdt, cdt, B, S, D, H, Hkv):
    """K3 on K2's split body: positions on and around every split edge, 0
    and S - 1 (batch rows at different positions), against the plain twin
    and the plain split-and-merge with the append; the stored rows equal
    the twin's and no other row changes."""
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(qdt)
    kc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(cdt)
    vc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(cdt)
    k_cur = torch.randn((B, 1, Hkv * D), generator=gen, device="cuda").to(qdt)
    v_cur = torch.randn((B, 1, Hkv * D), generator=gen, device="cuda").to(qdt)
    rows, _ = FA.decode_splits(B, Hkv, S)
    edge = _edge_positions(S, rows)
    bf16 = qdt == torch.bfloat16
    for i in range(len(edge)):
        p = torch.tensor([edge[(i + r) % len(edge)] for r in range(B)], dtype=torch.int32,
                         device="cuda")
        k1, v1, k2, v2, k3, v3 = (c.clone() for c in (kc, vc) * 3)
        launches = FA.flash_decode_fused.launches
        got, _, _ = FA.flash_decode_fused(q, k1, v1, k_cur, v_cur, p)
        assert FA.flash_decode_fused.launches == launches + 1
        want, _, _ = FA.flash_decode_fused_plain(q, k2, v2, k_cur, v_cur, p)
        split, _, _ = FA.flash_decode_fused_split_plain(q, k3, v3, k_cur, v_cur, p)
        _close(got, want, bf16)
        _close(got, split, bf16)
        assert torch.equal(k1, k2) and torch.equal(v1, v2)   # row pos only


def test_fused_split_kernel_replays_in_a_graph(gen):
    """K3 captured in a CUDA graph at bench.py's shape (bf16 (1, 1024, 256)
    cache, bf16 q) and replayed as the device position moves: each replay
    equals the eager call there, stores k_cur / v_cur at that row only,
    and leaves the merge counters at 0."""
    B, S, H, Hkv, D = 1, 1024, 32, 4, 64
    bf = torch.bfloat16
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(bf)
    kc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(bf)
    vc = torch.randn((B, S, Hkv * D), generator=gen, device="cuda").to(bf)
    k_cur = torch.randn((B, 1, Hkv * D), generator=gen, device="cuda").to(bf)
    v_cur = torch.randn((B, 1, Hkv * D), generator=gen, device="cuda").to(bf)
    k0, v0 = kc.clone(), vc.clone()
    pos = torch.tensor([7], dtype=torch.int32, device="cuda")
    FA.flash_decode_fused(q, kc.clone(), vc.clone(), k_cur, v_cur, pos)   # warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _, _ = FA.flash_decode_fused(q, kc, vc, k_cur, v_cur, pos)
    done = []
    for p in (16, 63, 64, 340, 655, 1023):
        pos.fill_(p)
        graph.replay()
        ke, ve = k0.clone(), v0.clone()
        for d in done:                       # the rows earlier replays stored
            ke[:, d], ve[:, d] = k_cur[:, 0], v_cur[:, 0]
        want, ke, ve = FA.flash_decode_fused(q, ke, ve, k_cur, v_cur,
                                             torch.tensor([p], dtype=torch.int32,
                                                          device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(out, want), p
        assert torch.equal(kc, ke) and torch.equal(vc, ve), p
        done.append(p)
    assert FA._split_counters[q.device].count_nonzero().item() == 0


@pytest.mark.parametrize("D,H,Hkv", [(16, 4, 2), (64, 32, 4), (128, 8, 2)])
@pytest.mark.parametrize("T,S,offset", [(17, 64, 0), (64, 64, 0), (100, 256, 7),
                                        (130, 200, 70), (1, 5, 4), (95, 129, 34),
                                        (300, 1000, 511), (64, 130, 66), (200, 150, 0),
                                        (513, 1024, 0)])
@pytest.mark.parametrize("qdt,cdt", _DTYPE_PAIRS, ids=_DTYPE_IDS)
def test_prefill_kernel_matches_plain(gen, D, H, Hkv, T, S, offset, qdt, cdt):
    """K4 on tensor cores for every (q, cache) dtype pair: against the twin
    and, with an f32 operand (three bf16 parts), against the products the
    kernel keeps (flash_gqa_attention_split_plain), at f32's 1e-4 where q
    is f32."""
    B = 2
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(qdt)
    kc = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(cdt)
    vc = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(cdt)
    launches = FA.flash_gqa_attention.launches
    got = FA.flash_gqa_attention(q, kc, vc, offset)
    assert FA.flash_gqa_attention.launches == launches + 1 and got.dtype == qdt
    bf16 = qdt == torch.bfloat16
    _close(got, FA.flash_gqa_attention_plain(q, kc, vc, offset), bf16)
    if qdt == torch.float32 or cdt == torch.float32:
        _close(got, FA.flash_gqa_attention_split_plain(q, kc, vc, offset), bf16)


def test_attention_kernels_refuse_unsupported_head_dim(gen):
    q = torch.zeros((1, 1, 4, 8), device="cuda")
    kc = torch.zeros((1, 16, 16), device="cuda")
    p = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_decode_attention(q, kc, kc, p)


def test_model_logits_card_match_cpu(gen):
    """A small q4_0 llama, decode steps on the card (kernels) and on the
    CPU (plain twins), f32: the same logits."""
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.quant.convert_params import quantize_llama_params

    cfg = LlamaConfig(dim=128, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=100, seq_len=64)
    g = torch.Generator().manual_seed(1)
    s = lambda *shape: torch.randn(shape, generator=g) * 0.08  # noqa: E731
    dense = {"tok_emb": s(100, 128), "final_norm": 1 + 0.1 * s(128), "wcls": s(128, 100),
             "layers": [{"attn_norm": 1 + 0.1 * s(128), "ffn_norm": 1 + 0.1 * s(128),
                         "wq": s(128, 128), "wk": s(128, 64), "wv": s(128, 64),
                         "wo": s(128, 128), "w1": s(128, 96), "w3": s(128, 96),
                         "w2": s(96, 128)} for _ in range(2)]}
    cpu = quantize_llama_params(dense, "q4_0", fuse=True)
    card = quantize_llama_params(
        {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in dense.items()
         if k != "layers"} | {"layers": [{k: v.cuda() for k, v in lp.items()}
                                         for lp in dense["layers"]]},
        "q4_0", fuse=True)
    for defer in (False, True):
        cc = M.init_cache(cfg, 1, 64)
        gc = M.init_cache(cfg, 1, 64, device="cuda")
        for pos, tok in enumerate([1, 7, 42, 99, 3]):
            want, cc = M.decode_step(cpu, cfg, torch.tensor([tok]), cc, pos, defer)
            got, gc = M.decode_step(card, cfg, torch.tensor([tok], device="cuda"),
                                    gc, pos, defer)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


def _paged_case(gen, B, H, Hkv, D, BS, MB, pool_dtype):
    """Shuffled distinct blocks per row, row 1 sharing row 0's first block
    (a shared prefix), positions 0, BS-1, BS and the last row."""
    N = 1 + B * MB
    ids = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(BS)) + 1)
    table = ids[:B * MB].reshape(B, MB).to(torch.int32)
    table[1, 0] = table[0, 0]
    table = table.cuda()
    pos = torch.tensor([0, BS - 1, BS, MB * BS - 1][:B], dtype=torch.int32, device="cuda")
    if pool_dtype == torch.int8:
        mk = lambda: torch.randint(-127, 128, (N, BS, Hkv * D), generator=gen,  # noqa: E731
                                   device="cuda", dtype=torch.int32).to(torch.int8)
    else:
        mk = lambda: torch.randn((N, BS, Hkv * D), generator=gen,  # noqa: E731
                                 device="cuda").to(pool_dtype)
    return mk(), mk(), table, pos


def _dead_blocks(table, pos, BS, N):
    """Block 0 and every block no row maps at or below its pos // BS."""
    live = {int(table[b, j]) for b in range(table.shape[0])
            for j in range(int(pos[b]) // BS + 1)}
    return [i for i in range(N) if i not in live or i == 0]


def _poison(pool, dead, value):
    out = pool.clone()
    out[dead] = value
    return out


@pytest.mark.parametrize("BS", [8, 16, 32, 64])
@pytest.mark.parametrize("D,H,Hkv", [(64, 8, 2), (128, 8, 4)])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32pool", "bf16pool"])
def test_paged_decode_kernel_matches_plain(gen, BS, D, H, Hkv, qdt, pool_dtype):
    B, MB = 4, 8
    kp, vp, table, pos = _paged_case(gen, B, H, Hkv, D, BS, MB, pool_dtype)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(qdt)
    launches = FA.paged_flash_decode_attention.launches
    got = FA.paged_flash_decode_attention(q, kp, vp, table, pos)
    assert FA.paged_flash_decode_attention.launches == launches + 1
    bf16 = torch.bfloat16 in (qdt, pool_dtype)
    _close(got, FA.paged_flash_decode_attention_plain(q, kp, vp, table, pos), bf16)
    dead = _dead_blocks(table, pos, BS, kp.shape[0])
    nan = float("nan")
    again = FA.paged_flash_decode_attention(q, _poison(kp, dead, nan),
                                            _poison(vp, dead, nan), table, pos)
    assert torch.equal(again, got)


@pytest.mark.parametrize("BS", [8, 16, 32, 64])
@pytest.mark.parametrize("D,H,Hkv", [(64, 8, 2), (128, 8, 4)])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_decode_q_kernel_matches_plain(gen, BS, D, H, Hkv, qdt):
    from tpu_llm_torch.ops.paged_kv import scale_pool_width, scale_rows_per_block

    B, MB = 4, 8
    kp, vp, table, pos = _paged_case(gen, B, H, Hkv, D, BS, MB, torch.int8)
    N = kp.shape[0]
    shape = (N * scale_rows_per_block(Hkv), scale_pool_width(BS))
    ks = torch.rand(shape, generator=gen, device="cuda") * 0.09 + 0.01
    vs = torch.rand(shape, generator=gen, device="cuda") * 0.09 + 0.01
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(qdt)
    launches = FA.paged_flash_decode_q.launches
    got = FA.paged_flash_decode_q(q, kp, vp, ks, vs, table, pos)
    assert FA.paged_flash_decode_q.launches == launches + 1
    # the kernel rounds q and p * vs to bf16 whatever q's dtype
    _close(got, FA.paged_flash_decode_q_plain(q, kp, vp, ks, vs, table, pos), True)
    dead = _dead_blocks(table, pos, BS, N)
    hp = shape[0] // N
    dead_rows = [b * hp + i for b in dead for i in range(hp)]
    nan = float("nan")
    again = FA.paged_flash_decode_q(q, _poison(kp, dead, -128), _poison(vp, dead, -128),
                                    _poison(ks, dead_rows, nan), _poison(vs, dead_rows, nan),
                                    table, pos)
    assert torch.equal(again, got)


# -- K5 / K6 on the split decode body ----------------------------------------

def _paged_split_edges(S, rows, BS):
    """0, S - 1, every block edge (e - 1, e) and every split edge (e - 1,
    e, e + 1)."""
    pos = {0, S - 1}
    for e in range(BS, S, BS):
        pos |= {e - 1, e}
    for e in range(rows, S, rows):
        pos |= {e - 1, e, e + 1}
    return sorted(p for p in pos if 0 <= p < S)


def _split_pools(gen, pool, N, BS, Hkv, D):
    """k, v pools and (int8) their (N*HP, SP) scale pools."""
    if pool == "int8":
        from tpu_llm_torch.ops.paged_kv import scale_pool_width, scale_rows_per_block

        kp, vp = (torch.randint(-127, 128, (N, BS, Hkv * D), generator=gen, device="cuda",
                                dtype=torch.int32).to(torch.int8) for _ in range(2))
        shape = (N * scale_rows_per_block(Hkv), scale_pool_width(BS))
        return kp, vp, tuple(torch.rand(shape, generator=gen, device="cuda") * 0.09 + 0.01
                             for _ in range(2))
    dt = torch.bfloat16 if pool == "bf16" else torch.float32
    kp, vp = (torch.randn((N, BS, Hkv * D), generator=gen, device="cuda").to(dt)
              for _ in range(2))
    return kp, vp, ()


def _paged_call(pool):
    if pool == "int8":
        return FA.paged_flash_decode_q, FA.paged_flash_decode_q_plain
    return FA.paged_flash_decode_attention, FA.paged_flash_decode_attention_plain


def _table_to_pos(full, pos, BS, N):
    """The table with every entry past pos // BS at the null block 0, and
    the blocks no row reads at or below its pos // BS (block 0 among them)."""
    live_entries = (torch.arange(full.shape[1], device="cuda")[None, :]
                    <= (pos.long() // BS)[:, None])
    table = torch.where(live_entries, full, torch.zeros_like(full)).contiguous()
    live = torch.zeros(N, dtype=torch.bool, device="cuda")
    live[table[live_entries].long()] = True
    live[0] = False
    return table, ~live


def _poison_dead(pool, kp, vp, scales, dead):
    if pool == "int8":
        hp = scales[0].shape[0] // kp.shape[0]
        rows = dead.repeat_interleave(hp)[:, None]
        nan = float("nan")
        return (kp.masked_fill(dead[:, None, None], -128),
                vp.masked_fill(dead[:, None, None], -128),
                scales[0].masked_fill(rows, nan), scales[1].masked_fill(rows, nan))
    return tuple(p.masked_fill(dead[:, None, None], float("nan")) for p in (kp, vp))


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["f32q", "bf16q"])
@pytest.mark.parametrize("BS", [8, 16, 32, 64])
@pytest.mark.parametrize("D,H,Hkv", [(64, 12, 4), (128, 8, 2), (64, 32, 4), (128, 32, 2)])
def test_paged_split_kernel_matches_plain(gen, pool, qdt, BS, D, H, Hkv):
    """K5 / K6 on the split decode body, batch 8 over serving's 1024-row
    tables (shuffled blocks, row 1 sharing row 0's first block): each run
    gives the rows ragged positions, and the runs together cover 0, the
    last row, every block edge and every split edge (e - 1, e, e + 1).
    One launch a call, against the twin and the plain split-and-merge.
    Table entries past pos // BS point at the null block, and block 0 and
    every block no row reads are poisoned (NaN; int8: -128 with NaN
    scales): the output is bit-identical."""
    B, S = 8, 1024
    MB = S // BS
    N = 1 + B * MB
    ids = torch.randperm(N - 1, generator=torch.Generator().manual_seed(BS)) + 1
    full = ids.reshape(B, MB).to(torch.int32).cuda()
    full[1, 0] = full[0, 0]
    kp, vp, scales = _split_pools(gen, pool, N, BS, Hkv, D)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(qdt)
    kernel, twin = _paged_call(pool)
    rows, n_split = FA.decode_splits(B, Hkv, S)
    assert n_split > 1
    edge = _paged_split_edges(S, rows, BS)
    n_runs = -(-len(edge) // B)
    bf16 = pool != "f32" or qdt == torch.bfloat16
    for i in range(n_runs):
        pos = torch.tensor([edge[(i + r * n_runs) % len(edge)] for r in range(B)],
                           dtype=torch.int32, device="cuda")
        table, dead = _table_to_pos(full, pos, BS, N)
        launches = kernel.launches
        got = kernel(q, kp, vp, *scales, table, pos)
        assert kernel.launches == launches + 1
        _close(got, twin(q, kp, vp, *scales, table, pos), bf16)
        _close(got, FA.paged_flash_decode_split_plain(q, kp, vp, table, pos, *scales), bf16)
        again = kernel(q, *_poison_dead(pool, kp, vp, scales, dead), table, pos)
        assert torch.equal(again, got), pos.tolist()
    assert FA._split_counters[q.device].count_nonzero().item() == 0


@pytest.mark.parametrize("pool,BS", [("bf16", 16), ("int8", 32), ("f32", 8)])
def test_paged_split_kernel_replays_in_a_graph(gen, pool, BS):
    """K5 / K6 captured in a CUDA graph at serving's shape (batch 8, 32/4
    heads, 1024-row tables), the positions and the table in device
    tensors, replayed at three sets of positions: each replay equals the
    eager call there, and the merge counters are back at 0."""
    B, H, Hkv, D, S = 8, 32, 4, 64, 1024
    MB = S // BS
    N = 1 + B * MB
    kp, vp, scales = _split_pools(gen, pool, N, BS, Hkv, D)
    table = (torch.randperm(N - 1, generator=torch.Generator().manual_seed(3)) + 1)
    table = table.reshape(B, MB).to(torch.int32).cuda()
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").bfloat16()
    kernel, _ = _paged_call(pool)
    pos = torch.full((B,), 7, dtype=torch.int32, device="cuda")
    kernel(q, kp, vp, *scales, table, pos)                 # builds and warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kernel(q, kp, vp, *scales, table, pos)
    for ps in ([0, 15, 16, 127, 128, 129, 700, 1023], [1023] * 8,
               [5, 300, 64, 1000, 0, 511, 512, 255]):
        pos.copy_(torch.tensor(ps, dtype=torch.int32))
        graph.replay()
        want = kernel(q, kp, vp, *scales, table,
                      torch.tensor(ps, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        assert torch.equal(out, want), ps
    assert FA._split_counters[q.device].count_nonzero().item() == 0


@pytest.mark.parametrize("B", [8, 1])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_paged_split_kernel_is_one_launch(gen, pool, B):
    """The profiler sees one kernel on the card for one K5 / K6 call, the
    split decode body over the paged rows (batch 8: 8 splits; batch 1: 16
    splits, merged in the same launch)."""
    from torch.profiler import ProfilerActivity, profile

    H, Hkv, D, BS, S = 32, 4, 64, 16, 1024
    MB = S // BS
    N = 1 + B * MB
    kp, vp, scales = _split_pools(gen, pool, N, BS, Hkv, D)
    table = torch.arange(1, N, dtype=torch.int32, device="cuda").reshape(B, MB)
    pos = torch.full((B,), 1000, dtype=torch.int32, device="cuda")
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").bfloat16()
    kernel, _ = _paged_call(pool)
    assert FA.decode_splits(B, Hkv, S)[1] > 1
    kernel(q, kp, vp, *scales, table, pos)
    torch.cuda.synchronize()
    for _ in range(3):   # the profiler's device trace comes back empty now and then
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kernel(q, kp, vp, *scales, table, pos)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(names) == 1, names
    assert "flash_decode_split_kernel" in names[0] and "PagedRows" in names[0], names


def test_paged_kernels_refuse_bad_arguments(gen):
    q = torch.zeros((2, 1, 8, 64), device="cuda")
    pool = torch.zeros((5, 16, 128), device="cuda")
    table = torch.ones((2, 2), dtype=torch.int32, device="cuda")
    pos = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):          # table on the CPU
        FA.paged_flash_decode_attention(q, pool, pool, table.cpu(), pos)
    with pytest.raises(ValueError, match="block table"):
        FA.paged_flash_decode_attention(q, pool, pool, table.long(), pos)
    with pytest.raises(ValueError, match="pool dtypes"):
        FA.paged_flash_decode_q(q, pool, pool, pool[0], pool[0], table, pos)


@pytest.mark.parametrize("cache_dtype,block_size", [(torch.float32, 4),
                                                    (torch.float32, 16), ("int8", 32)])
def test_paged_engine_card_matches_cpu(gen, cache_dtype, block_size):
    """A small q4_0 llama served by PagedEngine on the card (kernels) and
    on the CPU (plain twins), f32 activations: identical greedy tokens."""
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.quant.convert_params import quantize_llama_params
    from tpu_llm_torch.runtime.paged_engine import PagedEngine, Request

    cfg = LlamaConfig(dim=128, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=100, seq_len=64)
    g = torch.Generator().manual_seed(2)
    s = lambda *shape: torch.randn(shape, generator=g) * 0.08  # noqa: E731
    dense = {"tok_emb": s(100, 128), "final_norm": 1 + 0.1 * s(128), "wcls": s(128, 100),
             "layers": [{"attn_norm": 1 + 0.1 * s(128), "ffn_norm": 1 + 0.1 * s(128),
                         "wq": s(128, 128), "wk": s(128, 64), "wv": s(128, 64),
                         "wo": s(128, 128), "w1": s(128, 96), "w3": s(128, 96),
                         "w2": s(96, 128)} for _ in range(2)]}
    cpu = quantize_llama_params(dense, "q4_0", fuse=True)
    card = quantize_llama_params(
        {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in dense.items()
         if k != "layers"} | {"layers": [{k: v.cuda() for k, v in lp.items()}
                                         for lp in dense["layers"]]},
        "q4_0", fuse=True)
    prompts = [[5, 11, 8, 3, 9, 2, 7], [5, 11, 8, 3, 40], [9] * 20, [3]]
    runs = []
    for params, device in ((cpu, "cpu"), (card, "cuda")):
        pe = PagedEngine(params, cfg, batch=2, n_blocks=48, block_size=block_size,
                         max_seq=64, cache_dtype=cache_dtype, device=device)
        reqs = [pe.submit(Request(prompt=p, max_new=8)) for p in prompts]
        pe.run()
        runs.append([r.tokens for r in reqs])
    assert runs[0] == runs[1]


# -- K1 for the legacy and K-quant kinds, and K7 ------------------------------

NEW_KINDS = ["q4_1", "q5_0", "q5_1", "q2_k", "q2_kp", "q3_k", "q3_kp", "q6_k", "q6_kp"]


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("K,N,all_rows", [(256, 130, (1, 3, 8, 37)),
                                          (5632, 2560, (1, 5, 8, 512)),
                                          (2048, 32000, (1, 8))])
@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", NEW_KINDS)
def test_qmatmul_kinds_match_plain(gen, kind, planes, K, N, all_rows, with_rs):
    """Random planes in each kind's range (chip_smoke.random_qtensor), f32
    and bf16 x, rows 1-8, 37 and 512, ragged N, row_scale on and off."""
    from chip_smoke import random_qtensor

    w = random_qtensor(torch, gen, kind, K, N, planes)
    rs = (1 + 0.2 * torch.randn(K, generator=gen, device="cuda")) if with_rs else None
    for rows in all_rows:
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, K), generator=gen, device="cuda").to(xdt)
            launches = qmatmul.launches
            got = qmatmul(x, w, row_scale=rs)
            assert qmatmul.launches == launches + 1 and got.dtype == xdt
            _close(got, qmatmul_plain(x, w, row_scale=rs), xdt == torch.bfloat16)
            _close(qmatmul(x, w, out_dtype=torch.float32, row_scale=rs),
                   qmatmul_plain(x, w, out_dtype=torch.float32, row_scale=rs), False)


def test_qmatmul_refuses_scan_slice_planes(gen):
    """Since the --scan slice K1 takes q4_0i4 and int16 (f16-bit) scale
    planes; a misaligned int16 plane, or an int16 mins plane under f32
    scales, is refused (no plain fallback) and launches nothing."""
    x = torch.randn((1, 64), generator=gen, device="cuda")
    q = torch.randint(0, 256, (32, 16), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.uint8)
    s = torch.rand((2, 16), generator=gen, device="cuda") * 0.01
    f16bits = s.half().view(torch.int16)
    for w in (QTensor(q, s, "q4_0i4"), QTensor(q, f16bits, "q4_0i4"),
              QTensor(q, f16bits, "q4_0")):
        launches = qmatmul.launches
        got = qmatmul(x, w)
        assert qmatmul.launches == launches + 1
        _close(got, qmatmul_plain(x, w), False)
    buf = torch.zeros(2 * 16 + 1, dtype=torch.int16, device="cuda")
    misaligned = buf[1:].view(2, 16)
    misaligned.copy_(f16bits)
    launches = qmatmul.launches
    for w in (QTensor(q, misaligned, "q4_0i4"), QTensor(q, s, "q4_0i4", f16bits)):
        with pytest.raises(ValueError, match="planes"):
            qmatmul(x, w)
    assert qmatmul.launches == launches


@pytest.mark.parametrize("planes", ["f32", "bf16", "f32_bf16"])
@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8])
def test_ffn_fused_kernel_matches_plain(gen, kind, rows, planes):
    """K7 at TinyLlama width (E 2048, F 5632), w13 / w2 scale planes f32,
    bf16 or one of each, against its twin and against the kernel's order of
    sums (ffn_fused_split_plain over the launch's own plan); bf16 numerics,
    tolerance 2e-2 * max|plain|. A second call gives the same bits: the
    tile counters and the barrier's count are left at zero (its generation
    word only advances)."""
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant import ffn as FF

    E, F = 2048, 5632
    p13, p2 = {"f32": ("f32", "f32"), "bf16": ("bf16", "bf16"),
               "f32_bf16": ("f32", "bf16")}[planes]
    w13 = random_qtensor(torch, gen, kind, E, 2 * F, p13)
    w2 = random_qtensor(torch, gen, kind, F, E, p2)
    x = torch.randn((1, rows, E), generator=gen, device="cuda").bfloat16()
    launches = FF.ffn_fused.launches
    got = FF.ffn_fused(x, w13, w2)
    assert FF.ffn_fused.launches == launches + 1 and tuple(got.shape) == (1, rows, E)
    _close(got, FF.ffn_fused_plain(x, w13, w2), True)
    ctas = FF._coresident[FF._KINDS[kind]]
    assert FF.ffn_plan(E, F, ctas).grid <= ctas
    _close(got, FF.ffn_fused_split_plain(x, w13, w2, ctas), True)
    again = FF.ffn_fused(x, w13, w2)
    assert torch.equal(again, got)
    assert _ffn_counters_at_rest(FF, x.device)


def _ffn_counters_at_rest(FF, device) -> bool:
    """K7's barrier count and tile counters at 0 (word 1, the barrier's
    generation, advances by one a launch and is never reset)."""
    c = FF._counters[device][-1]
    return c[0].item() == 0 and c[2:].count_nonzero().item() == 0


@pytest.mark.parametrize("kind", ["q4_0", "q8_0"])
def test_ffn_fused_replays_in_a_graph(gen, kind):
    """K7 (a cooperative launch) captured in a CUDA graph and replayed
    twice on new x: each replay equals the eager call, and the tile
    counters and the barrier's count are back at zero after each."""
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant import ffn as FF

    E, F = 2048, 5632
    w13 = random_qtensor(torch, gen, kind, E, 2 * F, "f32")
    w2 = random_qtensor(torch, gen, kind, F, E, "f32")
    x = torch.randn((1, 1, E), generator=gen, device="cuda").bfloat16()
    FF.ffn_fused(x, w13, w2)                         # builds; makes the counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = FF.ffn_fused(x, w13, w2)
    for _ in range(2):
        x.copy_(torch.randn((1, 1, E), generator=gen, device="cuda"))
        graph.replay()
        want = FF.ffn_fused(x, w13, w2)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert _ffn_counters_at_rest(FF, x.device)


def test_ffn_fused_refuses(gen):
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant.ffn import ffn_fused

    w13 = random_qtensor(torch, gen, "q4_0", 256, 512, "f32")
    w2 = random_qtensor(torch, gen, "q4_0", 256, 256, "f32")
    with pytest.raises(ValueError, match="rows"):
        ffn_fused(torch.zeros((9, 256), device="cuda").bfloat16(), w13, w2)
    with pytest.raises(ValueError):
        ffn_fused(torch.zeros((1, 256), device="cuda"), w13, w2)         # f32 x


@pytest.mark.parametrize("kind,env", [("q4_k", None), ("q6_k", None), ("q5_1", None),
                                      ("q2_k", "TPU_LLM_NORM_FOLD"),
                                      ("q4_0", "TPU_LLM_FFN_MEGAKERNEL")])
def test_kquant_model_logits_card_match_cpu(gen, monkeypatch, kind, env):
    """A small llama in each kind, decode steps on the card (kernels) and on
    the CPU (plain twins), f32 activations (bf16 with the megakernel): the
    same logits. The switches route the norm weights through row_scale, or
    the FFN through K7."""
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.quant.convert_params import quantize_llama_params
    from tpu_llm_torch.quant.ffn import ffn_fused

    if env:
        monkeypatch.setenv(env, "1")
    cfg = LlamaConfig(dim=256, hidden_dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=100, seq_len=64)
    g = torch.Generator().manual_seed(3)
    s = lambda *shape: torch.randn(shape, generator=g) * 0.08  # noqa: E731
    dt = torch.bfloat16 if env == "TPU_LLM_FFN_MEGAKERNEL" else torch.float32
    dense = {"tok_emb": s(100, 256).to(dt), "final_norm": 1 + 0.1 * s(256), "wcls": s(256, 100),
             "layers": [{"attn_norm": 1 + 0.1 * s(256), "ffn_norm": 1 + 0.1 * s(256),
                         "wq": s(256, 256), "wk": s(256, 128), "wv": s(256, 128),
                         "wo": s(256, 256), "w1": s(256, 256), "w3": s(256, 256),
                         "w2": s(256, 256)} for _ in range(2)]}
    cpu = quantize_llama_params(dense, kind, fuse=True)
    card = quantize_llama_params(
        {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in dense.items()
         if k != "layers"} | {"layers": [{k: v.cuda() for k, v in lp.items()}
                                         for lp in dense["layers"]]}, kind, fuse=True)
    launches = ffn_fused.launches
    cc = M.init_cache(cfg, 1, 64, dtype=dt)
    gc = M.init_cache(cfg, 1, 64, dtype=dt, device="cuda")
    for pos, tok in enumerate([1, 7, 42, 99, 3]):
        want, cc = M.decode_step(cpu, cfg, torch.tensor([tok]), cc, pos)
        got, gc = M.decode_step(card, cfg, torch.tensor([tok], device="cuda"), gc, pos)
        if dt == torch.bfloat16:
            _close(got, want.cuda(), True)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    assert (ffn_fused.launches > launches) == (env == "TPU_LLM_FFN_MEGAKERNEL")


@pytest.mark.parametrize("codec", ["q4_0", "q4_k", "q6_k"])
def test_linear_k_padded_row_scale_card_match_cpu(gen, codec):
    """linear.matmul over a pad_k weight (K 768 -> 1024) with row_scale:
    x and row_scale are zero-padded on the card as on the CPU."""
    import numpy as np

    from tpu_llm_torch.quant import linear
    from tpu_llm_torch.quant.qtensor import pad_k, qmap, quantize_tensor

    rng = np.random.default_rng(4)
    w = pad_k(quantize_tensor(rng.standard_normal((768, 96)).astype(np.float32), codec))
    x = torch.from_numpy(rng.standard_normal((3, 768)).astype(np.float32))
    rs = torch.from_numpy((1 + 0.1 * rng.standard_normal(768)).astype(np.float32))
    want = linear.matmul(x, w, row_scale=rs)
    got = linear.matmul(x.cuda(), qmap(lambda p: p.cuda(), w), row_scale=rs.cuda())
    _close(got, want.cuda(), False)


# -- the --scan slice: q4_0i4 and f16-bit planes, captured decode -------------

INT4_SOURCES = ["q4_0", "q4_1", "q2_kp", "q3_kp"]


def _int4_weight(gen, src, K, N, planes):
    """A random ``src`` weight (chip_smoke.random_qtensor) through to_int4,
    its planes f32, bf16 or f16 bits (int16)."""
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant.qtensor import pack_scales_bf16, pack_scales_f16, to_int4

    w = to_int4(random_qtensor(torch, gen, src, K, N, "f32"))
    assert w.kind == "q4_0i4"
    return {"f32": w, "bf16": pack_scales_bf16(w), "int16": pack_scales_f16(w)}[planes]


@pytest.mark.parametrize("with_rs", [False, True], ids=["plain", "row_scale"])
@pytest.mark.parametrize("K,N,all_rows", [(256, 130, (1, 3, 8, 37)),
                                          (5632, 2560, (1, 5, 8, 512)),
                                          (2048, 32000, (1, 8))])
@pytest.mark.parametrize("planes", ["f32", "bf16", "int16"])
@pytest.mark.parametrize("src", INT4_SOURCES)
def test_qmatmul_int4_matches_plain(gen, src, planes, K, N, all_rows, with_rs):
    """q4_0i4 in blocks of 32 (from q4_0, q4_1 with mins) and 16 (from
    q2_kp with mins, q3_kp), f32 / bf16 / f16-bit planes, rows 1-8, 37 and
    512, ragged N, row_scale on and off, f32 and bf16 x."""
    w = _int4_weight(gen, src, K, N, planes)
    rs = (1 + 0.2 * torch.randn(K, generator=gen, device="cuda")) if with_rs else None
    for rows in all_rows:
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, K), generator=gen, device="cuda").to(xdt)
            launches = qmatmul.launches
            got = qmatmul(x, w, row_scale=rs)
            assert qmatmul.launches == launches + 1 and got.dtype == xdt
            _close(got, qmatmul_plain(x, w, row_scale=rs), xdt == torch.bfloat16)


@pytest.mark.parametrize("kind", ["q4_0", "q8_0", "q6_kp", "q5_1"])
def test_qmatmul_f16_bit_planes_every_kind(gen, kind):
    """int16 f16-bit planes for kinds other than q4_0i4 (the JAX package's
    pack_scales_f16 takes any kind), subnormal f16 scales included: exact
    decode, so the kernel equals itself on the f32 planes the bits stand for."""
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant.qtensor import QTensor as Q
    from tpu_llm_torch.quant.qtensor import pack_scales_f16, unpack_scales_f16

    w = pack_scales_f16(random_qtensor(torch, gen, kind, 2048, 2560, "f32"))
    s = w.scales.clone()
    s[:2] = (torch.randint(1, 1024, (2, 2560), generator=gen, device="cuda")
             .to(torch.int16))                            # f16 subnormals
    w = Q(w.q, s, kind, w.mins)
    f32 = Q(w.q, unpack_scales_f16(s), kind,
            w.mins if w.mins is None or w.mins.dtype == torch.uint8
            else unpack_scales_f16(w.mins))
    x = torch.randn((8, 2048), generator=gen, device="cuda")
    got = qmatmul(x, w)
    _close(got, qmatmul_plain(x, w), False)
    assert torch.equal(got, qmatmul(x, f32))


def _tiny_llama(kind="q4_0", dim=128, device="cuda"):
    from tpu_llm_torch.config import LlamaConfig
    from tpu_llm_torch.quant.convert_params import quantize_llama_params

    cfg = LlamaConfig(dim=dim, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=100, seq_len=64)
    g = torch.Generator().manual_seed(5)
    s = lambda *shape: (torch.randn(shape, generator=g) * 0.08).to(device)  # noqa: E731
    dense = {"tok_emb": s(100, dim), "final_norm": 1 + 0.1 * s(dim), "wcls": s(dim, 100),
             "layers": [{"attn_norm": 1 + 0.1 * s(dim), "ffn_norm": 1 + 0.1 * s(dim),
                         "wq": s(dim, dim), "wk": s(dim, 64), "wv": s(dim, 64),
                         "wo": s(dim, dim), "w1": s(dim, 96), "w3": s(dim, 96),
                         "w2": s(96, dim)} for _ in range(2)]}
    return quantize_llama_params(dense, kind, fuse=True), cfg


@pytest.mark.parametrize("defer_kv", [False, True])
def test_captured_step_matches_eager_and_reads_the_device_position(gen, defer_kv):
    """A decode step captured once (position, token and logits in static
    device buffers) against the eager step at two positions: the replay
    after the position moves equals the eager step there and differs from
    a replay at the stale position."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.runtime.graphs import CapturedStep

    params, cfg = _tiny_llama()
    cache = M.init_cache(cfg, 1, 64, device="cuda")
    ref = M.init_cache(cfg, 1, 64, device="cuda")
    for p, t in enumerate([1, 7, 42, 9, 3, 5]):           # fill rows 0-5 in both
        M.decode_step(params, cfg, torch.tensor([t], device="cuda"), cache, p, defer_kv)
        M.decode_step(params, cfg, torch.tensor([t], device="cuda"), ref, p, defer_kv)
    tok = torch.tensor([11], device="cuda")
    pos = torch.tensor([6], dtype=torch.int32, device="cuda")
    logits = torch.zeros((1, 100), device="cuda")

    def step():
        out, _ = M.decode_step(params, cfg, tok, cache, pos, defer_kv)
        logits.copy_(out)

    cap = CapturedStep(step, "cuda", warmup=1)            # warm-up: a real step at 6
    assert cap.graph is not None
    for p in (6, 4):
        pos.fill_(p)
        cap()
        want, _ = M.decode_step(params, cfg, tok, ref, p, defer_kv)
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
        at_p = logits.clone()
    pos.fill_(6)
    cap()
    assert not torch.allclose(logits, at_p)               # position 6 is not position 4


def test_captured_step_counts_launches_per_replay(gen):
    """The capture counts nothing; each replay adds what it launches."""
    from tpu_llm_torch.models import llama as M
    from tpu_llm_torch.ops import flash_attention as FA
    from tpu_llm_torch.runtime.graphs import CapturedStep

    params, cfg = _tiny_llama()
    cache = M.init_cache(cfg, 1, 64, device="cuda")
    tok = torch.tensor([3], device="cuda")
    pos = torch.tensor([0], dtype=torch.int32, device="cuda")

    def step():
        M.decode_step(params, cfg, tok, cache, pos)
        pos.add_(1)

    q0, a0 = qmatmul.launches, FA.flash_decode_attention.launches
    cap = CapturedStep(step, "cuda", warmup=1)
    # the warm-up step launched 2 layers x 4 projections + wcls, 2 attentions
    assert (qmatmul.launches - q0, FA.flash_decode_attention.launches - a0) == (9, 2)
    # tiny q4_0 rows take K1's decode body: qmatmul.decode counts it too
    assert cap.per_replay == {"qmatmul": 9, "qmatmul.decode": 9, "flash_decode_attention": 2}
    for _ in range(5):
        cap()
    assert (qmatmul.launches - q0, FA.flash_decode_attention.launches - a0) == (54, 12)
    assert cap.replays == 5 and int(pos.item()) == 6


@pytest.mark.parametrize("weights", ["q4_0", "q8_0_megakernel"])
def test_engine_scan_and_spec_card_match_cpu(gen, monkeypatch, weights):
    """Engine.generate with use_scan (the captured graph), host and device
    speculation: on the card every mode gives the step loop's greedy
    tokens, and with f32 activations the CPU's too (bf16 activations, the
    megakernel's, may flip a near-tie between devices); the megakernel
    (K7, a cooperative launch) replays inside the graph."""
    from tpu_llm_torch.quant.ffn import ffn_fused
    from tpu_llm_torch.runtime.engine import Engine, ModelAdapter

    kind = weights.split("_megakernel")[0]
    if weights.endswith("megakernel"):
        monkeypatch.setenv("TPU_LLM_FFN_MEGAKERNEL", "1")
    card, cfg = _tiny_llama(kind)
    cpu, _ = _tiny_llama(kind, device="cpu")
    if weights.endswith("megakernel"):
        card = dict(card, tok_emb=card["tok_emb"].bfloat16())
        cpu = dict(cpu, tok_emb=cpu["tok_emb"].bfloat16())
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        eng = Engine(params, ModelAdapter.llama(cfg, bos_id=1, device=dev), max_seq=64,
                     device=dev)
        k0 = ffn_fused.launches
        runs[dev] = [eng.generate([4, 7, 4, 7, 4, 7], n_new=24, **kw).tokens
                     for kw in ({}, {"use_scan": True}, {"use_scan": True},
                                {"speculative_k": 3},
                                {"use_scan": True, "speculative_k": 3})]
        if dev == "cuda":
            assert eng._graphs[("decode", 0.0)]["captured"].graph is not None
            assert (ffn_fused.launches > k0) == weights.endswith("megakernel")
    if not weights.endswith("megakernel"):
        assert runs["cuda"] == runs["cpu"]
    for dev in runs:
        assert all(r == runs[dev][0] for r in runs[dev]), dev


# -- K1's tensor-core body: row tiles, the in-launch K merge, ragged edges ------

TC_KINDS = ["q4_0", "q4_0i4", "q4_1", "q2_kp", "q6_kp", "q8_0", "q6_k"]


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", [(32, 1), (32, 33), (32, 130), (32, 32000), (2048, 130),
                                 (2048, 32000)])
@pytest.mark.parametrize("planes", ["f32", "bf16"])
@pytest.mark.parametrize("kind", TC_KINDS)
def test_qmatmul_tc_rows_and_edges(gen, kind, planes, K, N, xdt):
    """One launch a call at rows 1, 5, 8, 16 (one m16 tile), 17, 37 and 512
    (64-row tiles), K one block or split across CTAs and merged in the
    launch, N ragged (1, 33, 130: plain loads) or 32000; per-32 and per-16
    nibble, qh and int8 kinds, with mins and without; against the twin and
    the blocked twin (the kernel's own order), row_scale on the 5-row and
    512-row calls. The tensor-core body by name (qmatmul_body): at few rows
    qmatmul gives the nibble kinds the decode body."""
    from tpu_llm_torch.quant.qmatmul import qmatmul_blocked_plain, qmatmul_body

    if kind == "q4_0i4":
        w = _int4_weight(gen, "q4_0", K, N, planes)
    else:
        from chip_smoke import random_qtensor
        w = random_qtensor(torch, gen, kind, K, N, planes)
    bf16 = xdt == torch.bfloat16
    for rows in (1, 5, 8, 16, 17, 37, 512):
        x = torch.randn((rows, K), generator=gen, device="cuda").to(xdt)
        rs = (1 + 0.2 * torch.randn(K, generator=gen, device="cuda")) if rows in (5, 512) \
            else None
        launches, decoded = qmatmul.launches, qmatmul.decode_launches
        got = qmatmul_body(x, w, False, row_scale=rs)
        assert qmatmul.launches == launches + 1 and got.dtype == xdt
        assert qmatmul.decode_launches == decoded
        _close(got, qmatmul_plain(x, w, row_scale=rs), bf16)
        _close(got, qmatmul_blocked_plain(x, w, row_scale=rs), bf16)
        again = qmatmul_body(x, w, False, row_scale=rs)    # the tile counters are reset
        assert torch.equal(again, got)


def test_qmatmul_replays_in_a_graph(gen):
    """K1's tensor-core body with a K split (w13 width, 1 row, by name)
    captured in a CUDA graph and replayed on new x: equal to the eager call
    each time, and the tile counters back at 0."""
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant import qmatmul as QM

    w = random_qtensor(torch, gen, "q4_0", 2048, 11264, "bf16")
    x = torch.randn((1, 2048), generator=gen, device="cuda").bfloat16()
    assert QM.k_split(1, 2048, 11264, QM._sm_count(x.device))[0] > 1
    QM.qmatmul_body(x, w, False)                     # builds; makes the counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = QM.qmatmul_body(x, w, False)
    for _ in range(3):
        x.copy_(torch.randn((1, 2048), generator=gen, device="cuda"))
        graph.replay()
        want = QM.qmatmul_body(x, w, False)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert QM._tile_counters[x.device].count_nonzero().item() == 0


# -- K1's decode body: rows 1 .. DECODE_ROWS of a nibble-packed kind ------------

# Qwen2-7B's projections, then ragged N (plain loads) and planes off
# 16-byte boundaries (plain loads: values at 4 bytes, bf16 planes at 8)
DECODE_SHAPES = {"wqkv": (3584, 4608), "wo": (3584, 3584), "w13": (3584, 37888),
                 "w2": (18944, 3584), "wcls": (3584, 152064), "ragged": (96, 33),
                 "ragged_130": (256, 130), "unaligned": (512, 4096)}
# (source kind, planes): per-32 and per-16 blocks, mins, f32 / bf16 /
# f16-bit planes; q4_0i4 is to_int4 of the source, the --scan program's
DECODE_WEIGHTS = [("q4_0", "f32"), ("q4_0", "bf16"), ("q4_0i4<q4_0", "int16"),
                  ("q4_1", "f32"), ("q4_1", "bf16"), ("q2_kp", "f32"), ("q2_kp", "bf16"),
                  ("q3_kp", "f32"), ("q4_0i4<q4_1", "bf16"), ("q4_0i4<q2_kp", "int16"),
                  ("q4_0i4<q3_kp", "f32")]


def _decode_weight(g, src, planes, K, N, unaligned=False):
    from chip_smoke import random_qtensor

    w = _int4_weight(g, src.split("<")[1], K, N, planes) if "<" in src else \
        random_qtensor(torch, g, src, K, N, planes)
    if unaligned:
        def shift(t, by):
            buf = torch.zeros(t.numel() + by, dtype=t.dtype, device=t.device)
            out = buf[by:].view(t.shape)
            out.copy_(t)
            return out
        # 4 bytes past a 16-byte boundary; 2-byte planes 8 bytes (f32 planes
        # must sit on 16)
        w = QTensor(shift(w.q, 4), w.scales if w.scales.dtype == torch.float32
                    else shift(w.scales, 4), w.kind,
                    None if w.mins is None or w.mins.dtype == torch.float32
                    else shift(w.mins, 4))
    return w


# Qwen2-7B's wqkv, wo, w2 and wcls run the q4_0 weights and q4_0i4's int16
# planes; every weight runs w13 and the small shapes
DECODE_CASES = [(src, planes, shape) for shape in DECODE_SHAPES
                for src, planes in DECODE_WEIGHTS
                if shape not in ("wqkv", "wo", "w2", "wcls") or src in ("q4_0", "q4_0i4<q4_0")]


@pytest.mark.parametrize("src,planes,shape", DECODE_CASES,
                         ids=[f"{s}-{p}-{sh}" for s, p, sh in DECODE_CASES])
def test_qmatmul_decode_body_matches_plain(gen, src, planes, shape):
    """The decode body at rows 1 and DECODE_ROWS, and DECODE_ROWS + 1 on the
    tensor-core body, against the plain twin: f32 and bf16 x, x's dtype and
    f32 out, row_scale on and off. qmatmul.launches counts every call,
    qmatmul.decode_launches the decode body's; a second launch is
    bit-identical (the cross-CTA merge sums in a fixed order)."""
    from tpu_llm_torch.quant import qmatmul as QM

    K, N = DECODE_SHAPES[shape]
    w = _decode_weight(gen, src, planes, K, N, unaligned=shape == "unaligned")
    R = QM.DECODE_ROWS
    for rows in (1, R, R + 1):
        for xdt in (torch.float32, torch.bfloat16):
            x = torch.randn((rows, K), generator=gen, device="cuda").to(xdt)
            for with_rs in (False, True):
                rs = (1 + 0.2 * torch.randn(K, generator=gen, device="cuda")) if with_rs \
                    else None
                want = qmatmul_plain(x, w, torch.float32, rs)
                for out_dtype in (None, torch.float32):
                    launches, decoded = qmatmul.launches, qmatmul.decode_launches
                    got = qmatmul(x, w, out_dtype=out_dtype, row_scale=rs)
                    assert qmatmul.launches == launches + 1
                    assert qmatmul.decode_launches == decoded + (rows <= R)
                    assert got.dtype == (out_dtype or xdt)
                    _close(got, want.to(got.dtype), got.dtype == torch.bfloat16)
                    assert torch.equal(qmatmul(x, w, out_dtype=out_dtype, row_scale=rs), got)
    assert QM._tile_counters[x.device].count_nonzero().item() == 0


def test_qmatmul_decode_replays_in_a_graph(gen):
    """The decode body at Qwen2-7B's wqkv (one f32 row: every tile split
    across CTAs and merged in the launch) captured in a CUDA graph and
    replayed on new x: equal to the eager call each time, the tile counters
    back at 0, the decode count advanced by CapturedStep's replays."""
    from chip_smoke import random_qtensor
    from tpu_llm_torch.quant import qmatmul as QM
    from tpu_llm_torch.runtime.graphs import CapturedStep

    K, N = 3584, 4608
    w = random_qtensor(torch, gen, "q4_0", K, N, "f32")
    x = torch.randn((1, K), generator=gen, device="cuda")
    assert QM.takes_decode(1, K, N, 1, QM._sm_count(x.device))
    assert any(a > 0 or b < K // 32 for segs in QM.decode_ranges(1, K, N, QM._sm_count(
        x.device)) for _, a, b in segs)
    out = torch.empty((1, N), device="cuda")
    cap = CapturedStep(lambda: out.copy_(qmatmul(x, w)), "cuda")
    assert cap.per_replay == {"qmatmul": 1, "qmatmul.decode": 1}
    for _ in range(3):
        x.copy_(torch.randn((1, K), generator=gen, device="cuda"))
        decoded = qmatmul.decode_launches
        cap()
        assert qmatmul.decode_launches == decoded + 1
        want = qmatmul(x, w)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert QM._tile_counters[x.device].count_nonzero().item() == 0


@pytest.mark.parametrize("B,V", [(8, 32000), (3, 97)])
def test_filtered_sample_on_the_card_matches_cpu(gen, B, V):
    """The sampling filters have no hand kernel (the JAX package runs them
    as XLA ops): on CUDA tensors ``filtered_sample`` gives the ids of the
    same call on the CPU with the same uniforms, for every filter and
    temperature 0 (the device path takes no shortcut)."""
    from tpu_llm_torch.ops.sampling import filtered_sample

    x = torch.randn((B, V), generator=gen, device="cuda") * 3
    x = torch.round(x * 10) / 10                     # ties, at the k-th logit too
    r = torch.rand((B, 1), generator=gen, device="cuda")
    knobs = [torch.linspace(0.0, 1.5, B, device="cuda"),
             torch.tensor([0, 1, 3, 40, 0, 7, 0, 200][:B], device="cuda"),
             torch.tensor([1.0, 0.9, 0.5, 1.0, 0.3, 0.8, 0.95, 1.0][:B], device="cuda"),
             torch.tensor([0.0, 0.0, 0.05, 0.2, 0.1, 0.0, 0.01, 0.5][:B], device="cuda")]
    for trial in range(4):
        got = filtered_sample(x, r, *knobs)
        want = filtered_sample(x.cpu(), r.cpu(), *(k.cpu() for k in knobs))
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got.cpu(), want), (trial, got.cpu(), want)
        r = torch.rand((B, 1), generator=gen, device="cuda")


# -- the mesh's collectives on CUDA tensors (gloo's host route) ---------------

def test_mesh_collectives_on_the_card_match_cpu(gen):
    """Mesh.ppermute (both ways), all_to_all, reduce_scatter_model, the max,
    send / recv and broadcast over a pipe 2 x model 2 mesh of four ranks
    sharing the card in a gloo world: CUDA tensors (copied through the
    host where gloo takes CPU tensors only) give what CPU tensors give,
    bit for bit, and count alike."""
    import numpy as np
    # by its own name (pytest puts tests/ on sys.path): the "tests." form
    # does not resolve everywhere this file runs with --noconftest
    from torch_parallel_ranks import cuda_collectives_rank

    from tpu_llm_torch.parallel.distributed import launch

    for card, cpu in launch(cuda_collectives_rank, 4, device="cpu", timeout=300):
        assert card.keys() == cpu.keys()
        for k, v in cpu.items():
            if k in ("index", "counts"):
                assert card[k] == v, k
            else:
                np.testing.assert_array_equal(card[k], v, err_msg=k)
