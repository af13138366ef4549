"""Flash (online-softmax) GQA attention: wrappers of the CUDA kernels in
``csrc/flash_attention.cu`` and their plain PyTorch twins.

Three kernels, each replacing a Pallas kernel of
``tpu_llm/ops/flash_attention.py``:

- ``flash_decode_attention`` (K2, ``_decode_kernel``): one query a batch
  row against the flat (B, S, Hkv*D) cache, keys s <= pos[b], split over
  the sequence (``decode_splits``) and merged by the last split to finish,
  in one launch. Every
  non-deferred decode step (the ``llm`` CLI, ``--scan``, the dense
  ``BatchEngine``) runs it.
- ``flash_decode_fused`` (K3, ``_decode_fused_kernel``): the same
  attention against the STALE cache (s < pos) plus this step's
  k_cur/v_cur as key pos, and the store of k_cur/v_cur at row pos — in
  place, where the JAX kernel returns aliased planes. K2's split launch,
  the append owned by the split that holds pos.
  ``decode_step(defer_kv=True)`` runs it.
- ``flash_gqa_attention`` (K4, ``_flash_kernel``): causal prefill, query t
  sees s <= offset + t, on tensor cores for f32 and bf16 q over f32 and
  bf16 caches (f32 operands as three bf16 parts each,
  ``flash_gqa_attention_split_plain``). Prefill takes it when
  the einsum path's scores would pass 64 MB (models/llama._attend), and
  the paged engine's long prefill chunks over the gathered view
  (ops/paged_kv.py).

And, in ``csrc/paged_attention.cu``:

- ``paged_flash_decode_attention`` (K5, ``_paged_decode_kernel``): one
  query a batch row over shared f32/bf16 pools through an int32 block
  table, keys s <= pos[b]. Every one-query step of ``PagedEngine`` with
  f32/bf16 pools runs it.
- ``paged_flash_decode_q`` (K6, ``_paged_decode_q_kernel``): the same over
  int8 pools with 2-D scale pools (``--cache-dtype int8 --paged``).

K2, K3, K5 and K6 launch one split decode body (``csrc/decode_split.cuh``),
split by ``decode_splits`` and merged in the same launch; K5 and K6 find
each row through the block table. Each wrapper takes its plain twin for
CPU tensors and launches its kernel for CUDA tensors, or raises;
``<wrapper>.launches`` counts the kernel launches. The kernels take
head_dim a multiple of 16 up to 128; they copy 16-byte chunks, so caches
and pools start on 16-byte boundaries.
"""

from __future__ import annotations

import torch

from tpu_llm_torch.kernels import build
from tpu_llm_torch.ops.attention import (NEG_INF, _bf16_inputs, gqa_attention,
                                         gqa_attention_deferred)
from tpu_llm_torch.ops.kv_cache import QuantKV, gather_scale_pool
from tpu_llm_torch.quant.qmatmul import split3_bf16


def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = {t.device.type for t in ts}
    if dev == {"cpu"}:
        return True
    if dev == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {dev}")


_FLOAT_PLANES = (torch.float32, torch.bfloat16)


def kernel_head_dim(D: int) -> bool:
    """The head widths the attention kernels take (K2-K6): a multiple of
    16 up to 128. A model with another width (gemma's 256) attends on the
    plain path, as the JAX package routes a width its kernels refuse."""
    return D % 16 == 0 and 16 <= D <= 128


def _check_kernel_args(q, k_cache, v_cache, plane_dtypes=_FLOAT_PLANES, what="cache"):
    D = q.shape[-1]
    if not kernel_head_dim(D):
        raise ValueError(f"head_dim {D}: the attention kernels take a multiple "
                         f"of 16 up to 128")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype}: the kernels take f32 or bf16")
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in plane_dtypes:
        raise ValueError(f"{what} dtypes {k_cache.dtype}/{v_cache.dtype}: this "
                         f"kernel takes matching {plane_dtypes} planes")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{what} planes must be contiguous")
    hkv_d = k_cache[0, 0].numel()
    if hkv_d % D or q.shape[2] % (hkv_d // D):
        raise ValueError(f"{what} row width {hkv_d} does not hold whole kv "
                         f"heads of {q.shape[2]} query heads of size {D}")


def _row_positions(positions: torch.Tensor, B: int, device) -> torch.Tensor:
    """positions (1,), (B,) or (B, 1) -> (B,) int32 on ``device``."""
    pos = positions.reshape(-1).to(device=device, dtype=torch.int32)
    if pos.numel() == 1 and B > 1:
        pos = pos.expand(B)
    if pos.numel() != B:
        raise ValueError(f"positions {tuple(positions.shape)} for batch {B}")
    return pos.contiguous()


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _check_aligned(name: str, *ts: torch.Tensor):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: the kernel copies 16-byte chunks, so every "
                         f"tensor must start on a 16-byte boundary")


# -- split decode (K2, K5, K6) ------------------------------------------------

# the grid a split decode launch aims for: about two CTAs per SM of the H100
SPLIT_TARGET_CTAS = 264
SPLIT_TILE = 64          # keys per tile of the split decode kernels


# The split decode kernels' merge counters (K2, K3, K5, K6): one int32 per
# (b, kv head), a buffer per device,
# zero-filled once. Each launch leaves them at 0 again (the last split of a
# (b, kv head) resets its counter), so launches on one stream and CUDA
# graph replays share them.
SPLIT_COUNTERS = 1 << 16
_split_counters = {}


def _merge_counters(device, n: int) -> torch.Tensor:
    if n > SPLIT_COUNTERS:
        raise ValueError(f"B * Hkv = {n}: the split decode merges at most "
                         f"{SPLIT_COUNTERS} (batch row, kv head) pairs")
    counters = _split_counters.get(device)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the split decode kernels make their merge counters "
                               "at their first call: call one before a graph capture")
        counters = torch.zeros(SPLIT_COUNTERS, dtype=torch.int32, device=device)
        _split_counters[device] = counters
    return counters


def _split_scratch(q, Hkv: int, n_split: int):
    """(part_acc, part_ml, merge counters) of a split launch over q (B, 1,
    H, D); all None with one split (the kernel writes the output itself)."""
    if n_split == 1:
        return None, None, None
    B, _, H, D = q.shape
    part_acc = torch.empty((B * H, n_split, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B * H, n_split, 2), dtype=torch.float32, device=q.device)
    return part_acc, part_ml, _merge_counters(q.device, B * Hkv)


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_splits(B: int, Hkv: int, max_rows: int):
    """(rows_per_split, n_split): the sequence splits over the grid until
    B * Hkv * n_split reaches SPLIT_TARGET_CTAS, each split a whole number
    of 64-row tiles. It reads shapes only, never positions, so a captured
    CUDA graph replays it at any position."""
    tiles = -(-max_rows // SPLIT_TILE)
    want = min(tiles, max(1, -(-SPLIT_TARGET_CTAS // (B * Hkv))))
    rows = -(-tiles // want) * SPLIT_TILE
    return rows, -(-max_rows // rows)


# -- K2 ----------------------------------------------------------------------

def flash_decode_attention_plain(q, k_cache, v_cache, positions):
    B = q.shape[0]
    pos = _row_positions(positions, B, q.device)
    return gqa_attention(q, k_cache, v_cache, pos.reshape(B, 1))


def flash_decode_attention_split_plain(q, k_cache, v_cache, positions,
                                       rows_per_split=None):
    """K2's split-and-merge in plain PyTorch (for the tests): each split
    of ``rows_per_split`` rows (``decode_splits`` by default) computes its
    unnormalised partial (acc, m, l) over its rows s <= pos[b], an empty
    split (m = NEG_INF, l = 0, acc = 0) past pos; the partials merge in
    split order as the kernel's last split merges them (empty splits add
    nothing)."""
    B, _, _, D = q.shape
    S = k_cache.shape[1]
    pos = _row_positions(positions, B, q.device).clamp(max=S - 1).long()
    k4 = k_cache.reshape(B, S, -1, D).float()
    v4 = v_cache.reshape(B, S, -1, D).float()
    if rows_per_split is None:
        rows_per_split = decode_splits(B, k4.shape[2], S)[0]
    return _split_merge_plain(q, q.float(), k4, v4, pos, rows_per_split,
                              _bf16_inputs(q, k_cache, v_cache))


def _split_merge_plain(q, qf, k4, v4, pos, rows_per_split, round_p, ks=None, vs=None):
    """The split decode kernels' arithmetic over f32 (B, S, Hkv, D) rows:
    qf (B, 1, H, D) f32 scores q . k * sm_scale (times ks (B, Hkv, S) for
    int8 rows), each split's partial over its rows s <= pos[b] with the AV
    weight p (times vs), rounded to bf16 when ``round_p``, merged in split
    order. Output in q's dtype."""
    B, _, H, D = q.shape
    S, Hkv = k4.shape[1], k4.shape[2]
    qg = qf.reshape(B, Hkv, H // Hkv, D)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k4) * (1.0 / D ** 0.5)
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    visible = torch.arange(S, device=q.device)[None, :] <= pos[:, None]   # (B, S)
    v4 = v4.masked_fill(~visible[:, :, None, None], 0.0)   # rows past pos add nothing
    parts = []
    for s0 in range(0, S, rows_per_split):
        vis = visible[:, None, None, s0:s0 + rows_per_split]
        sc = scores[..., s0:s0 + rows_per_split].masked_fill(~vis, NEG_INF)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None]).masked_fill(~vis, 0.0)
        l = p.sum(dim=-1)
        if vs is not None:
            p = (p * vs[:, :, None, s0:s0 + rows_per_split]).masked_fill(~vis, 0.0)
        if round_p:
            p = p.bfloat16().float()
        acc = torch.einsum("bhgs,bshd->bhgd", p, v4[:, s0:s0 + rows_per_split])
        parts.append((acc, m, l))
    m_all = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    acc_sum = torch.zeros_like(parts[0][0])
    l_sum = torch.zeros_like(parts[0][1])
    for acc, m, l in parts:
        w = torch.exp(m - m_all)
        l_sum = l_sum + w * l
        acc_sum = acc_sum + w[..., None] * acc
    inv = torch.where(l_sum == 0, torch.ones_like(l_sum), 1.0 / l_sum)
    return (acc_sum * inv[..., None]).reshape(B, 1, H, D).to(q.dtype)


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); caches (B, S, Hkv*D) or (B, S, Hkv, D); positions
    (1,), (B,) or (B, 1). Returns (B, 1, H, D) in q's dtype. On the card,
    launches on one device share its merge counters: make them on one
    stream at a time."""
    if _on_cpu(q, k_cache, v_cache):
        return flash_decode_attention_plain(q, k_cache, v_cache, positions)
    _check_kernel_args(q, k_cache, v_cache)
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode attention takes one query a row, got T={T}")
    S = k_cache.shape[1]
    out = _split_decode_launch("flash_decode_attention", q, k_cache.reshape(B, S, -1),
                               v_cache.reshape(B, S, -1), None, None, positions)
    flash_decode_attention.launches += 1
    return out


def _split_decode_launch(name, q, kc, vc, kcur, vcur, positions):
    """One launch of the split decode body over flat (B, S, Hkv*D) caches:
    K2, or K3 with ``kcur`` / ``vcur`` ((B, Hkv*D) in the cache dtype)
    attended as key pos and stored at row pos."""
    B, _, H, D = q.shape
    _check_aligned(name, kc, vc, *(t for t in (kcur, vcur) if t is not None))
    S = kc.shape[1]
    Hkv = kc.shape[2] // D
    rows, n_split = decode_splits(B, Hkv, S)
    q = q.contiguous()
    pos = _row_positions(positions, B, q.device)
    out = torch.empty_like(q)
    scratch = _split_scratch(q, Hkv, n_split)
    code = build.lib().tlt_flash_decode(
        q.data_ptr(), _is_bf16(q), kc.data_ptr(), vc.data_ptr(), _is_bf16(kc),
        _ptr(kcur), _ptr(vcur), pos.data_ptr(), out.data_ptr(), *map(_ptr, scratch),
        B, H, Hkv, D, S, rows, n_split, 1.0 / D ** 0.5, build.stream_ptr(q.device))
    build.check(code, name)
    return out


flash_decode_attention.launches = 0


# -- K3 ----------------------------------------------------------------------

def flash_decode_fused_plain(q, k_cache, v_cache, k_cur, v_cur, positions):
    B, S = q.shape[0], k_cache.shape[1]
    pos = _row_positions(positions, B, q.device)
    k_cur = k_cur.to(k_cache.dtype)   # the current token enters in cache dtype
    v_cur = v_cur.to(v_cache.dtype)
    attn = gqa_attention_deferred(q, k_cache, v_cache, k_cur, v_cur,
                                  pos.reshape(B, 1))
    rows = torch.arange(B, device=q.device)
    slot = torch.clamp(pos.long(), max=S - 1)
    k_cache[rows, slot] = k_cur.reshape(B, -1)
    v_cache[rows, slot] = v_cur.reshape(B, -1)
    return attn, k_cache, v_cache


def flash_decode_fused_split_plain(q, k_cache, v_cache, k_cur, v_cur, positions,
                                   rows_per_split=None):
    """K3's split-and-merge in plain PyTorch (for the tests): K2's
    (``flash_decode_attention_split_plain``) over the cache with key pos
    taken from k_cur / v_cur (cast to the cache dtype), as the split that
    holds pos reads it; that split also stores them at row pos, in place.
    Returns (attn, k_cache, v_cache)."""
    B, S = q.shape[0], k_cache.shape[1]
    pos = _row_positions(positions, B, q.device).clamp(max=S - 1).long()
    rows = torch.arange(B, device=q.device)
    for cache, cur in ((k_cache, k_cur), (v_cache, v_cur)):
        cache[rows, pos] = cur.to(cache.dtype).reshape(B, -1)
    attn = flash_decode_attention_split_plain(q, k_cache, v_cache, pos, rows_per_split)
    return attn, k_cache, v_cache


def flash_decode_fused(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, k_cur: torch.Tensor,
                       v_cur: torch.Tensor, positions: torch.Tensor):
    """Decode attention against the STALE flat cache (B, S, Hkv*D) plus
    this step's k_cur/v_cur (B, 1, Hkv*D), which are stored at row pos IN
    PLACE. k_cur/v_cur are cast to the cache dtype first, so a bf16 cache
    rounds the current token before it enters the softmax. Returns
    (attn (B, 1, H, D), k_cache, v_cache). On the card it is K2's split
    launch (``decode_splits``, the same merge counters) with the append
    owned by the split that holds pos: make the first call outside a
    graph capture."""
    if _on_cpu(q, k_cache, v_cache, k_cur, v_cur):
        return flash_decode_fused_plain(q, k_cache, v_cache, k_cur, v_cur,
                                        positions)
    _check_kernel_args(q, k_cache, v_cache)
    B, T, H, D = q.shape
    if T != 1 or k_cache.dim() != 3:
        raise ValueError("fused decode takes one query a row and flat caches")
    HkvD = k_cache.shape[2]
    kcur = k_cur.to(k_cache.dtype).reshape(B, HkvD).contiguous()
    vcur = v_cur.to(v_cache.dtype).reshape(B, HkvD).contiguous()
    out = _split_decode_launch("flash_decode_fused", q, k_cache, v_cache, kcur, vcur,
                               positions)
    flash_decode_fused.launches += 1
    return out, k_cache, v_cache


flash_decode_fused.launches = 0


# -- K4 ----------------------------------------------------------------------

def flash_gqa_attention_plain(q, k_cache, v_cache, offset: int):
    T = q.shape[1]
    positions = offset + torch.arange(T, device=q.device, dtype=torch.int32)
    return gqa_attention(q, k_cache, v_cache, positions)


def _parts_product(eq, a_parts, b_parts):
    """The f32 sum of the einsum products a_i b_j with i + j <= 2, in the
    kernel's order (b part by b part, a parts within): every product down
    to 2^-16 of the leading one."""
    out = None
    for j, b in enumerate(b_parts):
        for a in a_parts[:3 - j]:
            term = torch.einsum(eq, a, b)
            out = term if out is None else out + term
    return out


def flash_gqa_attention_split_plain(q, k_cache, v_cache, offset: int):
    """K4's arithmetic in plain PyTorch (for the tests): each f32 operand
    (q, an f32 cache's K and V rows, the unrounded softmax weights P) as
    three bf16 parts (``split3_bf16``), a bf16 one as itself; S = q K^T
    and O = P V as the f32 sums of the part products with i + j <= 2,
    as the kernel keeps them (with bf16 q and cache P is rounded to bf16
    instead). The softmax is taken over the whole row at once, where the
    kernel runs it tile by tile: only the f32 rounding of the two differs.
    q (B, T, H, D); caches (B, S, Hkv, D) or flat; output in q's dtype."""
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    k4 = k_cache.reshape(B, S, -1, D)
    v4 = v_cache.reshape(B, S, -1, D)
    G = H // k4.shape[2]

    def parts(t):
        f = t.float()
        return split3_bf16(f) if t.dtype == torch.float32 else (f,)

    qg = q.reshape(B, T, -1, G, D)
    s = _parts_product("btkgd,bskd->bkgts", parts(qg), parts(k4)) * (1.0 / D ** 0.5)
    pos = offset + torch.arange(T, device=q.device)
    visible = torch.arange(S, device=q.device)[None, :] <= pos[:, None]   # (T, S)
    s = s.masked_fill(~visible, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~visible, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if q.dtype == torch.bfloat16 and k_cache.dtype == torch.bfloat16:
        p_parts = (p.bfloat16().float(),)
    else:
        p_parts = split3_bf16(p)
    o = _parts_product("bkgts,bskd->bkgtd", p_parts, parts(v4))
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


def flash_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, offset: int) -> torch.Tensor:
    """Causal prefill attention. q (B, T, H, D); caches (B, S, Hkv, D) or
    flat (B, S, Hkv*D); query t sees cache slots s <= offset + t. Returns
    (B, T, H, D) in q's dtype."""
    if _on_cpu(q, k_cache, v_cache):
        return flash_gqa_attention_plain(q, k_cache, v_cache, offset)
    _check_kernel_args(q, k_cache, v_cache)
    B, T, H, D = q.shape
    S = k_cache.shape[1]
    kc = k_cache.reshape(B, S, -1)
    vc = v_cache.reshape(B, S, -1)
    q = q.contiguous()
    _check_aligned("flash_gqa_attention", q, kc, vc)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = build.lib().tlt_flash_prefill(
        q.data_ptr(), _is_bf16(q), kc.data_ptr(), vc.data_ptr(), _is_bf16(kc),
        out.data_ptr(), B, T, H, kc.shape[2] // D, D, S, int(offset),
        1.0 / D ** 0.5, build.stream_ptr(q.device))
    build.check(code, "flash_gqa_attention")
    flash_gqa_attention.launches += 1
    return out


flash_gqa_attention.launches = 0


# -- K5 / K6: paged decode ---------------------------------------------------

def _gather_pool(pool, block_table):
    """(N, BS, Hkv*D) pool through a (B, MB) table -> (B, MB*BS, Hkv*D)."""
    B = block_table.shape[0]
    return pool[block_table.long()].reshape(B, -1, pool.shape[-1])


def paged_flash_decode_attention_plain(q, k_pool, v_pool, block_table, positions):
    """The gather route: the blocks to a (B, MB*BS) view, then masked GQA
    attention with kv_lengths = pos + 1."""
    B, D = q.shape[0], q.shape[-1]
    pos = _row_positions(positions, B, q.device)
    k, v = (_gather_pool(p, block_table).unflatten(-1, (-1, D)) for p in (k_pool, v_pool))
    return gqa_attention(q, k, v, pos.reshape(B, 1), kv_lengths=pos + 1)


def paged_flash_decode_q_plain(q, k_pool, v_pool, k_scale, v_scale, block_table,
                               positions):
    """The int8 gather route: gathered int8 planes and scales, the int8
    einsum path with kv_lengths = pos + 1."""
    B, D = q.shape[0], q.shape[-1]
    pos = _row_positions(positions, B, q.device)
    n, bs, kvd = k_pool.shape
    k, v = (QuantKV(_gather_pool(p, block_table),
                    gather_scale_pool(sc, block_table, n, kvd // D, bs))
            for p, sc in ((k_pool, k_scale), (v_pool, v_scale)))
    return gqa_attention(q, k, v, pos.reshape(B, 1), kv_lengths=pos + 1)


def paged_flash_decode_split_plain(q, k_pool, v_pool, block_table, positions,
                                   k_scale=None, v_scale=None, rows_per_split=None):
    """K5's and K6's split-and-merge in plain PyTorch (for the tests): the
    rows gathered through the table, split in runs of ``rows_per_split``
    (``decode_splits(B, Hkv, MB*BS)`` by default), each split's partial
    over its rows s <= pos[b] (empty past pos), merged in split order, as
    the kernel computes them. f32/bf16 pools (K5): p rounded to bf16 when
    q is bf16. int8 pools with ``k_scale`` / ``v_scale`` (K6): q rounded
    to bf16, the score times the row's k scale, l over the unrounded p,
    the AV weight p * vs rounded to bf16. Table entries past pos // BS
    must index the pool but are never used."""
    B, _, H, D = q.shape
    n, bs, kvd = k_pool.shape
    Hkv, S = kvd // D, block_table.shape[1] * bs
    pos = _row_positions(positions, B, q.device).clamp(max=S - 1).long()
    k4, v4 = (_gather_pool(p, block_table).float().reshape(B, S, Hkv, D)
              for p in (k_pool, v_pool))
    if rows_per_split is None:
        rows_per_split = decode_splits(B, Hkv, S)[0]
    if k_scale is None:
        return _split_merge_plain(q, q.float(), k4, v4, pos, rows_per_split,
                                  q.dtype == torch.bfloat16)
    ks, vs = (gather_scale_pool(sc, block_table, n, Hkv, bs) for sc in (k_scale, v_scale))
    return _split_merge_plain(q, q.bfloat16().float(), k4, v4, pos, rows_per_split, True,
                              ks, vs)


def _check_paged_args(q, k_pool, v_pool, block_table, pool_dtypes):
    B, T = q.shape[:2]
    if T != 1:
        raise ValueError(f"paged decode takes one query a row, got T={T}")
    if k_pool.dim() != 3 or k_pool.shape != v_pool.shape:
        raise ValueError("pools must be (N, BS, Hkv*D) planes of one shape")
    _check_kernel_args(q, k_pool, v_pool, pool_dtypes, what="pool")
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != B or not block_table.is_contiguous()):
        raise ValueError(f"block table must be a contiguous (B, MB) int32 tensor, "
                         f"got {tuple(block_table.shape)} {block_table.dtype}")


def _paged_launch(name, q, k_pool, v_pool, block_table, positions, call):
    """Shared set-up of the K5 / K6 launches (the split decode body over
    the pools, one launch); ``call`` gets the arguments that follow the
    pools and scales in the C signature."""
    _check_aligned(name, k_pool, v_pool)
    B, _, H, D = q.shape
    Hkv = k_pool.shape[2] // D
    bs, mb = k_pool.shape[1], block_table.shape[1]
    rows, n_split = decode_splits(B, Hkv, mb * bs)
    q = q.contiguous()
    pos = _row_positions(positions, B, q.device)
    out = torch.empty_like(q)
    scratch = _split_scratch(q, Hkv, n_split)
    code = call(q, block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                *map(_ptr, scratch), B, H, Hkv, D, bs, mb, rows, n_split, 1.0 / D ** 0.5,
                build.stream_ptr(q.device))
    build.check(code, name)
    return out


def paged_flash_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, block_table: torch.Tensor,
                                 positions: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H, D); pools (N, BS, Hkv*D) f32/bf16; block_table (B, MB)
    int32; positions (B,) or (B, 1). Row b attends its logical rows s <=
    positions[b]; table entries past positions[b] // BS are never read.
    Returns (B, 1, H, D) in q's dtype. On the card it shares the split
    decode kernels' merge counters: make the first call outside a graph
    capture, and launches on one device on one stream at a time."""
    if _on_cpu(q, k_pool, v_pool, block_table):
        return paged_flash_decode_attention_plain(q, k_pool, v_pool, block_table,
                                                  positions)
    _check_paged_args(q, k_pool, v_pool, block_table, _FLOAT_PLANES)
    out = _paged_launch(
        "paged_flash_decode_attention", q, k_pool, v_pool, block_table, positions,
        lambda qc, *rest: build.lib().tlt_paged_decode(
            qc.data_ptr(), _is_bf16(qc), k_pool.data_ptr(), v_pool.data_ptr(),
            _is_bf16(k_pool), *rest))
    paged_flash_decode_attention.launches += 1
    return out


paged_flash_decode_attention.launches = 0


def paged_flash_decode_q(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor,
                         block_table: torch.Tensor,
                         positions: torch.Tensor) -> torch.Tensor:
    """K5 over int8 pools (N, BS, Hkv*D) with f32 scale pools (N*HP, SP):
    the scale of (block b, kv head h, offset o) is scale[b*HP + h, o].
    Returns (B, 1, H, D) in q's dtype."""
    if _on_cpu(q, k_pool, v_pool, k_scale, v_scale, block_table):
        return paged_flash_decode_q_plain(q, k_pool, v_pool, k_scale, v_scale,
                                          block_table, positions)
    _check_paged_args(q, k_pool, v_pool, block_table, (torch.int8,))
    n, bs, kvd = k_pool.shape
    hkv = kvd // q.shape[-1]
    for sc in (k_scale, v_scale):
        if (sc.dtype != torch.float32 or sc.dim() != 2 or sc.shape != k_scale.shape
                or sc.shape[0] % n or sc.shape[0] // n < hkv or sc.shape[1] < bs
                or not sc.is_contiguous()):
            raise ValueError(f"scale pools must be contiguous f32 (N*HP, SP) with "
                             f"HP >= {hkv} and SP >= {bs}, got {tuple(sc.shape)} "
                             f"{sc.dtype}")
    hp, sp = k_scale.shape[0] // n, k_scale.shape[1]
    out = _paged_launch(
        "paged_flash_decode_q", q, k_pool, v_pool, block_table, positions,
        lambda qc, *rest: build.lib().tlt_paged_decode_q(
            qc.data_ptr(), _is_bf16(qc), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), hp, sp, *rest))
    paged_flash_decode_q.launches += 1
    return out


paged_flash_decode_q.launches = 0
