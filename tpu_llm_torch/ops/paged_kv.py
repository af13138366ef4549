"""Paged (blocked) KV cache (``tpu_llm/ops/paged_kv.py``).

Each layer's K and V live in shared pools of fixed-size blocks,
(n_blocks, block_size, Hkv*D); a sequence reaches its rows through an
int32 block table (B, max_blocks): logical row s of batch row b is
``pool[table[b, s // BS], s % BS]``. Block 0 is the null block every
unmapped table entry points at. Allocation (``BlockAllocator``) and
prefix sharing (``PrefixCache``) are host-side scheduling.

int8 pools keep one f32 scale per (token, kv head) in 2-D scale pools
(n_blocks * HP, SP): block b's scales are rows [b*HP, b*HP + Hkv), column
= offset in the block. HP (Hkv rounded up to 8) and SP (block_size rounded
up to 128) come from TPU layout rules; the port keeps them so its pools
compare element for element with the reference's (a compact
(N, Hkv, BS) layout is queued in ROADMAP.md).

Writes (``paged_update_tokens``) are IN PLACE, pools and ``lengths``
alike (the reference returns new arrays). Attention
(``paged_gqa_attention``) routes as the reference does: a one-query
step on the card goes to the paged decode kernel (K5, or K6 for int8
pools, ops/flash_attention.py); a long prefill on the card to the flash
prefill kernel (K4) over the gathered view; everything else, and every
step on the CPU, gathers the blocks to a (B, MB*BS, Hkv*D) view and runs
the masked GQA attention with ``kv_lengths``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch

from tpu_llm_torch.ops.attention import gqa_attention
from tpu_llm_torch.ops.flash_attention import (flash_gqa_attention, kernel_head_dim,
                                               paged_flash_decode_attention,
                                               paged_flash_decode_q)
from tpu_llm_torch.ops.kv_cache import QuantKV, gather_scale_pool, quantize_kv


def scale_pool_width(block_size: int) -> int:
    """Scale-pool minor dim: block_size rounded up to 128."""
    return -(-block_size // 128) * 128


def scale_rows_per_block(n_kv_heads: int) -> int:
    """Rows one block's scales occupy in the 2-D scale pool: Hkv rounded
    up to 8."""
    return -(-n_kv_heads // 8) * 8


@dataclasses.dataclass
class PagedKV:
    """One layer's paged KV state. ``k_scale``/``v_scale`` (n_blocks*HP,
    SP) f32 are set for int8 pools."""

    k_pool: torch.Tensor        # (n_blocks, block_size, Hkv*D)
    v_pool: torch.Tensor
    block_table: torch.Tensor   # (B, max_blocks) int32 pool indices
    lengths: torch.Tensor       # (B,) int32 valid token count per sequence
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[1]

    @property
    def max_tokens(self) -> int:
        return self.block_table.shape[1] * self.block_size

    @classmethod
    def zeros(cls, n_blocks: int, block_size: int, batch: int, max_blocks: int,
              kv_dim: int, dtype=torch.bfloat16, n_kv_heads: Optional[int] = None,
              device="cpu") -> "PagedKV":
        quant = dtype in ("int8", torch.int8)
        if quant and not n_kv_heads:
            raise ValueError("int8 pools need n_kv_heads for the scale pools")
        mk = lambda: torch.zeros((n_blocks, block_size, kv_dim),  # noqa: E731
                                 dtype=torch.int8 if quant else dtype, device=device)
        sc = lambda: (torch.zeros((n_blocks * scale_rows_per_block(n_kv_heads),  # noqa: E731
                                   scale_pool_width(block_size)),
                                  dtype=torch.float32, device=device)
                      if quant else None)
        return cls(mk(), mk(), torch.zeros((batch, max_blocks), dtype=torch.int32,
                                           device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device), sc(), sc())


def paged_update(kv: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                 positions) -> PagedKV:
    """Write one token a sequence (k_new/v_new (B, 1, Hkv, D)) at per-row
    ``positions`` (B,)."""
    return paged_update_tokens(kv, k_new, v_new, positions)


def paged_update_tokens(kv: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                        pos0) -> PagedKV:
    """Write T consecutive tokens a sequence (k_new/v_new (B, T, Hkv, D))
    from ``pos0`` (int, or (B,) tensor), in place, and raise ``lengths``
    to max(lengths, last position + 1). Positions whose table entry is
    the null block, or that lie past the table, write into block 0 (the
    trash block), never into the clamped last column."""
    B, T, hkv, _ = k_new.shape
    bs, kvd = kv.block_size, kv.k_pool.shape[-1]
    dev = kv.k_pool.device
    if torch.is_tensor(pos0):
        start = pos0.reshape(-1).to(device=dev, dtype=torch.long).expand(B)
    else:
        start = torch.full((B,), int(pos0), dtype=torch.long, device=dev)
    positions = start[:, None] + torch.arange(T, device=dev)[None, :]    # (B, T)
    mb = kv.block_table.shape[1]
    block_idx = positions // bs
    block_ids = torch.gather(kv.block_table.long(), 1, block_idx.clamp(0, mb - 1))
    block_ids = torch.where(block_idx < mb, block_ids, torch.zeros_like(block_ids))
    offs = positions % bs
    kv.lengths.copy_(torch.maximum(kv.lengths, (positions[:, -1] + 1).to(kv.lengths.dtype)))
    if kv.quantized:
        kq, ks = quantize_kv(k_new)              # (B,T,Hkv,D) int8, (B,T,Hkv)
        vq, vs = quantize_kv(v_new)
        hp = kv.k_scale.shape[0] // kv.k_pool.shape[0]
        rows = block_ids[..., None] * hp + torch.arange(hkv, device=dev)   # (B,T,Hkv)
        cols = offs[..., None].expand(B, T, hkv)
        kv.k_pool[block_ids, offs] = kq.reshape(B, T, kvd)
        kv.v_pool[block_ids, offs] = vq.reshape(B, T, kvd)
        kv.k_scale[rows, cols] = ks
        kv.v_scale[rows, cols] = vs
        return kv
    kv.k_pool[block_ids, offs] = k_new.reshape(B, T, kvd).to(kv.k_pool.dtype)
    kv.v_pool[block_ids, offs] = v_new.reshape(B, T, kvd).to(kv.v_pool.dtype)
    return kv


def paged_gather(kv: PagedKV, n_kv_heads: Optional[int] = None):
    """Each sequence's logical view (B, MB*BS, Hkv*D); for int8 pools a
    flat ``QuantKV`` pair with (B, Hkv, MB*BS) scales (``n_kv_heads``
    required). Rows past ``lengths`` hold whatever the mapped blocks
    hold: callers mask with ``lengths``."""
    table = kv.block_table.long()
    B, mb = table.shape
    n, bs, kvd = kv.k_pool.shape
    k = kv.k_pool[table].reshape(B, mb * bs, kvd)
    v = kv.v_pool[table].reshape(B, mb * bs, kvd)
    if not kv.quantized:
        return k, v
    if not n_kv_heads:
        raise ValueError("int8 paged_gather needs n_kv_heads")
    return (QuantKV(k, gather_scale_pool(kv.k_scale, kv.block_table, n, n_kv_heads, bs)),
            QuantKV(v, gather_scale_pool(kv.v_scale, kv.block_table, n, n_kv_heads, bs)))


def paged_gqa_attention(q: torch.Tensor, kv: PagedKV, q_positions: torch.Tensor,
                        offset=None) -> torch.Tensor:
    """Attention over the paged cache. q (B, T, H, D); q_positions (T,) or
    (B, T); ``offset`` an int when every row starts at the same position
    (prefill), which opens the flash prefill route."""
    B, T, H, D = q.shape
    on_card = q.device.type == "cuda"
    if T == 1 and on_card and kernel_head_dim(D):
        pos = q_positions.reshape(-1).to(torch.int32).expand(B)
        if kv.quantized:
            return paged_flash_decode_q(q, kv.k_pool, kv.v_pool, kv.k_scale,
                                        kv.v_scale, kv.block_table, pos)
        return paged_flash_decode_attention(q, kv.k_pool, kv.v_pool,
                                            kv.block_table, pos)
    kvd = kv.k_pool.shape[-1]
    k, v = paged_gather(kv, n_kv_heads=kvd // D)
    if kv.quantized:
        return gqa_attention(q, k, v, q_positions, kv_lengths=kv.lengths)
    S = k.shape[1]
    k = k.reshape(B, S, kvd // D, D)
    v = v.reshape(B, S, kvd // D, D)
    # long-prompt prefill: the flash kernel instead of (B, T, H, S) scores
    # (the reference's gate). Causal masking makes the lengths mask
    # redundant: every slot <= q_pos was written by this call or before.
    if (on_card and isinstance(offset, int) and T >= 256 and T % 256 == 0
            and S % 256 == 0 and kernel_head_dim(D)):
        return flash_gqa_attention(q, k, v, offset)
    return gqa_attention(q, k, v, q_positions, kv_lengths=kv.lengths)


class BlockAllocator:
    """Host-side refcounted free list over the shared pool. Block 0 is
    the null block. Blocks are shared by reference count (prefix
    caching); a block frees when its last reference drops. Admission
    reserves worst-case growth so decode never runs dry mid-request."""

    def __init__(self, n_blocks: int):
        self.free: List[int] = list(range(n_blocks - 1, 0, -1))
        self.refs: Dict[int, int] = {}
        self.n_reserved = 0
        # called with the shortfall when alloc() runs dry; returns how many
        # blocks it freed (PrefixCache.evict)
        self.reclaim: Optional[Callable[[int], int]] = None

    @property
    def n_free(self) -> int:
        return len(self.free)

    def _ensure(self, n: int) -> None:
        short = n - (len(self.free) - self.n_reserved)
        if short > 0 and self.reclaim is not None:
            self.reclaim(short)
        if n > len(self.free) - self.n_reserved:
            raise MemoryError(
                f"paged KV pool exhausted ({n} needed, "
                f"{len(self.free)} free - {self.n_reserved} reserved)")

    def alloc(self, n: int = 1, *, reserved: bool = False) -> List[int]:
        """n blocks; ``reserved=True`` draws down an existing reservation."""
        if reserved:
            assert n <= self.n_reserved <= len(self.free), "reservation bug"
            self.n_reserved -= n
        else:
            self._ensure(n)
        out = [self.free.pop() for _ in range(n)]
        for b in out:
            self.refs[b] = 1
        return out

    def reserve(self, n: int) -> None:
        self._ensure(n)
        self.n_reserved += n

    def unreserve(self, n: int) -> None:
        assert n <= self.n_reserved
        self.n_reserved -= n

    def incref(self, block: int) -> None:
        self.refs[block] += 1

    def decref(self, block: int) -> None:
        if block == 0:
            return
        self.refs[block] -= 1
        if self.refs[block] == 0:
            del self.refs[block]
            self.free.append(block)

    def release(self, blocks) -> None:
        for b in blocks:
            self.decref(int(b))


class PrefixCache:
    """Prompt prefix cache over full KV blocks. A block's identity is the
    SHA-1 chain of all token ids from the sequence start through that
    block (each id 4 bytes, little-endian, signed), byte for byte the
    reference's digests. Registered blocks hold one cache reference; when
    the pool runs dry, least-recently-matched entries that only the cache
    holds are evicted."""

    def __init__(self, allocator: BlockAllocator):
        self.alloc = allocator
        self._map: "OrderedDict[bytes, int]" = OrderedDict()   # digest -> block
        self._rev: Dict[int, bytes] = {}
        allocator.reclaim = self.evict
        self.hits = 0          # blocks served from the cache at admission
        self.queries = 0       # full blocks eligible for matching
        self.evictions = 0

    @staticmethod
    def digests(tokens: List[int], block_size: int) -> List[bytes]:
        """Chained digest per FULL block of ``tokens``."""
        out, h = [], hashlib.sha1()
        for start in range(0, (len(tokens) // block_size) * block_size, block_size):
            h.update(b"".join(int(t).to_bytes(4, "little", signed=True)
                              for t in tokens[start:start + block_size]))
            out.append(h.digest())
        return out

    def match(self, tokens: List[int], block_size: int,
              digests: Optional[List[bytes]] = None) -> List[int]:
        """Block ids of the longest cached prefix (increfed for the
        caller), capped at len(tokens) - 1 tokens so admission always has
        a tail token to forward."""
        hits: List[int] = []
        max_blocks = (len(tokens) - 1) // block_size
        self.queries += max_blocks
        if digests is None:
            digests = self.digests(tokens, block_size)
        for d in digests[:max_blocks]:
            bid = self._map.get(d)
            if bid is None:
                break
            self.alloc.incref(bid)
            self._map.move_to_end(d)          # LRU touch
            hits.append(bid)
        self.hits += len(hits)
        return hits

    def insert(self, tokens: List[int], block_size: int, blocks: List[int],
               digests: Optional[List[bytes]] = None) -> None:
        """Register ``blocks`` under the chained digests of ``tokens``;
        each newly registered block gains one cache reference."""
        if digests is None:
            digests = self.digests(tokens, block_size)
        for d, bid in zip(digests, blocks):
            if d in self._map or bid in self._rev or bid == 0:
                continue
            self.alloc.incref(bid)
            self._map[d] = bid
            self._rev[bid] = d

    def evict(self, n: int) -> int:
        """Drop up to ``n`` least-recently-matched entries that only the
        cache references. Returns the number freed."""
        victims = [d for d, bid in self._map.items()
                   if self.alloc.refs.get(bid) == 1][:n]
        for d in victims:
            bid = self._map.pop(d)
            del self._rev[bid]
            self.alloc.decref(bid)
        self.evictions += len(victims)
        return len(victims)
