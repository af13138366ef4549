"""Paged-KV continuous batching with prefix caching
(``tpu_llm/runtime/paged_engine.py``).

Each slot's sequence maps onto fixed-size blocks of shared per-layer
pools through an int32 block table (ops/paged_kv.py), so device memory
follows the tokens actually resident, and full prompt-prefix blocks are
shared between requests: admission increfs the cached blocks and
forwards only the tail. Scheduling (admission, block allocation and
release, prefix matching) is host-side between steps, as the dense
engine's slot logic is.

Admission is all-or-nothing: the tail blocks are allocated and the
worst-case decode growth reserved at once, or the request waits (pool
pressure) — or raises ``MemoryError`` when nothing runs and the pool can
never serve it. Long tails prefill in chunks of ``prefill_chunk`` tokens,
then a bucketed last piece. Decode growth maps a fresh block when the
next write crosses into an unmapped one (``_pre_dispatch``). A finished
request's full blocks go into the prefix cache, and its slot's table row
is pointed at the null block, where the dead slot's garbage writes land.

Speculation (``speculative_k``, ``draft``) is BatchEngine's: the verify
forward (B, k+1) writes through the block table, so growth maps blocks up
to pos + k (within the admission reservation); window rows past the
mapped region write into the null block, and no used chain entry attends
them. A draft model keeps its own dense cache. A T > 1 verify goes
through the gather path (the paged decode kernels serve T = 1 only), the
reference's cost cliff for --paged with --spec. The sampling controls
(filters, penalties, logit_bias, logprobs) are BatchEngine's too: the
prefill tail and the decode step return logits, and BatchEngine samples
them.

Llama only. One-query steps on the card run the paged decode kernels (K5,
or K6 for int8 pools); long prefill chunks the flash prefill kernel (K4).
"""

from __future__ import annotations

import math
import warnings
from typing import List, Optional

import numpy as np
import torch

from tpu_llm_torch.ops.paged_kv import (BlockAllocator, PagedKV, PrefixCache,
                                        paged_gqa_attention, paged_update_tokens,
                                        scale_pool_width, scale_rows_per_block)
from tpu_llm_torch.runtime import trace
from tpu_llm_torch.runtime.batching import BatchEngine, Request, _Slot, to_device
from tpu_llm_torch.runtime.engine import _next_bucket

__all__ = ["PagedEngine", "Request"]


def _paged_update_fn(kc: PagedKV, vc, k, v, offset):
    """forward()'s cache-write hook: kc carries both pools (vc is None)."""
    return paged_update_tokens(kc, k, v, offset), None


def _paged_attn_fn(q, ka: PagedKV, va, positions, offset):
    return paged_gqa_attention(q, ka, positions, offset=offset)


class PagedEngine(BatchEngine):
    """Continuous batching over a paged KV cache with prefix caching; the
    public surface of BatchEngine (submit / step / run / cancel / reset)."""

    def __init__(self, params, cfg, batch: int = 8, n_blocks: int = 256,
                 block_size: int = 16, max_seq: Optional[int] = None,
                 eos_id: int = 2, bos_id: int = 1, cache_dtype=torch.float32,
                 prefix_caching: bool = True, prefill_chunk: Optional[int] = 512,
                 speculative_k: int = 0, draft=None, device="cuda"):
        quantized = cache_dtype in ("int8", torch.int8)
        if quantized and block_size < 32:
            # the reference pads int8 pools to 32-row tiles; the port keeps
            # its shapes so pools and outputs compare with it
            new_blocks = max(1, n_blocks * block_size // 32)
            warnings.warn(
                f"int8 pools: block_size {block_size} padded to 32-row tiles "
                f"anyway; using block_size=32, n_blocks {n_blocks}->{new_blocks} "
                f"(same memory budget)", stacklevel=2)
            block_size, n_blocks = 32, new_blocks
        self.params = params
        self.cfg = cfg
        self.batch = batch
        self.block_size = block_size
        self.n_layers = len(params["layers"])
        self.max_blocks = ((max_seq or cfg.seq_len) + block_size - 1) // block_size
        self.max_seq = self.max_blocks * block_size
        self.eos_id = eos_id
        self.bos_id = bos_id
        self._vocab = cfg.vocab_size
        self.device = torch.device(device)
        self.quantized = quantized
        self._n_blocks = n_blocks
        self._pool_dtype = torch.int8 if quantized else cache_dtype
        self.prefill_chunk = prefill_chunk
        self._prefix_caching = prefix_caching
        self._next_rid = 0
        # tensor parallelism (parallel/serving.shard_engine): the model
        # group's all-reduce and the classifier's vocab gather
        self._reduce = self._gather = None
        self.state = self._fresh_state()
        self._init_spec(speculative_k, draft, cfg.vocab_size)
        self._reset_common()
        self._reset_blocks()

    def _fresh_state(self):
        kvd, L, dev = self.cfg.kv_dim, self.n_layers, self.device
        pool = lambda: torch.zeros((self._n_blocks, self.block_size, kvd),  # noqa: E731
                                   dtype=self._pool_dtype, device=dev)
        scales = lambda: [torch.zeros(  # noqa: E731
            (self._n_blocks * scale_rows_per_block(self.cfg.n_kv_heads),
             scale_pool_width(self.block_size)), dtype=torch.float32, device=dev)
            for _ in range(L)] if self.quantized else None
        return {
            "k": [pool() for _ in range(L)],
            "v": [pool() for _ in range(L)],
            "ks": scales(),
            "vs": scales(),
            "table": torch.zeros((self.batch, self.max_blocks), dtype=torch.int32,
                                 device=dev),
            "lengths": torch.zeros((self.batch,), dtype=torch.int32, device=dev),
        }

    def _reset_blocks(self):
        self.allocator = BlockAllocator(self._n_blocks)
        self.prefix = PrefixCache(self.allocator) if self._prefix_caching else None
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.batch)]
        self._slot_reserved: List[int] = [0] * self.batch
        # last position whose KV must ever be real, per slot: the final
        # sampled token is never forwarded, so real writes stop at
        # n_in + max_new - 2 (growth clamps here)
        self._slot_span: List[int] = [0] * self.batch

    def reset(self) -> None:
        """Crash recovery: fresh pools, allocator, prefix cache and slot
        metadata."""
        self._reset_common()
        self._reset_blocks()
        self.state = self._fresh_state()

    # -- device work ------------------------------------------------------

    def _layer_caches(self, table, lengths):
        st, q = self.state, self.quantized
        return {"k": [PagedKV(st["k"][i], st["v"][i], table, lengths,
                              st["ks"][i] if q else None, st["vs"][i] if q else None)
                      for i in range(self.n_layers)],
                "v": [None] * self.n_layers}

    def _forward(self, tokens, table, lengths, offset):
        from tpu_llm_torch.models import llama as M

        hidden, _ = M.forward(self.params, self.cfg, tokens,
                              self._layer_caches(table, lengths), offset,
                              update_fn=_paged_update_fn, attn_fn=_paged_attn_fn,
                              reduce_fn=self._reduce)
        return hidden

    def _logits(self, hidden):
        from tpu_llm_torch.models import llama as M

        return M.lm_head(self.params, self.cfg, hidden, gather_fn=self._gather)

    def _slot_rows(self, idx: int):
        return (self.state["table"][idx:idx + 1], self.state["lengths"][idx:idx + 1])

    def _prefill_part(self, idx: int, toks, pos0: int) -> None:
        """A non-final chunk of a chunked prefill: forward and cache
        writes only."""
        self._forward(toks, *self._slot_rows(idx), pos0)

    def _prefill_tail(self, idx: int, toks, pos0: int, last_idx: int) -> torch.Tensor:
        """The prompt tail (1, Tpad) at positions [pos0, pos0 + Tpad)
        through the slot's table row; shared prefix blocks are already
        mapped. Returns the last prompt position's logits (1, V)."""
        hidden = self._forward(toks, *self._slot_rows(idx), pos0)
        return self._logits(hidden[:, last_idx:last_idx + 1])[:, 0, :]

    def _decode(self, offsets) -> torch.Tensor:
        hidden = self._forward(self._token_dev[:, None], self.state["table"],
                               self.state["lengths"], offsets)
        return self._logits(hidden)[:, 0, :]

    def _verify_logits(self, tokens, offsets) -> torch.Tensor:
        hidden = self._forward(tokens, self.state["table"], self.state["lengths"],
                               offsets)
        return self._logits(hidden)

    def _set_slot_meta(self, idx: int, blocks: List[int], length: int) -> None:
        """Reset one slot's whole table row (stale entries of the previous
        occupant must not stay mapped) and its valid length."""
        row = np.zeros((self.max_blocks,), np.int32)
        row[:len(blocks)] = blocks
        self.state["table"][idx] = to_device(row, torch.int32, self.device)
        self.state["lengths"][idx] = length

    # -- scheduling -------------------------------------------------------

    def _admit(self):
        for idx, slot in enumerate(self.slots):
            if not (slot.free and self._queue):
                continue
            req = self._queue[0]
            with trace.span("prefill", req.rid) as sp:
                bos = [self.bos_id] if self.bos_id >= 0 else []
                input_ids = bos + req.prompt
                n_in = len(input_ids)
                bs = self.block_size
                # hash the prompt's block chain once (match and insert share it)
                digs = PrefixCache.digests(input_ids, bs) if self.prefix is not None else []
                shared = (self.prefix.match(input_ids, bs, digests=digs)
                          if self.prefix is not None else [])
                n_shared = len(shared) * bs
                n_tail_blocks = math.ceil((n_in - n_shared) / bs)
                # all-or-nothing: tail blocks now + a reservation for the
                # worst-case growth (last real write at n_in + max_new - 2)
                span = n_in + req.max_new - 2
                growth = span // bs + 1 - len(shared) - n_tail_blocks
                try:
                    owned = self.allocator.alloc(n_tail_blocks)
                    try:
                        self.allocator.reserve(growth)
                    except MemoryError:
                        self.allocator.release(owned)
                        raise
                except MemoryError:
                    # pool pressure: give the refs back and wait for running
                    # requests to free their blocks
                    for b in shared:
                        self.allocator.decref(b)
                    sp.drop()
                    if self.n_active == 0:
                        raise MemoryError(
                            f"request needs {n_tail_blocks}+{growth} blocks "
                            f"(+{len(shared)} shared) but the pool can never serve "
                            f"it (free={self.allocator.n_free})")
                    return
                trace.add("queued", req.submitted, sp.t0, req.rid)
                self._slot_reserved[idx] = growth
                self._slot_span[idx] = span
                self._queue.pop(0)
                slot.req = req
                slot.generator = self._new_generator(req.seed)
                blocks = shared + owned
                self._slot_blocks[idx] = blocks
                self._set_slot_meta(idx, blocks, n_shared)

                tail, off = input_ids[n_shared:], n_shared
                ck = self.prefill_chunk
                while ck is not None and len(tail) > ck:
                    self._prefill_part(idx, to_device([tail[:ck]], torch.long, self.device),
                                       off)
                    tail, off = tail[ck:], off + ck
                toks = np.zeros((1, min(_next_bucket(len(tail)), self.max_seq)), np.int64)
                toks[0, :len(tail)] = tail
                logits = self._prefill_tail(idx, to_device(toks, torch.long, self.device),
                                            off, len(tail) - 1)
                if self._draft is not None:      # the draft prefills the whole prompt
                    dtoks = np.zeros((1, min(_next_bucket(n_in), self.max_seq)), np.int64)
                    dtoks[0, :n_in] = input_ids
                    self._draft_prefill(idx, to_device(dtoks, torch.long, self.device), n_in - 1)
                if self.prefix is not None:
                    self.prefix.insert(input_ids, bs, blocks, digests=digs)
                self._seat(idx, slot, logits, input_ids)

    def _pre_dispatch(self, live) -> None:
        """Map a fresh block for every slot whose next write crosses into
        unmapped territory (growth within the admission reservation). With
        speculation the mapped rows reach every position a draft could be
        accepted at, pos + k, clamped to the reserved span: window rows
        past it are rejected by construction and write into the null
        block."""
        rows, cols, vals = [], [], []
        for idx, _ in live:
            slot = self.slots[idx]
            blocks = self._slot_blocks[idx]
            reach = min(slot.pos + self.spec_k, self._slot_span[idx])
            while reach // self.block_size >= len(blocks):
                (bid,) = self.allocator.alloc(1, reserved=True)
                self._slot_reserved[idx] -= 1
                rows.append(idx)
                cols.append(len(blocks))
                vals.append(bid)
                blocks.append(bid)
        if rows:
            dev = self.device
            self.state["table"][to_device(rows, torch.long, dev),
                                to_device(cols, torch.long, dev)] = \
                to_device(vals, torch.int32, dev)

    def _record(self, slot: _Slot, tok: int, lp=None, top=None):
        req = slot.req
        super()._record(slot, tok, lp, top)
        if req is not None and req.done and slot.req is None:
            idx = next(i for i, s in enumerate(self.slots) if s is slot)
            self._release_slot(idx, req)

    def cancel(self, req) -> bool:
        """Retire a paged request now, releasing its blocks (the KV written
        so far goes into the prefix cache: it is valid for a cut-short
        generation too)."""
        for idx, slot in enumerate(self.slots):
            if slot.req is req and not req.done:
                req.done = True
                slot.req = None
                self._release_slot(idx, req)
                return True
        return super().cancel(req)

    def _release_slot(self, idx: int, req) -> None:
        if self.prefix is not None:
            # register the completed sequence's full blocks (a follow-up
            # that extends the conversation reuses them); the final sampled
            # token was never forwarded, so its KV is absent
            bos = [self.bos_id] if self.bos_id >= 0 else []
            seq = bos + req.prompt + req.tokens
            self.prefix.insert(seq[:-1], self.block_size, self._slot_blocks[idx])
        self.allocator.release(self._slot_blocks[idx])
        self._slot_blocks[idx] = []
        self.allocator.unreserve(self._slot_reserved[idx])
        self._slot_reserved[idx] = 0
        # the dead slot keeps decoding garbage at offset 0 every step: point
        # its row at the null block so those writes cannot land in released
        # (possibly cached or reallocated) blocks
        self.state["table"][idx] = 0
        self.state["lengths"][idx] = 0

    # -- introspection ----------------------------------------------------

    @property
    def hbm_blocks_in_use(self) -> int:
        return len(self.allocator.refs)
