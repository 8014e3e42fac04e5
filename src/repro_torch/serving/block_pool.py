"""Paged KV pool for continuous batching: fixed-size blocks + block tables
(counterpart of ``repro.serving.block_pool``).

``KVPool`` carves the decode cache into ``max_batch`` whole-``max_len``
slots; this pool carves it into ``n_blocks`` fixed-size blocks instead,
leaf layout ``(periods, blocks, Hkv, block_size, Dh)``
(``lm.init_paged_caches``).  A per-slot block table ``(max_batch,
blocks_per_slot)`` maps each live request's positions onto physical
blocks; the decode step and the prefill chunks write and read through it
(``models.attention._paged``).

On a mesh the within-block sequence dim is split over ``model``
(``cache_pspecs(..., paged=True)``): rank r holds offsets [r·b/n,
(r+1)·b/n) of every block, so a block id names the same slice on every
rank.  The table is one whole int tensor, and alloc, free and share are
host-side ref-count bookkeeping with no collective at a block boundary.

Ref counting is what turns blocks into a prefix cache: a block's count is
(live readers) + (1 if the radix tree holds it); ``decref`` returns a block
to the free list only at zero.  Admission is by free blocks: a request
reserves ``ceil(need / block_size)`` minus what a prefix-tree hit already
covers.

Shapes never change: the pool is allocated once, and ``migrate`` moves the
same leaves onto a resized mesh (elastic replan) without touching a table
or a ref count.  The leaves are zeros, never uninitialised memory: a
masked column of the attention still multiplies v, and 0 x NaN is NaN.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.layout import from_mesh
from repro_torch.models import lm as LM
from repro_torch.parallel.partition import (
    ParallelPlan, assert_kv_cache_on_mesh, cache_pspecs, reshard)
from repro_torch.serving.kv_pool import PoolExhausted

GARBAGE_BLOCK = 0      # never allocated: freed/padded table entries point
                       # here, so inactive rows scribble on a dedicated sink


class BlockPool:
    """``n_blocks`` KV blocks of ``block_size`` tokens + per-slot tables.

    ``n_blocks`` defaults to full capacity (every slot can hold ``max_len``
    tokens) plus the reserved garbage block; pass a smaller count to model
    memory pressure: admission then waits on free blocks and the scheduler
    evicts cold prefix-tree entries.  ``table`` and ``pos`` are int
    tensors on ``device``; ref counts, free lists and slot lists stay on
    the host.
    """

    def __init__(self, cfg, max_batch: int, max_len: int, *,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 mesh=None, plan: Optional[ParallelPlan] = None,
                 device="cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be divisible by "
                             f"block_size {block_size}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        self.n_blocks = (n_blocks if n_blocks is not None
                         else 1 + max_batch * self.blocks_per_slot)
        if self.n_blocks < 2:
            raise ValueError("need at least one allocatable block beyond "
                             "the reserved garbage block")
        self.plan = plan or ParallelPlan(mode="none")
        self.mesh = mesh
        self.ctx = from_mesh(mesh) if mesh is not None else None
        self._check_split(self.ctx)
        self.caches = LM.init_paged_caches(
            cfg, max_batch, max_len, block_size, self.n_blocks,
            device=device, ctx=self.ctx, plan=self.plan)
        # host-side bookkeeping: per-block ref counts (0 = free), LIFO free
        # lists (reuse stays visible in tests), per-slot block lists
        self.ref = np.zeros((self.n_blocks,), np.int64)
        self.ref[GARBAGE_BLOCK] = 1          # pinned forever
        self._free_blocks: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._free_slots: List[int] = list(range(max_batch - 1, -1, -1))
        self._slot_blocks: Dict[int, List[int]] = {}
        self.lengths = np.zeros((max_batch,), np.int64)
        self.peak_blocks_in_use = 0

    def _check_split(self, ctx) -> None:
        sp = ctx.sp_size if ctx is not None else 1
        if sp > 1 and self.block_size % sp:
            raise ValueError(
                f"block_size {self.block_size} must be divisible by the SP "
                f"degree {sp} (blocks are sequence-sharded WITHIN)")

    # -- placement -----------------------------------------------------------

    def migrate(self, mesh, plan: ParallelPlan, *, leaving: bool = False):
        """Elastic resize: move the pool, live blocks included, onto
        ``mesh`` (None: one device) one leaf at a time (``reshard``): each
        KV leaf gathered whole over the old mesh and cut to the new
        within-block slices.  Tables and ref counts are untouched: block
        ids stay rank-symmetric on the resized mesh.  ``leaving``: this
        rank takes part in the gathers and keeps nothing."""
        ctx = from_mesh(mesh) if mesh is not None else None
        if not leaving:
            self._check_split(ctx)
        old = cache_pspecs(self.caches, self.plan, paged=True)
        new = (cache_pspecs(self.caches, plan, paged=True)
               if ctx is not None else None)
        caches, self.caches = self.caches, None
        self.caches = reshard(caches, old if self.ctx is not None else None,
                              self.ctx, new, ctx, leaving=leaving)
        self.mesh, self.ctx, self.plan = mesh, ctx, plan
        return self

    def assert_on_mesh(self) -> None:
        """The serving contract: every KV leaf split over the SP dim within
        each block, rank r holding offsets [r·b/n, (r+1)·b/n)
        (``assert_kv_cache_on_mesh`` at the block size; a no-op off a
        mesh)."""
        assert_kv_cache_on_mesh(self.caches["periods"], self.ctx, self.plan,
                                self.block_size)

    # -- block accounting -----------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - 1 - self.free_blocks

    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    def occupancy(self) -> float:
        return 1.0 - self.n_free_slots / self.max_batch

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_size)

    def can_admit(self, n_fresh_blocks: int) -> bool:
        """A slot is free and ``n_fresh_blocks`` new blocks are available
        (prefix-shared blocks don't count: they are already resident)."""
        if n_fresh_blocks > self.blocks_per_slot:
            raise ValueError(
                f"request needs {n_fresh_blocks} blocks but slots map at "
                f"most {self.blocks_per_slot} (max_len={self.max_len})")
        return (self.n_free_slots > 0
                and self.free_blocks >= n_fresh_blocks)

    def alloc_blocks(self, n: int) -> List[int]:
        if n > self.free_blocks:
            raise PoolExhausted(f"need {n} blocks, {self.free_blocks} free")
        blocks = [self._free_blocks.pop() for _ in range(n)]
        for b in blocks:
            self.ref[b] = 1
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return blocks

    def incref(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if self.ref[b] < 1:
                raise ValueError(f"incref on free block {b}")
            self.ref[b] += 1

    def decref(self, blocks: Sequence[int]) -> List[int]:
        """Drop one reference per block; blocks reaching zero return to the
        free list (returned for tests/metrics)."""
        freed = []
        for b in blocks:
            if b == GARBAGE_BLOCK:
                continue
            if self.ref[b] < 1:
                raise ValueError(f"decref on free block {b}")
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._free_blocks.append(b)
                freed.append(b)
        return freed

    # -- slot binding ---------------------------------------------------------

    def bind(self, slot_blocks: Sequence[int], start: int) -> int:
        """Claim a free slot, point its table row at ``slot_blocks``
        (prefix-shared first, then owned), and set its write position to
        ``start`` (the tokens the shared prefix already covers).  Writes
        one table row and one ``pos`` entry; the leaves are untouched."""
        if not self._free_slots:
            raise PoolExhausted("no free slot")
        if len(slot_blocks) > self.blocks_per_slot:
            raise ValueError(f"{len(slot_blocks)} blocks > blocks_per_slot "
                             f"{self.blocks_per_slot}")
        slot = self._free_slots.pop()
        self._slot_blocks[slot] = list(slot_blocks)
        row = np.full((self.blocks_per_slot,), GARBAGE_BLOCK, np.int64)
        row[:len(slot_blocks)] = slot_blocks
        self.caches["table"][slot] = torch.from_numpy(row)
        self.caches["pos"][slot] = start
        self.lengths[slot] = start
        return slot

    def free_slot(self, slot: int) -> List[int]:
        """Retire a slot: decref every block it referenced (shared prefix
        blocks survive while the tree or another reader holds them) and
        point its row at the garbage block, so the still-stepping decode
        lane scribbles harmlessly.  Returns the physically freed blocks."""
        if slot not in self._slot_blocks:
            raise ValueError(f"slot {slot} not bound")
        freed = self.decref(self._slot_blocks.pop(slot))
        self.caches["table"][slot] = GARBAGE_BLOCK
        self.lengths[slot] = 0
        self._free_slots.append(slot)
        return freed

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._slot_blocks[slot])

    def active_slots(self) -> List[int]:
        return sorted(self._slot_blocks)
