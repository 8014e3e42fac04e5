"""Slot-based KV pool for continuous batching (counterpart of
``repro.serving.kv_pool``).

The pool is the decode cache (``models.lm.init_caches``) re-read as
``max_batch`` independent slots: every leaf is ``(periods, slots, ...)``,
KV ``(periods, slots, Hkv, max_len, Dh)`` and SSM ``conv``/``state``
``(periods, slots, d_conv - 1, d_xbc)``/``(periods, slots, H, P, S)``.
``alloc``/``free`` are host-side bookkeeping; ``insert``
copies one prefilled request into its slot row in place.  Shapes never
change: the pool is allocated once at ``(max_batch, max_len)``, and
``pos`` is a per-slot ``(max_batch,)`` vector, so each slot appends and
masks at its own length.

On a mesh (``mesh``, ``plan``) each rank holds its slice of every leaf by
``cache_pspecs``: the same block of the sequence for every slot, and its
heads of the SSM state.  Slots are symmetric across the ranks, so
admission and retirement need no communication; ``migrate`` moves the
live pool onto a resized mesh (``reshard``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import dsp
from repro_torch.core.layout import from_mesh
from repro_torch.models import lm as LM
from repro_torch.parallel.partition import (
    SLOT_DIM, ParallelPlan, assert_kv_cache_on_mesh, cache_pspecs, reshard)


class PoolExhausted(Exception):
    """Raised by ``alloc`` when no slot (or token budget) is available —
    the scheduler catches it and leaves the request queued."""


class KVPool:
    """``max_batch`` decode slots carved from one cache.

    ``token_budget`` caps the sum of committed tokens (prompt + decode
    budget) across live slots; it defaults to the pool's physical capacity
    ``max_batch * max_len``, i.e. no extra constraint.
    """

    def __init__(self, cfg, max_batch: int, max_len: int, *, mesh=None,
                 plan: Optional[ParallelPlan] = None,
                 token_budget: Optional[int] = None, device="cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.mesh = mesh
        self.ctx = from_mesh(mesh) if mesh is not None else None
        self.plan = plan or ParallelPlan(mode="none")
        self.token_budget = (token_budget if token_budget is not None
                             else max_batch * max_len)
        self.caches = LM.init_caches(cfg, max_batch, max_len,
                                     per_slot_pos=True, device=device,
                                     ctx=self.ctx, plan=self.plan)
        # host-side bookkeeping: free slots (LIFO keeps reuse visible in
        # tests), per-slot committed tokens + current lengths
        self._free: List[int] = list(range(max_batch - 1, -1, -1))
        self._committed = np.zeros((max_batch,), np.int64)
        self.lengths = np.zeros((max_batch,), np.int64)
        self.peak_committed = 0

    # -- placement -----------------------------------------------------------

    def migrate(self, mesh, plan: ParallelPlan, *, leaving: bool = False):
        """Elastic resize: move the pool, live slots included, onto
        ``mesh`` (None: one device) one leaf at a time (``reshard``): each
        KV leaf gathered whole over the old mesh and cut to the new block
        (M/4 to M/2 positions a rank from 4 ranks to 2), the SSM state
        likewise by head.  The slot bookkeeping is untouched: slots stay
        symmetric on the new mesh.  ``leaving``: this rank takes part in
        the gathers and keeps nothing."""
        old = cache_pspecs(self.caches, self.plan)
        ctx = from_mesh(mesh) if mesh is not None else None
        new = cache_pspecs(self.caches, plan) if ctx is not None else None
        caches, self.caches = self.caches, None
        self.caches = reshard(caches, old if self.ctx is not None else None,
                              self.ctx, new, ctx, leaving=leaving)
        self.mesh, self.ctx, self.plan = mesh, ctx, plan
        return self

    def assert_on_mesh(self) -> None:
        """The serving contract: every KV leaf sequence-sharded over the
        SP dim (``assert_kv_cache_on_mesh``; a no-op off a mesh)."""
        assert_kv_cache_on_mesh(self.caches["periods"], self.ctx, self.plan,
                                self.max_len)

    # -- admission / bookkeeping ----------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def committed_tokens(self) -> int:
        return int(self._committed.sum())

    def occupancy(self) -> float:
        return 1.0 - self.n_free / self.max_batch

    def active_slots(self) -> List[int]:
        free = set(self._free)
        return [s for s in range(self.max_batch) if s not in free]

    def can_admit(self, n_tokens: int) -> bool:
        """Admission test: a free slot exists, the request fits a slot, and
        its committed tokens fit the pool budget."""
        if n_tokens > self.max_len:
            raise ValueError(f"request needs {n_tokens} tokens but slots "
                             f"hold max_len={self.max_len}")
        return (self.n_free > 0
                and self.committed_tokens + n_tokens <= self.token_budget)

    def alloc(self, n_tokens: int) -> int:
        if not self.can_admit(n_tokens):
            raise PoolExhausted(
                f"no capacity: free={self.n_free}, committed="
                f"{self.committed_tokens}+{n_tokens} > {self.token_budget}")
        slot = self._free.pop()
        self._committed[slot] = n_tokens
        self.peak_committed = max(self.peak_committed, self.committed_tokens)
        return slot

    def free(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self._committed[slot] = 0
        self.lengths[slot] = 0
        self._free.append(slot)

    # -- device-side slot writes ----------------------------------------------

    def insert(self, slot: int, prefill_caches: Dict, length: int):
        """Copy one prefilled request (batch dim 1, KV widened to
        ``max_len`` — the engine's prefill does both) into ``slot`` in place
        and set its ``pos`` to ``length``."""
        LM.tree_map(lambda dst, src: dst[:, slot].copy_(src[:, 0]),
                    self.caches["periods"], prefill_caches["periods"])
        self.caches["pos"][slot] = length
        self.lengths[slot] = length
        return self.caches

    def compact(self) -> Dict[int, int]:
        """Pack live slots to the front of the pool (one gather along the
        slot dim per leaf) and renumber the free list.  Returns the
        {old_slot: new_slot} mapping for the scheduler to rewrite its slot
        table."""
        live = self.active_slots()
        perm = live + [s for s in range(self.max_batch) if s not in live]
        mapping = {old: new for new, old in enumerate(perm)}
        if all(mapping[s] == s for s in live):
            return {s: s for s in live}
        idx = torch.tensor(perm, device=self.caches["pos"].device)
        self.caches = {
            "pos": self.caches["pos"].index_select(0, idx),
            # as bytes: an fp8 cache takes the same gather
            "periods": LM.tree_map(
                lambda a: dsp.as_bytes(a).index_select(SLOT_DIM, idx).view(
                    a.dtype), self.caches["periods"])}
        self._committed = self._committed[perm]
        self.lengths = self.lengths[perm]
        self._free = list(range(self.max_batch - 1, len(live) - 1, -1))
        return {old: mapping[old] for old in live}
