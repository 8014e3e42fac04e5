"""Continuous-batching request scheduler over the ServingEngine (counterpart
of ``repro.serving.scheduler``, on one device or a mesh).

* **FIFO admission with a token-budget test** — a waiting request is
  admitted when a slot is free AND its committed tokens (prompt + decode
  budget) fit the pool's ``token_budget``; a blocked head is never
  overtaken.
* **Prefill/decode interleaving** — each admission runs one batch-1
  prefill and writes the result into its slot; between admissions the
  whole pool advances one decode step.
* **Per-step retirement** — rows that emit EOS or exhaust their budget are
  retired and their slot freed that step.
* **Static shapes** — the decode step always runs at ``(max_batch, 1)``
  with a per-slot ``pos`` vector; inactive slots step on garbage that the
  next ``insert`` overwrites.

The engine's static ``generate`` stays the reference path:
``ContinuousScheduler`` produces identical tokens for the same requests.
``replay_static`` is the instrumented static-batching baseline.

``PagedScheduler`` is the paged tier on the same engine: KV lives in
fixed-size blocks (``serving.block_pool``) referenced through per-slot
block tables, a radix tree (``serving.prefix_tree``) shares full
prompt-prefix blocks across requests (a common system prompt prefills
once), and long prompts prefill in chunks interleaved with pool decode
steps, so a long prefill no longer stalls every decoder.  Admission
reserves free blocks (less the prefix-cache hit) instead of a whole-slot
token budget.  It too gives ``generate``'s tokens.

On a mesh every rank runs the same host loop over the sequence-sharded
pool, and its collectives deadlock unless admission, retirement and slot
choice agree on every rank.  Tokens agree (``engine.next_tokens`` is
the same on every rank); the clock does not, so each turn of the loop
broadcasts rank 0's clock reading (one call, ``core.dsp.broadcast``) and
every rank admits by it.  Block tables, ref counts and the prefix tree are
host state that every rank updates alike.  ``replan`` resizes the engine
and migrates the live pool.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import dsp
from repro_torch.serving.block_pool import BlockPool
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics
from repro_torch.serving.prefix_tree import PrefixTree


@dataclasses.dataclass
class _Active:
    """Host-side state of one live slot."""
    request: object
    slot: int
    tokens: List[int]
    eos_id: Optional[int]
    budget: int
    metrics: RequestMetrics
    last_token: int


class _HostLoop:
    """What both schedulers share: the engine, the clock (``clock``/
    ``sleep`` injectable for deterministic tests), rank 0's clock on a
    mesh, the live slots and one decode step's retirement."""

    def __init__(self, engine, max_batch: int, clock, sleep, *, what: str):
        if engine.sharder.dp_size > 1:
            raise ValueError(
                f"continuous batching serves with data=1: {what} "
                f"scattered per-request, the sequence dim carries the "
                f"parallelism (use more model-axis ranks instead)")
        self.engine = engine
        self.max_batch = max_batch
        self.metrics = EngineMetrics(max_batch)
        self._clock = clock
        self._sleep = sleep
        self._active: Dict[int, _Active] = {}
        self._t0: Optional[float] = None
        self.ticks = 0              # host-loop turns (one broadcast each)

    def _now(self) -> float:
        return self._clock() - self._t0

    def _shared_now(self) -> float:
        """Rank 0's clock reading on every rank of the mesh (one broadcast
        over its ``model`` group, which spans the mesh at data 1): what
        admission reads, so every rank admits alike.  The local clock off
        a mesh."""
        now = self._now()
        ctx = self.engine.sharder.ctx
        self.ticks += 1
        if ctx is None:
            return now
        t = torch.tensor([now], dtype=torch.float64,
                         device=self.engine.device)
        return float(dsp.broadcast(t, 0, ctx.sp_group))

    @staticmethod
    def _need(req) -> int:
        return len(req.prompt) + int(req.max_new_tokens)

    def _decode_step(self, caches):
        """One decode step of the whole pool at ``(max_batch, 1)`` on the
        live slots' last tokens: (the step's tokens on the host, caches)."""
        last = np.zeros((self.max_batch,), np.int64)
        for slot, st in self._active.items():
            last[slot] = st.last_token
        token = torch.as_tensor(last[:, None], device=self.engine.device)
        logits, caches = self.engine._decode(token, caches)
        return self.engine.next_tokens(logits).cpu().numpy(), caches

    def _retire(self, toks, stream, free) -> None:
        """Append the step's tokens ``toks`` to the live slots, retire the
        rows that emitted EOS or spent their budget (``free(slot)``), and
        record the step."""
        from repro_torch.serving.engine import RequestResult

        now = self._now()
        n_active = len(self._active)
        for slot in sorted(self._active):
            st = self._active[slot]
            t = int(toks[slot])
            st.tokens.append(t)
            st.last_token = t
            st.metrics.n_generated = len(st.tokens)
            self.pool.lengths[slot] += 1
            if stream is not None:
                stream(st.request, t)
            done_eos = st.eos_id is not None and t == st.eos_id
            done_budget = len(st.tokens) >= st.budget
            if done_eos or done_budget:
                st.metrics.finish_time = now
                st.metrics.finish_reason = "eos" if done_eos else "budget"
                st.request.result = RequestResult(
                    tokens=st.tokens, finish_reason=st.metrics.finish_reason,
                    metrics=st.metrics)
                free(slot)
                del self._active[slot]
        self.metrics.record_tokens(n_active, now)
        self.metrics.record_step(n_active, now)

    def _first_token(self, req, logits, rm, eos, stream) -> Optional[int]:
        """The prefill's greedy token: recorded and streamed; None when the
        request ends on it (EOS or a budget of one), its result then
        filled."""
        from repro_torch.serving.engine import RequestResult

        first = int(self.engine.next_tokens(logits)[0])
        rm.first_token_time = self._now()
        rm.n_generated = 1
        self.metrics.record_tokens(1, rm.first_token_time)
        if stream is not None:
            stream(req, first)
        done_eos = eos is not None and first == eos
        if not (done_eos or req.max_new_tokens == 1):
            return first
        rm.finish_time = rm.first_token_time
        rm.finish_reason = "eos" if done_eos else "budget"
        req.result = RequestResult(tokens=[first],
                                   finish_reason=rm.finish_reason, metrics=rm)
        return None


class ContinuousScheduler(_HostLoop):
    """Continuous-batching loop over ``engine`` with ``max_batch`` slots.

    ``clock``/``sleep`` are injectable for deterministic tests.  ``stream``
    (on ``run``) is a per-token callback ``stream(request, token)``, called
    for every generated token including the prefill's first.
    """

    def __init__(self, engine, max_batch: int = 8, *,
                 token_budget: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        super().__init__(engine, max_batch, clock, sleep,
                         what="the slot dim is")
        self.pool = KVPool(engine.cfg, max_batch, engine.max_len,
                           mesh=engine.mesh, plan=engine.plan,
                           token_budget=token_budget, device=engine.device)

    # -- main loop -------------------------------------------------------------

    def run(self, requests: List, *, stream=None, eos_id: Optional[int] = None,
            on_step=None) -> List:
        """Serve ``requests`` to completion; fills ``Request.result`` on
        each and returns the list.  ``Request.arrival_time`` is an offset in
        seconds from the start of the run; ``eos_id`` is the default EOS for
        requests that don't set their own.  ``on_step(self, step_index)`` is
        called after every decode step."""
        from repro_torch.serving.engine import RequestResult  # no cycle: lazy

        self._t0 = self._clock()
        self.metrics.start(0.0)
        # stable sort: same-arrival requests keep submission order (FIFO)
        waiting = collections.deque(
            sorted(requests, key=lambda r: r.arrival_time))
        step = 0
        while waiting or self._active:
            now = self._shared_now()
            self._admit(waiting, now, stream, eos_id)
            if self._active:
                self._step(stream)
                step += 1
                if on_step is not None:
                    on_step(self, step)
                if not self.engine.active:      # a rank ``replan`` dropped
                    return requests
            elif waiting:
                gap = waiting[0].arrival_time - now
                if gap > 0:
                    self._sleep(min(gap, 0.005))
                elif not self.pool.can_admit(self._need(waiting[0])):
                    raise RuntimeError(
                        f"deadlock: request needs "
                        f"{self._need(waiting[0])} tokens but the empty "
                        f"pool's budget is {self.pool.token_budget}")
        for r in requests:
            if not isinstance(r.result, RequestResult):
                raise RuntimeError(f"request {r.request_id} was not served")
        return requests

    # -- admission -------------------------------------------------------------

    def _admit(self, waiting, now: float, stream, default_eos) -> None:
        while waiting:
            req = waiting[0]
            if req.arrival_time > now:
                return
            need = self._need(req)
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1 per request")
            if not self.pool.can_admit(need):   # raises if it can NEVER fit
                return                          # FIFO: wait for retirements
            waiting.popleft()
            self._prefill_into_slot(req, need, stream, default_eos)

    def _prefill_into_slot(self, req, need, stream, default_eos) -> None:
        rm = RequestMetrics(arrival_time=req.arrival_time)
        rm.admitted_time = self._now()
        self.metrics.requests.append(rm)
        slot = self.pool.alloc(need)
        self.metrics.record_admission()
        prompt = torch.as_tensor(req.prompt, device=self.engine.device)[None]
        logits, caches = self.engine._prefill(prompt)
        eos = req.eos_id if req.eos_id is not None else default_eos
        first = self._first_token(req, logits, rm, eos, stream)
        if first is None:
            self.pool.free(slot)
            return
        self.pool.insert(slot, caches, int(prompt.shape[1]))
        self._active[slot] = _Active(request=req, slot=slot, tokens=[first],
                                     eos_id=eos, budget=req.max_new_tokens,
                                     metrics=rm, last_token=first)

    # -- one decode step ---------------------------------------------------------

    def _step(self, stream) -> None:
        toks, self.pool.caches = self._decode_step(self.pool.caches)
        self._retire(toks, stream, self.pool.free)

    # -- elastic resize -------------------------------------------------------

    def replan(self, n_devices: int):
        """Elastic resize with slots live, between decode steps (e.g. from
        ``run``'s ``on_step``): the engine re-plans onto the first
        ``n_devices`` ranks (``ServingEngine.replan``), then the pool
        migrates every leaf onto the new mesh (``KVPool.migrate``) and is
        asserted on it.  Ranks past ``n_devices`` take part in both moves
        and leave ``run``."""
        self.engine.replan(n_devices)
        self.pool.migrate(self.engine.mesh, self.engine.plan,
                          leaving=not self.engine.active)
        if self.engine.active:
            self.pool.assert_on_mesh()
        return self

    # -- pool compaction ----------------------------------------------------

    def compact(self) -> Dict[int, int]:
        """Pack live slots to the front of the pool and rewrite the
        scheduler's slot table with the {old_slot: new_slot} mapping.  Safe
        between decode steps, e.g. from ``run``'s ``on_step`` hook."""
        mapping = self.pool.compact()
        self._active = {mapping[slot]: st
                        for slot, st in self._active.items()}
        for slot, st in self._active.items():
            st.slot = slot
        return mapping


# ---------------------------------------------------------------------------
# Paged tier: block pool + radix prefix sharing + chunked prefill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _PrefillState:
    """A request whose prompt is still streaming into the block pool."""
    request: object
    slot: int
    prompt: np.ndarray
    done: int                     # tokens already resident (prefix + chunks)
    eos_id: Optional[int]
    metrics: RequestMetrics


class PagedScheduler(_HostLoop):
    """Continuous batching over the paged ``BlockPool`` (JAX's
    ``PagedScheduler``).

    The slot scheduler's loop discipline (static decode shapes, per-step
    retirement, FIFO admission, injectable clock, rank 0's clock on a
    mesh), with three upgrades:

    * **paged KV**: admission reserves ``ceil(need / block_size)`` blocks;
      the decode step reads and writes through per-slot block tables.
    * **radix prefix sharing**: ``prefix_cache=True`` keeps a
      ``PrefixTree`` over served prompts: matched full blocks are
      referenced (ref-counted, copy-on-write by construction) instead of
      prefilled again, and only the missed suffix reserves fresh blocks.
    * **chunked prefill**: ``prefill_chunk=N`` splits the uncached prompt
      suffix into N-token slices; each loop turn runs one slice and then
      one pool decode step, so live decoders advance during long
      prefills (``None``: one slice a prompt).  On one device a slice of
      more than one token goes through K1.
    """

    def __init__(self, engine, max_batch: int = 8, *,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        super().__init__(engine, max_batch, clock, sleep,
                         what="blocks are")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.pool = BlockPool(engine.cfg, max_batch, engine.max_len,
                              block_size=block_size, n_blocks=n_blocks,
                              mesh=engine.mesh, plan=engine.plan,
                              device=engine.device)
        self.tree = PrefixTree(block_size) if prefix_cache else None
        self.prefill_chunk = prefill_chunk
        self._prefilling: "collections.deque[_PrefillState]" = (
            collections.deque())

    # -- main loop -----------------------------------------------------------

    def run(self, requests: List, *, stream=None,
            eos_id: Optional[int] = None, on_step=None) -> List:
        """Serve ``requests`` to completion (``ContinuousScheduler.run``'s
        contract).  Each loop turn advances at most one prefill chunk and
        then the whole decode pool one step."""
        from repro_torch.serving.engine import RequestResult  # no cycle: lazy

        self._t0 = self._clock()
        self.metrics.start(0.0)
        waiting = collections.deque(
            sorted(requests, key=lambda r: r.arrival_time))
        step = 0
        while waiting or self._prefilling or self._active:
            now = self._shared_now()
            self._admit(waiting, now, eos_id)
            busy = False
            if self._prefilling:
                self._chunk_step(stream)
                busy = True
            if self._active:
                self._step(stream)
                step += 1
                if on_step is not None:
                    on_step(self, step)
                if not self.engine.active:      # a rank ``replan`` dropped
                    return requests
                busy = True
            if busy or not waiting:
                continue
            gap = waiting[0].arrival_time - now
            if gap > 0:
                self._sleep(min(gap, 0.005))
            elif not self._can_admit_head(waiting[0]):
                raise RuntimeError(
                    f"deadlock: request needs "
                    f"{self.pool.blocks_for(self._need(waiting[0]))} blocks "
                    f"but the idle pool has {self.pool.free_blocks} free "
                    f"(+{len(self.tree) if self.tree else 0} cached)")
            else:
                # feasible but not admitted this turn (the next turn's
                # _admit reclaims and takes it): a cool spin, not a hot one
                self._sleep(0.0005)
        for r in requests:
            if not isinstance(r.result, RequestResult):
                raise RuntimeError(f"request {r.request_id} was not served")
        return requests

    # -- admission -----------------------------------------------------------

    def _match_prefix(self, prompt: np.ndarray, *, peek: bool = False):
        """Prefix-tree hit for ``prompt``, trimmed so at least the last
        prompt token is always recomputed (its logits seed the first
        generated token).  Returns (shared blocks, tokens they cover).
        ``peek`` walks the tree read-only (no LRU tick, no hit/miss
        counters): the feasibility probe's mode."""
        if self.tree is None:
            return [], 0
        shared, covered = self.tree.match(prompt, peek=peek)
        while shared and covered > len(prompt) - 1:
            shared.pop()
            covered -= self.pool.block_size
        return shared, covered

    def _reclaim(self, n_short: int) -> None:
        """Evict cold prefix-tree leaves until ``n_short`` blocks are free
        (or no evictable leaf remains).  Only blocks the tree alone holds
        qualify: evicting a block a live request still reads frees
        nothing.  (The admitting request already holds reader refs on its
        own matched blocks, so they never qualify.)"""
        while self.tree is not None and self.pool.free_blocks < n_short:
            evicted = self.tree.evict(
                n_short - self.pool.free_blocks,
                evictable=lambda b: self.pool.ref[b] == 1)
            if not evicted:
                break
            self.pool.decref(evicted)

    def _can_admit_head(self, req) -> bool:
        """Idle-pool feasibility probe behind the deadlock check: could the
        head request be admitted once every reclaimable cached block is
        evicted?  The request's own matched prefix is not counted:
        ``_admit`` takes reader refs on it before reclaiming, so
        ``_reclaim`` never frees those blocks.  The probe peeks the tree,
        so a stuck head neither refreshes its prefix's LRU recency nor
        moves the hit/miss counters."""
        shared, _ = self._match_prefix(_host(req.prompt), peek=True)
        fresh = self.pool.blocks_for(self._need(req)) - len(shared)
        reclaimable = (max(0, len(self.tree) - len(shared))
                       if self.tree is not None else 0)
        return (self.pool.n_free_slots > 0
                and self.pool.free_blocks + reclaimable >= fresh)

    def _admit(self, waiting, now: float, default_eos) -> None:
        while waiting:
            req = waiting[0]
            if req.arrival_time > now:
                return
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1 per request")
            prompt = _host(req.prompt)
            n_total = self.pool.blocks_for(self._need(req))
            if n_total > self.pool.blocks_per_slot:
                raise ValueError(
                    f"request needs {n_total} blocks but slots map at most "
                    f"{self.pool.blocks_per_slot}")
            shared, covered = self._match_prefix(prompt)
            fresh_n = n_total - len(shared)
            # reader refs on the shared blocks first: a reclaim may drop
            # the tree's share, and the blocks must survive it
            self.pool.incref(shared)
            if not self.pool.can_admit(fresh_n):
                self._reclaim(fresh_n)
            if not self.pool.can_admit(fresh_n):
                self.pool.decref(shared)
                return                              # FIFO: wait, no overtake
            waiting.popleft()
            rm = RequestMetrics(arrival_time=req.arrival_time)
            rm.admitted_time = self._now()
            self.metrics.requests.append(rm)
            self.metrics.record_admission()
            self.metrics.record_prefix(covered, len(prompt))
            fresh = self.pool.alloc_blocks(fresh_n)
            slot = self.pool.bind(shared + fresh, covered)
            self.metrics.record_blocks(self.pool.blocks_in_use,
                                       self.pool.free_blocks)
            eos = req.eos_id if req.eos_id is not None else default_eos
            self._prefilling.append(_PrefillState(
                request=req, slot=slot, prompt=prompt, done=covered,
                eos_id=eos, metrics=rm))

    # -- one prefill chunk -----------------------------------------------------

    def _chunk_step(self, stream) -> None:
        """Push one prompt slice of the oldest prefilling request through
        the engine's chunk cell; on the last slice, take the first token
        and promote the request to the decode pool (registering its full
        prompt blocks in the prefix tree)."""
        pf = self._prefilling[0]
        plen = len(pf.prompt)
        width = self.prefill_chunk or (plen - pf.done)
        end = min(pf.done + width, plen)
        tokens = torch.as_tensor(pf.prompt[None, pf.done:end],
                                 device=self.engine.device)
        logits, self.pool.caches = self.engine._chunk(
            tokens, self.pool.caches, pf.slot, pf.done)
        self.pool.lengths[pf.slot] = end
        pf.done = end
        self.metrics.record_chunk()
        if end < plen:
            return
        self._prefilling.popleft()
        if self.tree is not None:
            n_full = plen // self.pool.block_size
            added = self.tree.insert(
                pf.prompt[:n_full * self.pool.block_size],
                self.pool.slot_blocks(pf.slot)[:n_full])
            self.pool.incref(added)       # the tree's ownership share
        first = self._first_token(pf.request, logits, pf.metrics, pf.eos_id,
                                  stream)
        if first is None:
            self.pool.free_slot(pf.slot)
            self.metrics.record_blocks(self.pool.blocks_in_use,
                                       self.pool.free_blocks)
            return
        self._active[pf.slot] = _Active(
            request=pf.request, slot=pf.slot, tokens=[first],
            eos_id=pf.eos_id, budget=pf.request.max_new_tokens,
            metrics=pf.metrics, last_token=first)

    # -- one decode step -------------------------------------------------------

    def _step(self, stream) -> None:
        toks, caches = self._decode_step(self.pool.caches)
        # the step advanced every row's pos and wrote one garbage K/V token
        # for mid-prefill slots: roll their pos back; the next chunk
        # rewrites that position with the prompt's K/V (always a private
        # block: shared blocks end below ``done``)
        for pf in self._prefilling:
            caches["pos"][pf.slot] = pf.done
        self.pool.caches = caches
        self._retire(toks, stream, self.pool.free_slot)
        self.metrics.record_blocks(self.pool.blocks_in_use,
                                   self.pool.free_blocks)

    # -- elastic resize --------------------------------------------------------

    def replan(self, n_devices: int):
        """Elastic resize, the slot scheduler's contract: the engine
        re-plans onto the first ``n_devices`` ranks, the block pool moves
        its leaves onto the new mesh (``BlockPool.migrate``) and is
        asserted on it.  Block tables, ref counts and the prefix tree are
        host state: nothing of them moves.  Ranks past ``n_devices`` take
        part in both moves and leave ``run``."""
        self.engine.replan(n_devices)
        self.pool.migrate(self.engine.mesh, self.engine.plan,
                          leaving=not self.engine.active)
        if self.engine.active:
            self.pool.assert_on_mesh()
        return self


def _host(prompt) -> np.ndarray:
    """A prompt's token ids on the host (the prefix tree's keys)."""
    return torch.as_tensor(prompt).cpu().numpy()


# ---------------------------------------------------------------------------
# Static-batching baseline (instrumented)
# ---------------------------------------------------------------------------

def replay_static(engine, requests: List, *, max_batch: int,
                  eos_id: Optional[int] = None, pad_id: int = 0,
                  clock: Callable[[], float] = time.monotonic,
                  sleep: Callable[[float], None] = time.sleep):
    """Replay an arrival trace through classic static batching: FIFO chunks
    of ``max_batch``; each chunk waits for all its members to arrive, then
    prefills together and decodes in lockstep until its slowest row
    finishes.  Returns the filled requests and an ``EngineMetrics``.

    Prompt lengths within a chunk are LEFT-padded to the chunk's max with
    ``pad_id``; a padded row's tokens are representative, not the reference
    decode, and the row is flagged ``RequestMetrics.padded``.  Equal-length
    chunks are exact against ``generate``."""
    from repro_torch.serving.engine import RequestResult

    metrics = EngineMetrics(max_batch)
    for r in requests:                   # same capacity contract as the pool
        need = len(r.prompt) + int(r.max_new_tokens)
        if need > engine.max_len:
            raise ValueError(f"request needs {need} tokens but the engine "
                             f"serves max_len={engine.max_len}")
    t0 = clock()
    metrics.start(0.0)
    order = sorted(requests, key=lambda r: r.arrival_time)
    for i in range(0, len(order), max_batch):
        chunk = order[i:i + max_batch]
        width = max(len(r.prompt) for r in chunk)
        need = width + max(int(r.max_new_tokens) for r in chunk)
        if need > engine.max_len:        # padding widens short rows
            raise ValueError(f"padded chunk needs {need} tokens but the "
                             f"engine serves max_len={engine.max_len}")
        while clock() - t0 < max(r.arrival_time for r in chunk):
            sleep(0.0005)
        rms = []
        for r in chunk:
            rm = RequestMetrics(arrival_time=r.arrival_time)
            rm.admitted_time = clock() - t0
            rm.padded = len(r.prompt) < width
            metrics.requests.append(rm)
            metrics.slots_allocated += 1     # one batch row per request...
            rms.append(rm)
        metrics.prefills += 1                # ...but ONE prefill per chunk
        prompts = torch.stack([
            F.pad(torch.as_tensor(r.prompt, device=engine.device),
                  (width - len(r.prompt), 0), value=pad_id)
            for r in chunk])
        logits, caches = engine._prefill(prompts)
        token = engine.next_tokens(logits)
        now = clock() - t0
        toks = [[int(t)] for t in token.cpu().numpy()]
        done = np.zeros((len(chunk),), bool)
        for b, (r, rm) in enumerate(zip(chunk, rms)):
            rm.first_token_time = now
            rm.n_generated = 1
            eos = r.eos_id if r.eos_id is not None else eos_id
            done[b] = (eos is not None and toks[b][0] == eos
                       ) or r.max_new_tokens == 1
        metrics.record_tokens(len(chunk), now)
        steps = max(r.max_new_tokens for r in chunk)
        for _ in range(1, steps):
            if done.all():
                break
            n_active = int((~done).sum())
            logits, caches = engine._decode(token[:, None], caches)
            token = engine.next_tokens(logits)
            host = token.cpu().numpy()
            now = clock() - t0
            emitted = 0
            for b, (r, rm) in enumerate(zip(chunk, rms)):
                if done[b]:
                    continue                    # lockstep: row just idles
                toks[b].append(int(host[b]))
                rm.n_generated = len(toks[b])
                emitted += 1
                eos = r.eos_id if r.eos_id is not None else eos_id
                if ((eos is not None and toks[b][-1] == eos)
                        or len(toks[b]) >= r.max_new_tokens):
                    done[b] = True
                    rm.finish_time = now        # row done; the CHUNK drags on
                    rm.finish_reason = ("eos" if toks[b][-1] == eos
                                        else "budget")
            metrics.record_tokens(emitted, now)
            metrics.record_step(n_active, now)
        for b, (r, rm) in enumerate(zip(chunk, rms)):
            if rm.finish_time is None:          # budget-1 / prefill-eos rows
                rm.finish_time = rm.first_token_time
                eos = r.eos_id if r.eos_id is not None else eos_id
                rm.finish_reason = ("eos" if eos is not None
                                    and toks[b][-1] == eos else "budget")
            r.result = RequestResult(tokens=toks[b],
                                     finish_reason=rm.finish_reason,
                                     metrics=rm)
    return requests, metrics
