"""Continuous-batching request scheduler over the ServingEngine (counterpart
of ``repro.serving.scheduler``, single device).

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
``replay_static`` is the instrumented static-batching baseline.  The
paged scheduler and elastic ``replan`` come with the planner.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics


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


class ContinuousScheduler:
    """Continuous-batching loop over ``engine`` with ``max_batch`` slots.

    ``clock``/``sleep`` are injectable for deterministic tests.  ``stream``
    (on ``run``) is a per-token callback ``stream(request, token)``, called
    for every generated token including the prefill's first.
    """

    def __init__(self, engine, max_batch: int = 8, *,
                 token_budget: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.engine = engine
        self.max_batch = max_batch
        self.pool = KVPool(engine.cfg, max_batch, engine.max_len,
                           token_budget=token_budget, device=engine.device)
        self.metrics = EngineMetrics(max_batch)
        self._clock = clock
        self._sleep = sleep
        self._active: Dict[int, _Active] = {}
        self._t0: Optional[float] = None

    def _now(self) -> float:
        return self._clock() - self._t0

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
            self._admit(waiting, stream, eos_id)
            if self._active:
                self._step(stream)
                step += 1
                if on_step is not None:
                    on_step(self, step)
            elif waiting:
                gap = waiting[0].arrival_time - self._now()
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

    @staticmethod
    def _need(req) -> int:
        return len(req.prompt) + int(req.max_new_tokens)

    # -- admission -------------------------------------------------------------

    def _admit(self, waiting, stream, default_eos) -> None:
        while waiting:
            req = waiting[0]
            if req.arrival_time > self._now():
                return
            need = self._need(req)
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1 per request")
            if not self.pool.can_admit(need):   # raises if it can NEVER fit
                return                          # FIFO: wait for retirements
            waiting.popleft()
            self._prefill_into_slot(req, need, stream, default_eos)

    def _prefill_into_slot(self, req, need, stream, default_eos) -> None:
        from repro_torch.serving.engine import RequestResult

        rm = RequestMetrics(arrival_time=req.arrival_time)
        rm.admitted_time = self._now()
        self.metrics.requests.append(rm)
        slot = self.pool.alloc(need)
        self.metrics.record_admission()
        prompt = torch.as_tensor(req.prompt, device=self.engine.device)[None]
        logits, caches = self.engine._prefill(prompt)
        first = int(torch.argmax(logits[0, -1]))
        rm.first_token_time = self._now()
        rm.n_generated = 1
        self.metrics.record_tokens(1, rm.first_token_time)
        if stream is not None:
            stream(req, first)
        eos = req.eos_id if req.eos_id is not None else default_eos
        if (eos is not None and first == eos) or req.max_new_tokens == 1:
            reason = "eos" if (eos is not None and first == eos) else "budget"
            rm.finish_time = rm.first_token_time
            rm.finish_reason = reason
            req.result = RequestResult(tokens=[first], finish_reason=reason,
                                       metrics=rm)
            self.pool.free(slot)
            return
        self.pool.insert(slot, caches, int(prompt.shape[1]))
        self._active[slot] = _Active(request=req, slot=slot, tokens=[first],
                                     eos_id=eos, budget=req.max_new_tokens,
                                     metrics=rm, last_token=first)

    # -- one decode step ---------------------------------------------------------

    def _step(self, stream) -> None:
        from repro_torch.serving.engine import RequestResult

        last = np.zeros((self.max_batch,), np.int64)
        for slot, st in self._active.items():
            last[slot] = st.last_token
        token = torch.as_tensor(last[:, None], device=self.engine.device)
        logits, caches = self.engine._decode(token, self.pool.caches)
        self.pool.caches = caches
        toks = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
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
                self.pool.free(slot)
                del self._active[slot]
        self.metrics.record_tokens(n_active, now)
        self.metrics.record_step(n_active, now)

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
        token = torch.argmax(logits[:, -1], dim=-1)
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
            token = torch.argmax(logits[:, -1], dim=-1)
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
