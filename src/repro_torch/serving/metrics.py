"""Serving metrics: per-request latency breakdown + engine-level counters
(a copy of ``repro.serving.metrics``; the port imports nothing of
``repro``).

Per request the scheduler records the classic serving triple —

* **queue wait**: arrival -> admission (a free slot passed the admission
  test),
* **TTFT** (time to first token): arrival -> the first generated token is
  on the host (prefill sits inside this),
* **TPOT** (time per output token): mean decode interval over the tokens
  AFTER the first — the steady-state streaming rate.

Engine-level, ``EngineMetrics`` aggregates throughput (generated tokens per
second of wall time), slot occupancy (mean fraction of the pool's slots
active per decode step), and allocation counters (slot reuse shows up as
``slots_allocated > max_batch``).  ``summary()``/``to_json()`` export one
flat dict, the JAX package's schema: one key set for the static, slot
and paged paths, the paged counters (prefill chunks, prefix-hit tokens,
block gauges) zero or None where no block pool runs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None for an empty list.
    Kept dependency-free so the metrics module imports without numpy."""
    if not values:
        return None
    xs = sorted(values)
    k = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[k])


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock milestones of one request (seconds on the scheduler's
    clock; ``arrival_time`` is the request's declared offset)."""

    arrival_time: float = 0.0
    admitted_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_generated: int = 0
    finish_reason: str = ""            # "eos" | "budget" | ""
    padded: bool = False               # static replay left-padded this row:
                                       # tokens are representative, NOT the
                                       # bit-exact generate() reference

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admitted_time is None:
            return None
        return self.admitted_time - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> Optional[float]:
        """Mean seconds per generated token after the first (None until a
        request has produced at least two tokens)."""
        if (self.finish_time is None or self.first_token_time is None
                or self.n_generated < 2):
            return None
        return ((self.finish_time - self.first_token_time)
                / (self.n_generated - 1))


class EngineMetrics:
    """Aggregates per-request metrics and engine counters; one instance per
    scheduler run (or per static replay, for apples-to-apples benches)."""

    def __init__(self, max_batch: int = 1):
        self.max_batch = max_batch
        self.requests: List[RequestMetrics] = []
        self.decode_steps = 0
        self.prefills = 0
        self.slots_allocated = 0
        self.tokens_generated = 0
        # paged serving (block pool + prefix tree + chunked prefill);
        # zero/None on the slot-based and static paths — ONE schema for
        # every arm so the bench JSON diffs cleanly
        self.prefill_chunk_steps = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.blocks_in_use: Optional[int] = None     # latest gauge
        self.blocks_free: Optional[int] = None
        self.peak_blocks_in_use = 0
        self._occupancy_sum = 0.0
        self._elapsed_accum = 0.0        # closed segments (scheduler reuse)
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        # free-form engine facts exported verbatim (topology/fabric pricing,
        # plan description, device count) — see launch/serve.py
        self.extra: Dict[str, Any] = {}

    # -- recording hooks -----------------------------------------------------

    def start(self, now: float) -> None:
        """Begin a timing segment.  A reused scheduler calls this once per
        ``run``; the previous segment's span is banked so ``elapsed`` (and
        throughput) cover busy time across runs, not tokens-from-every-run
        over the span of just the last one."""
        if self.start_time is not None and self.finish_time is not None:
            self._elapsed_accum += self.finish_time - self.start_time
        self.start_time = now
        self.finish_time = now

    def record_admission(self) -> None:
        self.slots_allocated += 1
        self.prefills += 1

    def record_step(self, n_active: int, now: float) -> None:
        self.decode_steps += 1
        self._occupancy_sum += n_active / max(self.max_batch, 1)
        self.finish_time = now

    def record_tokens(self, n: int, now: float) -> None:
        self.tokens_generated += n
        self.finish_time = now

    def record_chunk(self) -> None:
        """One chunked-prefill slice pushed through the decode cell."""
        self.prefill_chunk_steps += 1

    def record_prefix(self, hit_tokens: int, prompt_tokens: int) -> None:
        """One admission's prefix-cache outcome: ``hit_tokens`` of the
        request's ``prompt_tokens`` were served from shared blocks."""
        self.prefix_hit_tokens += hit_tokens
        self.prompt_tokens += prompt_tokens

    def record_blocks(self, in_use: int, free: int) -> None:
        """Block-pool occupancy gauge (latest value + running peak)."""
        self.blocks_in_use = in_use
        self.blocks_free = free
        self.peak_blocks_in_use = max(self.peak_blocks_in_use, in_use)

    # -- export --------------------------------------------------------------

    @property
    def elapsed(self) -> float:
        if self.start_time is None or self.finish_time is None:
            return self._elapsed_accum
        return self._elapsed_accum + self.finish_time - self.start_time

    def summary(self) -> Dict[str, Any]:
        ttfts = [r.ttft for r in self.requests if r.ttft is not None]
        tpots = [r.tpot for r in self.requests if r.tpot is not None]
        waits = [r.queue_wait for r in self.requests
                 if r.queue_wait is not None]
        elapsed = self.elapsed
        return {
            "n_requests": len(self.requests),
            "max_batch": self.max_batch,
            "tokens_generated": self.tokens_generated,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "slots_allocated": self.slots_allocated,
            "elapsed_s": elapsed,
            "throughput_tok_s": (self.tokens_generated / elapsed
                                 if elapsed > 0 else None),
            "slot_occupancy": (self._occupancy_sum / self.decode_steps
                               if self.decode_steps else None),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
            "tpot_p50_s": percentile(tpots, 50),
            "tpot_p99_s": percentile(tpots, 99),
            "queue_wait_p50_s": percentile(waits, 50),
            "queue_wait_p99_s": percentile(waits, 99),
            "prefill_chunk_steps": self.prefill_chunk_steps,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_hit_rate": (self.prefix_hit_tokens / self.prompt_tokens
                                if self.prompt_tokens else None),
            "blocks_in_use": self.blocks_in_use,
            "blocks_free": self.blocks_free,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "padded_rows": sum(1 for r in self.requests if r.padded),
            **self.extra,
        }

    def to_json(self, path: Optional[str] = None, **dump_kw) -> str:
        out = json.dumps(self.summary(), indent=2, sort_keys=True, **dump_kw)
        if path is not None:
            with open(path, "w") as f:
                f.write(out + "\n")
        return out
