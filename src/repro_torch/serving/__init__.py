"""Serving subsystem: engine + continuous-batching scheduler, on one device
or sharded under DSP on a ``("data", "model")`` process mesh.

* ``engine``    — ``ServingEngine``: the (plan, schedule, sharder) triple,
  prefill/decode steps, static-batch ``generate`` (the reference path),
  ``serve``, ``replan``.
* ``kv_pool``   — ``KVPool``: ``max_batch`` decode slots carved from the
  (sequence-sharded) cache; alloc/free/insert/compact/migrate.
* ``block_pool`` — ``BlockPool``: the paged cache, fixed-size KV blocks
  (sequence-sharded within each block) with per-slot block tables and
  host-side ref counts; ``GARBAGE_BLOCK`` is the sink of idle rows.
* ``prefix_tree`` — ``PrefixTree``: a radix tree over prompt prefixes at
  block granularity (the prefix cache), host code only.
* ``scheduler`` — ``ContinuousScheduler`` and ``PagedScheduler`` (one
  host loop on every rank, rank 0's clock broadcast) and
  ``replay_static``.
* ``metrics``   — TTFT/TPOT/queue-wait per request, throughput, occupancy,
  the paged counters.
"""
from repro_torch.serving.block_pool import GARBAGE_BLOCK, BlockPool
from repro_torch.serving.engine import Request, RequestResult, ServingEngine
from repro_torch.serving.kv_pool import KVPool, PoolExhausted
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics
from repro_torch.serving.prefix_tree import PrefixTree
from repro_torch.serving.scheduler import (ContinuousScheduler,
                                           PagedScheduler, replay_static)

__all__ = [
    "Request", "RequestResult", "ServingEngine", "KVPool", "PoolExhausted",
    "BlockPool", "GARBAGE_BLOCK", "PrefixTree", "EngineMetrics",
    "RequestMetrics", "ContinuousScheduler", "PagedScheduler",
    "replay_static",
]
