"""Serving subsystem: engine + continuous-batching scheduler, on one device
or sharded under DSP on a ``("data", "model")`` process mesh.

* ``engine``    — ``ServingEngine``: the (plan, schedule, sharder) triple,
  prefill/decode steps, static-batch ``generate`` (the reference path),
  ``serve``, ``replan``.
* ``kv_pool``   — ``KVPool``: ``max_batch`` decode slots carved from the
  (sequence-sharded) cache; alloc/free/insert/compact/migrate.
* ``scheduler`` — ``ContinuousScheduler`` (one host loop on every rank,
  rank 0's clock broadcast) and ``replay_static``.
* ``metrics``   — TTFT/TPOT/queue-wait per request, throughput, occupancy.
"""
from repro_torch.serving.engine import Request, RequestResult, ServingEngine
from repro_torch.serving.kv_pool import KVPool, PoolExhausted
from repro_torch.serving.metrics import EngineMetrics, RequestMetrics
from repro_torch.serving.scheduler import ContinuousScheduler, replay_static

__all__ = [
    "Request", "RequestResult", "ServingEngine", "KVPool", "PoolExhausted",
    "EngineMetrics", "RequestMetrics", "ContinuousScheduler", "replay_static",
]
