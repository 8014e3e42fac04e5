"""Serving subsystem on one device: engine + continuous-batching scheduler.

* ``engine``    — ``ServingEngine``: prefill/decode steps, static-batch
  ``generate`` (the reference path), ``serve``.
* ``kv_pool``   — ``KVPool``: ``max_batch`` decode slots carved from the
  cache; alloc/free/insert/compact.
* ``scheduler`` — ``ContinuousScheduler`` and ``replay_static``.
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
