"""Megatron-SP baseline over ``torch.distributed`` (counterpart of
``repro.core.megatron_sp``; Korthikanti et al.).

Sequence-parallel outside the blocks, tensor-parallel inside: each block
is entered with an all-gather of the full sequence and left with a
reduce-scatter of the row-parallel output.  Per block that is 2
collectives x the full activation = 4M with attention and MLP; a
2D-transformer layer pair wraps two blocks, 8M (paper Table 3).  Both
collectives are differentiable: an all-gather's backward is a
reduce-scatter and the reverse (``core.dsp``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dsp


def block_bytes(global_bytes: float, n: int = 1) -> float:
    """Per-rank volume of one AG/RS-wrapped block, ``core.dsp
    .per_device_bytes("megatron", ...)`` (4M; a layer pair wraps both
    blocks, 8M)."""
    return dsp.per_device_bytes("megatron", global_bytes, n)


def block_seconds(topology, nbytes: float, dim: Optional[int] = None) -> float:
    """Topology-priced seconds of one AG/RS-wrapped block on the placement
    group of ``dim``: ``all_gather_seconds(M) + reduce_scatter_seconds(M)``
    with ``core.topology``'s alpha+beta models — the unit the strategy DP
    charges through ``Topology.embedded_seconds``."""
    axes = None if dim is None else topology.group(dim)
    return (topology.all_gather_seconds(nbytes, axes)
            + topology.reduce_scatter_seconds(nbytes, axes))


def allgather_seq(x: torch.Tensor, seq_dim: int, group) -> torch.Tensor:
    """Enter a tensor-parallel region: (B, S/n, C) -> (B, S, C), one
    all-gather (``core.dsp.gather``)."""
    return dsp.gather(x, seq_dim, group)


def reduce_scatter_seq(x: torch.Tensor, seq_dim: int, group) -> torch.Tensor:
    """Leave a tensor-parallel region: sum the ranks' partial row-parallel
    outputs and keep this rank's sequence shard, (B, S, C) -> (B, S/n, C),
    one reduce-scatter (``core.dsp.reduce_scatter``)."""
    return dsp.reduce_scatter(x, seq_dim, group)


def megatron_block(x: torch.Tensor, inner, seq_dim: int,
                   group) -> torch.Tensor:
    """Wrap ``inner`` (a TP-sharded attention or MLP returning a partial
    row-parallel output of the full sequence) with the AG/RS pair."""
    return reduce_scatter_seq(inner(allgather_seq(x, seq_dim, group)),
                              seq_dim, group)


__all__ = ["allgather_seq", "reduce_scatter_seq", "megatron_block",
           "block_bytes", "block_seconds"]
