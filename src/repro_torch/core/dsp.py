"""Dynamic Sequence Parallelism primitives over ``torch.distributed`` (the
explicit half of ``repro.core.dsp``; paper Table 2).

Each rank holds its local shard and the primitives issue the collective
directly, mirroring the paper's four-function API one-to-one:

* ``dynamic_switch`` — one tiled all-to-all (volume M/N per device),
  ``jax.lax.all_to_all(..., split_axis=tgt, concat_axis=cur, tiled=True)``
  tile for tile: chunk j of dim ``tgt`` goes to rank j, and the received
  chunks are concatenated along ``cur`` in rank order;
* ``gather`` — one all-gather along ``cur`` (volume M);
* ``split`` — a local slice (no communication);
* ``dsp_shard_batch`` — the paper's ``dsp_dataloader``.

``exchange`` is the variable-split all-to-all of MoE's dispatch under
expert parallelism (the switch from the token dim to the expert dim), and
with the splits reversed its combine.

Beside them, the collectives the embedded-SP baselines and the overlapped
switch are built from: ``reduce_scatter`` (Megatron-SP's block exit) and
``ppermute`` (``jax.lax.ppermute``: ring hops and the overlapped switch's
per-shard hops); and ``gather_param``, ``gather`` of a parameter shard
(ZeRO, ``parallel.partition.gather_params``), whose gradient is
reduce-scattered in float32.

Each is differentiable, with JAX's transpose as its backward: a switch's
is the reverse switch (one all-to-all), a gather's a reduce-scatter (and a
reduce-scatter's a gather), a permute's the inverse permute, a split's a
zero pad.  JAX's compiler path (``switch_constraint`` and friends) has no
PyTorch counterpart (``core.schedule``).

Every ``torch.distributed`` call the port issues goes through this module
and adds one to ``calls[kind]`` (kinds as XLA's HLO names them:
"all-to-all", "all-gather", "reduce-scatter", "all-reduce",
"collective-permute", and "broadcast", which JAX's single controller never
needs) and its bytes to ``volume[kind]``, so tests and
``chip_smoke.py`` pin the collective contract by reading them, as they
read the kernels' launch counters.  The bytes follow the convention of
JAX's ``analysis.roofline.parse_collectives``, so the port's sit beside
JAX's measured ones: an all-to-all, all-gather or permute counts its
result's bytes, a reduce-scatter its result's times the group size, an
all-reduce twice its result's.  A collective is issued whatever the group
size: at one rank it is still one call.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# kind -> number of torch.distributed calls issued since ``reset_calls``
calls: Dict[str, int] = {}
# kind -> bytes those calls moved per rank (``parse_collectives``' rule)
volume: Dict[str, int] = {}


def reset_calls() -> None:
    calls.clear()
    volume.clear()


def _issue(kind: str, fn, *tensors: torch.Tensor, group,
           result: Optional[torch.Tensor] = None, **kw):
    """Count one collective of ``kind`` with the bytes of its ``result``
    (the first tensor, fn's output, unless given), and issue
    ``fn(*tensors, **kw)`` over ``group``; returns ``fn``'s value (a work
    handle when ``async_op``)."""
    result = tensors[0] if result is None else result
    nbytes = result.numel() * result.element_size()
    if kind == "all-reduce":
        nbytes *= 2
    elif kind == "reduce-scatter":
        nbytes *= _group_size(group)
    calls[kind] = calls.get(kind, 0) + 1
    volume[kind] = volume.get(kind, 0) + nbytes
    return fn(*tensors, group=group, **kw)


def all_reduce(t: torch.Tensor, group=None,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` by ``op`` (a sum by default) over ``group`` (the whole
    world when None), in place."""
    _issue("all-reduce", dist.all_reduce, t, group=group, op=op)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank of ``group``, in place:
    one call, counted as "broadcast" with ``t``'s bytes."""
    _issue("broadcast", dist.broadcast, t, group=group,
           src=dist.get_global_rank(group, src))
    return t


def _group_size(group) -> int:
    return dist.get_world_size(group)


_FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives that only move data see it: a float8
    tensor (the fp8 KV cache) viewed as uint8, which gloo and NCCL both
    move, bit for bit; any other tensor itself."""
    return x.view(torch.uint8) if x.dtype in _FP8 else x


def _a2a(x: torch.Tensor, split_dim: int, concat_dim: int,
         group) -> torch.Tensor:
    """Tiled all-to-all: dim ``split_dim`` shrinks by n, ``concat_dim``
    grows by n.  ``all_to_all_single`` exchanges chunks of dim 0, so the
    n chunks of ``split_dim`` move to the front (one permute-copy), and the
    received chunks, one per source rank in rank order, merge into
    ``concat_dim`` as its major factor."""
    n = _group_size(group)
    shape = list(x.shape)
    chunks = x.reshape(shape[:split_dim] + [n, shape[split_dim] // n]
                       + shape[split_dim + 1:])
    send = chunks.movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    _issue("all-to-all", dist.all_to_all_single, as_bytes(recv),
           as_bytes(send), group=group)
    shape[split_dim] //= n
    shape[concat_dim] *= n
    return recv.movedim(0, concat_dim).reshape(shape)


class _Switch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cur, tgt, group):
        ctx.args = (cur, tgt, group)
        return _a2a(x, tgt, cur, group)

    @staticmethod
    def backward(ctx, g):
        cur, tgt, group = ctx.args
        return _a2a(g, cur, tgt, group), None, None, None


def dynamic_switch(x: torch.Tensor, cur_shard: int, tgt_shard: int,
                   group) -> torch.Tensor:
    """Switch the sharded sequence dimension from ``cur_shard`` to
    ``tgt_shard``: exactly one tiled all-to-all over ``group``; per-device
    volume M/N (paper Table 2 row ``s_i -> s_j``).  The local view of dim
    ``cur_shard`` grows by N and dim ``tgt_shard`` shrinks by N."""
    if cur_shard == tgt_shard:
        return x
    n = _group_size(group)
    if x.shape[tgt_shard] % n:
        raise ValueError(
            f"dynamic_switch: dim {tgt_shard} (size {x.shape[tgt_shard]}) "
            f"not divisible by SP size {n}")
    return _Switch.apply(x, cur_shard, tgt_shard, group)


def shard(x: torch.Tensor, dim: int, n: int, index: int) -> torch.Tensor:
    """Slice ``index`` of ``n`` equal slices of ``x`` along ``dim`` (a view;
    the backward pads the gradient with zeros)."""
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} (size {x.shape[dim]}) not divisible "
                         f"by {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


def split(x: torch.Tensor, tgt_shard: int, group) -> torch.Tensor:
    """s_hat -> s_i: slice the rank's shard out of a replicated sequence.
    Zero communication; the backward pads the gradient with zeros."""
    return shard(x, tgt_shard, _group_size(group), dist.get_rank(group))


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _group_size(group)
    send = x.movedim(dim, 0).contiguous()
    recv = send.new_empty((n * send.shape[0],) + tuple(send.shape[1:]))
    _issue("all-gather", dist.all_gather_into_tensor, as_bytes(recv),
           as_bytes(send), group=group)
    return recv.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _group_size(group)
    send = x.movedim(dim, 0).contiguous()
    recv = send.new_empty((send.shape[0] // n,) + tuple(send.shape[1:]))
    _issue("reduce-scatter", dist.reduce_scatter_tensor, recv, send,
           group=group)
    return recv.movedim(0, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cur, group):
        ctx.args = (cur, group)
        return _all_gather(x, cur, group)

    @staticmethod
    def backward(ctx, g):
        cur, group = ctx.args
        return _reduce_scatter(g, cur, group), None, None


def gather(x: torch.Tensor, cur_shard: int, group) -> torch.Tensor:
    """s_i -> s_hat: all-gather the full sequence along ``cur_shard`` in
    rank order (volume M, used only at model boundaries / rare global
    ops).  The backward reduce-scatters the gradient: the sum of every
    rank's cotangent, sliced back to this rank's shard."""
    return _Gather.apply(x, cur_shard, group)


class _GatherParam(_Gather):
    @staticmethod
    def backward(ctx, g):
        cur, group = ctx.args
        return (_reduce_scatter(g.float(), cur, group).to(g.dtype), None,
                None)


def gather_param(x: torch.Tensor, cur_shard: int, group) -> torch.Tensor:
    """A parameter shard -> the whole parameter: ``gather``'s one
    all-gather along ``cur_shard`` in rank order, in ``x``'s dtype.  The
    backward reduce-scatters the gradient summed in float32 (one rounding
    to ``x``'s dtype after the sum, not one per rank; the bytes are the
    float32 ones) and returns this rank's slice in ``x``'s dtype."""
    return _GatherParam.apply(x, cur_shard, group)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.args = (dim, group)
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.args
        return _all_gather(g, dim, group), None, None


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` and keep this rank's slice of dim ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``): one reduce-scatter, the
    transpose of ``gather``; its backward all-gathers the gradient."""
    n = _group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} (size {x.shape[dim]}) "
                         f"not divisible by {n}")
    return _ReduceScatter.apply(x, dim, group)


# ---------------------------------------------------------------------------
# Permutes (``jax.lax.ppermute``): ring hops and the overlapped switch
# ---------------------------------------------------------------------------

Perm = Sequence[Tuple[int, int]]


def _peers(perm: Perm, rank: int) -> Tuple[int, int]:
    """(the rank this one sends to, the rank it receives from) under
    ``perm``'s (source, destination) pairs, which must move every rank's
    block (the rings and shifts this port issues)."""
    dst = [d for s, d in perm if s == rank]
    src = [s for s, d in perm if d == rank]
    if len(dst) != 1 or len(src) != 1:
        raise ValueError(f"perm {list(perm)} is not a permutation of the "
                         f"group: rank {rank} sends to {dst}, receives "
                         f"from {src}")
    return dst[0], src[0]


def start_permute(x: torch.Tensor, perm: Perm, group):
    """Issue one permute of ``x`` over ``group`` without waiting: returns
    ``(work, recv)``, ``recv`` valid once ``work.wait()`` returned.  One
    ``all_to_all_single`` whose split sizes are nonzero only for the
    destination and the source: gloo's pair transport refuses a
    ``batch_isend_irecv`` to itself, which a ring of one rank needs."""
    n = _group_size(group)
    dst, src = _peers(perm, dist.get_rank(group))
    recv = torch.empty_like(x, memory_format=torch.contiguous_format)
    work = _issue("collective-permute", dist.all_to_all_single,
                  recv.reshape(-1), x.contiguous().reshape(-1), group=group,
                  result=recv,
                  output_split_sizes=[x.numel() * (j == src)
                                      for j in range(n)],
                  input_split_sizes=[x.numel() * (j == dst)
                                     for j in range(n)],
                  async_op=True)
    return work, recv


def _inverse(perm: Perm) -> List[Tuple[int, int]]:
    return [(d, s) for s, d in perm]


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.args = (perm, group)
        work, recv = start_permute(x, perm, group)
        work.wait()
        return recv

    @staticmethod
    def backward(ctx, g):
        perm, group = ctx.args
        work, recv = start_permute(g, _inverse(perm), group)
        work.wait()
        return recv, None, None


def ppermute(x: torch.Tensor, perm: Perm, group) -> torch.Tensor:
    """Send ``x`` along ``perm``'s (source, destination) rank pairs over
    ``group`` (``jax.lax.ppermute``, for permutations of the whole group):
    one collective-permute, whose result bytes are ``x``'s.  The backward
    is the inverse permute."""
    return _Permute.apply(x, tuple(tuple(p) for p in perm), group)


def _exchange(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
              group) -> torch.Tensor:
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    _issue("all-to-all", dist.all_to_all_single, out, x.contiguous(),
           group=group, output_split_sizes=list(recv),
           input_split_sizes=list(send))
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.args = (send, recv, group)
        return _exchange(x, send, recv, group)

    @staticmethod
    def backward(ctx, g):
        send, recv, group = ctx.args
        return _exchange(g, recv, send, group), None, None, None


def exchange(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
             group) -> torch.Tensor:
    """Rows of ``x`` (its dim 0) to every rank of ``group``: the first
    ``send[0]`` rows to rank 0, the next ``send[1]`` to rank 1, and so on;
    the result holds ``recv[j]`` rows from each rank j, in rank order.  One
    all-to-all (``all_to_all_single`` with split sizes; its bytes are the
    result's, as for every all-to-all), whose backward is the same
    exchange with ``send`` and ``recv`` swapped.  Every rank's ``send[j]``
    must be rank j's ``recv`` entry for it."""
    if len(send) != _group_size(group) or len(recv) != len(send):
        raise ValueError(f"exchange: {len(send)} send and {len(recv)} recv "
                         f"splits over a group of {_group_size(group)}")
    if sum(send) != x.shape[0]:
        raise ValueError(f"exchange: send splits {list(send)} do not cover "
                         f"the {x.shape[0]} rows of x")
    return _Exchange.apply(x, tuple(send), tuple(recv), group)


def dsp_shard_batch(batch, tgt_shard: int, group):
    """The paper's ``dsp_dataloader``: every member of an SP group holds the
    same global batch; slice each tensor along ``tgt_shard`` locally."""
    return {k: split(v, tgt_shard, group) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Communication-volume model (paper Table 2): analytic per-device bytes,
# shared with the planner (``core.plan``).
# ---------------------------------------------------------------------------


def comm_volume_bytes(primitive: str, global_bytes: int, n: int) -> float:
    """Per-device communication volume of one DSP primitive on a tensor of
    ``global_bytes`` (= M) with SP size ``n`` (= N).

    Convention — paper Table 2 counts the per-device SHARD that a collective
    re-tiles or materialises, not the on-wire fraction:

      switch  s_i -> s_j   : M/N   one tiled all-to-all re-tiles each
                                   device's full M/N shard (on the wire each
                                   device sends (N-1)/N of that shard; the
                                   paper and this repo fold the constant into
                                   M/N)
      gather  s_i -> s_hat : M     all-gather materialises the full sequence
                                   on every device
      split   s_hat -> s_i : 0     local slice
      keep    s_i -> s_i   : 0

    This single constant is shared by the switching planner
    (``core.plan``) and the schedule executor (``core.schedule``).
    """
    if primitive == "keep":
        return 0.0
    if primitive == "switch":
        return global_bytes / n
    if primitive == "split":
        return 0.0
    if primitive == "gather":
        return float(global_bytes)
    raise ValueError(f"unknown primitive {primitive!r}")


def per_device_bytes(strategy: str, global_bytes: float, n: int, *,
                     kv_bytes: Optional[float] = None,
                     kv_heads: Optional[int] = None,
                     outer: int = 1) -> float:
    """Per-device communication volume of one STAGE executed with an SP
    strategy (Table 3 generalised) — the constant the strategy DP
    (``core.plan.plan_strategy_dp`` via ``Topology.embedded_seconds``)
    prices from.

    ``global_bytes`` is the residual stream (M); ``kv_bytes`` the K/V
    activations (default 2M, the MHA convention).  Units per strategy:

      dsp       2M/N   the layer pair's TWO boundary switches (M/N each,
                       ``comm_volume_bytes("switch", ...)``)
      ulysses   2M/N + kv/N   q + out a2as plus the K/V head-scatter a2as;
                       when ``kv_heads`` does not divide by N (GQA) the K/V
                       scatter degrades to replication: 2M/N + kv
      ring      kv     N ppermute hops of kv/N
      megatron  4M     ONE AG/RS-wrapped block (2 collectives x 2M each);
                       a 2D-transformer layer pair wraps both blocks = 8M
      hybrid    (2M + kv)/N + kv*outer/N   USP: inner a2as move host-local
                       shards, the outer ring streams kv/N per hop for
                       ``outer`` hops (the outer-axis size)
    """
    m = float(global_bytes)
    kv = float(kv_bytes) if kv_bytes is not None else 2.0 * m
    if strategy == "dsp":
        return 2.0 * comm_volume_bytes("switch", m, n)
    if strategy == "ulysses":
        if kv_heads is not None and kv_heads % n:
            return 2.0 * m / n + kv          # K/V replicated (all-gather)
        return 2.0 * m / n + kv / n
    if strategy == "ring":
        return kv
    if strategy == "megatron":
        return 4.0 * m
    if strategy == "hybrid":
        return (2.0 * m + kv) / n + kv * outer / n
    raise ValueError(f"unknown strategy {strategy!r}")


__all__ = [
    "calls", "volume", "reset_calls", "all_reduce", "broadcast", "as_bytes",
    "dynamic_switch", "shard", "split", "gather", "gather_param",
    "reduce_scatter", "ppermute",
    "start_permute", "exchange", "dsp_shard_batch",
    "comm_volume_bytes", "per_device_bytes",
]
