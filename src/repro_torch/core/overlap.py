"""Comm-compute overlap over ``torch.distributed`` (counterpart of
``repro.core.overlap``): the planned switch decomposed into per-shard
permutes, plus the shared ring-rotation helper.

* ``ring_stream`` — the chunk/rotate/fold loop of ``core.ring`` (K/V block
  rotation): one ``core.dsp.ppermute`` hop per block after each fold, the
  held block at step ``t`` being the one rank ``(idx - t) % n`` owns.

* ``overlapped_switch`` — the stage-boundary all-to-all of
  ``core.dsp.dynamic_switch`` decomposed into ``n - 1`` independent
  per-shard permutes, collective-matmul style.  Hop ``t`` sends the local
  chunk addressed to peer ``(idx + t) % n`` and receives source shard
  ``(idx - t) % n`` of the rank's own target slice.  Bitwise equal to the
  one-shot all-to-all; per-rank volume ``(n - 1)/n · M/n`` (each hop
  moves ``M/n²``).

``core.schedule.ScheduleExecutor`` runs the second as its
``overlap="chunked" | "double_buffer"`` mode.

This eager port reproduces the overlapped switch's values, collective
counts and bytes, not its overlap.  Each hop is one ``all_to_all_single``
over the whole group (``core.dsp.ppermute``), and collectives of one group
run in order on one NCCL stream, so hop ``t + 1`` waits on hop ``t``; the
switch returns only after every hop has landed, so no work of the
consuming block runs beside them.  On n > 1 cards it is n - 1 collectives
in series in place of one all-to-all.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import dsp
from repro_torch.core.plan import OVERLAP_MODES


def _shift(n: int, t: int):
    """The permute that sends rank i's block to rank (i + t) % n."""
    return [(i, (i + t) % n) for i in range(n)]


def ring_stream(blocks: Sequence[torch.Tensor], carry, fold: Callable,
                group):
    """Rotate ``blocks`` one ring hop per step, n steps over ``group``'s n
    ranks, while folding each held block into ``carry``.

    At step ``t`` the held blocks are the ones rank ``(idx - t) % n``
    contributed; ``fold(t, src, blocks, carry) -> carry`` consumes them.
    The rotation happens after the fold, every step including the last, so
    n hops move exactly the blocks' full global bytes (the Table-3 ring
    volume).  Returns the folded carry."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    perm = _shift(n, 1)
    blocks = tuple(blocks)
    for t in range(n):
        carry = fold(t, (idx - t) % n, blocks, carry)
        blocks = tuple(dsp.ppermute(b, perm, group) for b in blocks)
    return carry


class _Hops(torch.autograd.Function):
    """Hops 1 .. n-1 of an overlapped switch of ``x`` along ``tgt``: every
    permute issued, then each waited on in turn (the group's stream still
    runs them one after another).  The backward sends each cotangent back
    the same way, by the inverse permutes, and places it where its chunk
    was cut."""

    @staticmethod
    def forward(ctx, x, tgt, group):
        ctx.args = (tuple(x.shape), tgt, group)
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        c = x.shape[tgt] // n
        started = [dsp.start_permute(x.narrow(tgt, ((idx + t) % n) * c, c),
                                     _shift(n, t), group)
                   for t in range(1, n)]
        for work, _ in started:
            work.wait()
        return tuple(recv for _, recv in started)

    @staticmethod
    def backward(ctx, *grads):
        shape, tgt, group = ctx.args
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        c = shape[tgt] // n
        started = [dsp.start_permute(g, _shift(n, -t), group)
                   for t, g in enumerate(grads, 1)]
        out = grads[0].new_zeros(shape)
        for t, (work, recv) in enumerate(started, 1):
            work.wait()
            out.narrow(tgt, ((idx + t) % n) * c, c).copy_(recv)
        return out, None, None


def overlapped_switch(x: torch.Tensor, src: int, tgt: int, group, *,
                      mode: str = "chunked",
                      consume: Optional[Callable] = None) -> torch.Tensor:
    """``core.dsp.dynamic_switch`` decomposed into ``n - 1`` per-shard
    permutes — the overlapped stage boundary.

    The local tensor (dim ``src`` holding this rank's shard, dim ``tgt``
    whole) is cut into ``n`` chunks along ``tgt``; hop ``t`` sends chunk
    ``(idx + t) % n`` to peer ``(idx + t) % n`` and receives source shard
    ``(idx - t) % n`` of the rank's own target slice; hop 0 is the chunk
    kept locally, with no communication.  At one rank nothing is issued.
    The result equals the one-shot tiled all-to-all bit for bit.

    ``mode`` is ``"chunked"`` or ``"double_buffer"``.  In JAX the two
    differ only in how XLA schedules the hops around the merge; eager
    PyTorch has no such schedule, so both copy each received shard into its
    place in the output in hop order.

    ``consume`` (optional): ``consume(shard, t) -> shard`` applied to each
    source shard (hop ``t``) before assembly, the collective-matmul hook;
    the result concatenates the consumed shards."""
    if mode not in ("chunked", "double_buffer"):
        raise ValueError(f"overlapped_switch mode {mode!r} not in "
                         f"('chunked', 'double_buffer')")
    if src == tgt:
        return x
    n = dist.get_world_size(group)
    if x.shape[tgt] % n:
        raise ValueError(
            f"overlapped_switch: dim {tgt} (size {x.shape[tgt]}) "
            f"not divisible by SP size {n}")
    if n == 1:
        return consume(x, 0) if consume is not None else x
    idx = dist.get_rank(group)
    c = x.shape[tgt] // n
    pieces = [x.narrow(tgt, idx * c, c), *_Hops.apply(x, tgt, group)]
    if consume is not None:
        pieces = [consume(p, t) for t, p in enumerate(pieces)]
    out_shape = list(pieces[0].shape)
    out_shape[src] *= n
    out = pieces[0].new_empty(out_shape)
    pb = pieces[0].shape[src]
    for t, piece in enumerate(pieces):
        out.narrow(src, ((idx - t) % n) * pb, pb).copy_(piece)
    return out


__all__ = ["ring_stream", "overlapped_switch", "OVERLAP_MODES"]
