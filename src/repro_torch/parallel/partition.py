"""Activation layouts of the LM family under DSP (counterpart of
``repro.parallel.partition``): the parallel plan and the ``Sharder``.

The model calls semantic hooks at its stage boundaries (``act3``,
``heads_stacked``, ``mixer3``, ...) and stays mesh-agnostic; which dim
each stage class shards comes from the planned switching schedule
(``models.lm.dsp_schedule``), as in JAX.  Layouts are logical dims of the
model's (B, S, H·Dh) stage view: 1 is the sequence, 2 the flattened
head/channel axis, None the whole tensor.  Residual/channel stages
("resid") shard the sequence; the mixer cores ("mixer": the attention
softmax, the SSD scan) shard heads or channels.

In JAX each hook is a sharding constraint and XLA finds the source
layout.  Here each hook states the class layout its tensor leaves and the
one it enters, and issues one ``core.dsp`` primitive over the ``model``
group of a ``core.layout.ParallelContext``, or nothing: a keep where both
are the same class, ``dynamic_switch`` (one all-to-all) from resid to
mixer and back, ``gather`` (one all-gather, reduce-scattered backward)
from resid to whole.  Each primitive's backward is its transpose, so the
backward retraces the plan mirrored.  Where JAX calls one hook from two
layouts (``mixer3`` enters the scan and keeps inside it, ``mixer_exit3``
leaves a mixer and keeps at a layer exit) the caller passes ``src``.
Without a context every hook is the identity.

``seq_halo`` has no JAX hook: XLA adds the causal conv's halo itself, and
here it is one permute of the previous rank's last rows.

On a mesh this slice runs ``ParallelPlan(mode="dsp", zero=False,
shard_vocab=False)``: parameters stay whole on every rank and the trainer
sums their grads over the world.  ``make_sharder`` raises
``NotImplementedError`` for what it does not run yet, naming the ROADMAP
item (queue 1) that brings it.  JAX's parameter and cache specs
(``param_pspecs``, ``cache_pspecs``) and its decode and MoE hooks come
with those items; its ``ffn_hidden``, which no JAX model calls, has no
counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import dsp
from repro_torch.core.layout import ParallelContext, from_mesh


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """How the ``model`` axis is used for one architecture."""

    mode: str = "dsp"            # "dsp" | "tp" | "none"
    ep: bool = False             # expert-parallel MoE over the model axis
    zero: bool = True            # FSDP params over the data axis
    shard_vocab: bool = True     # embedding table vocab dim over model axis


MODES = ("dsp", "tp", "none")

# tensor dim of each logical dim (1 = sequence, 2 = heads/channels) in the
# views the hooks take: (B, S, C), (B, H, S, D), and stacked (k, B, H, S, D)
_VIEWS: Dict[str, Dict[int, int]] = {"bsc": {1: 1, 2: 2},
                                     "bhsd": {1: 2, 2: 1},
                                     "kbhsd": {1: 3, 2: 2}}


@dataclasses.dataclass(frozen=True)
class Sharder:
    """Semantic activation-layout hooks over ``ctx``'s ``model`` group.
    ``ctx=None`` (one device) makes every hook the identity.

    ``schedule`` is the planned switching schedule on the (B, S, H·Dh)
    stage view; ``resid_dim``/``mixer_dim`` cache the planned shard dim of
    the residual/channel stages and of the mixer stages."""

    ctx: Optional[ParallelContext]
    plan: ParallelPlan
    schedule: Optional[Any] = None
    resid_dim: Optional[int] = None
    mixer_dim: Optional[int] = None

    def with_schedule(self, schedule) -> "Sharder":
        _check_schedule(schedule, on_mesh=self.ctx is not None)
        resid, mixer = _stage_dims(self.plan, schedule)
        return dataclasses.replace(self, schedule=schedule, resid_dim=resid,
                                   mixer_dim=mixer)

    # -- the mesh ---------------------------------------------------------------
    @property
    def sp_size(self) -> int:
        return 1 if self.ctx is None else self.ctx.sp_size

    @property
    def sp_index(self) -> int:
        return 0 if self.ctx is None else self.ctx.sp_index

    @property
    def dp_size(self) -> int:
        return 1 if self.ctx is None else self.ctx.dp_size

    @property
    def dp_index(self) -> int:
        return 0 if self.ctx is None else self.ctx.dp_index

    @property
    def seq_shards(self) -> int:
        """Ranks the resid stages split the sequence over: the SP size when
        the residual stream is sequence-sharded, else 1."""
        return self.sp_size if self.resid_dim == 1 else 1

    def seq_offset(self, s_local: int) -> int:
        """Global position of this rank's first token of a resid-layout
        tensor with ``s_local`` tokens."""
        return self.sp_index * s_local if self.resid_dim == 1 else 0

    def mixer_slice(self, n: int) -> Tuple[int, int]:
        """(first, count) of this rank's share of an ``n``-long head or
        channel axis in the mixer layout: chunk ``sp_index`` of ``sp_size``
        when the mixer shards dim 2, else all of it."""
        if self.ctx is None or self.mixer_dim != 2:
            return 0, n
        k = n // self.sp_size
        return self.sp_index * k, k

    def wants_head_switch(self, n_heads: int) -> bool:
        """True when the planned mixer layout is head-sharded and the head
        count divides the SP size (``attention_sp`` gathers K/V
        otherwise)."""
        return self.mixer_dim == 2 and n_heads % self.sp_size == 0

    # -- the one transition ----------------------------------------------------
    def _class(self, name: str) -> Optional[int]:
        return {"resid": self.resid_dim, "mixer": self.mixer_dim,
                "whole": None}[name]

    def _move(self, x: torch.Tensor, src: str, tgt: str,
              view: str) -> torch.Tensor:
        """``x`` from class layout ``src`` ("resid" or "mixer") to ``tgt``
        ("resid", "mixer" or "whole"), its logical dims placed as ``view``
        says: a keep, one switch or one gather."""
        if self.ctx is None or self.plan.mode != "dsp":
            return x
        a, b = self._class(src), self._class(tgt)
        if a == b:
            return x
        dims = _VIEWS[view]
        group = self.ctx.sp_group
        if b is None:
            return dsp.gather(x, dims[a], group)
        return dsp.dynamic_switch(x, dims[a], dims[b], group)

    # -- (B, S, C) residual stream ----------------------------------------------
    def enter3(self, x):
        """Entry boundary, before the layer loop: the dataloader splits the
        sequence, which is the resid layout (``_check_schedule``), a
        keep."""
        return self._move(x, "resid", "resid", "bsc")

    def act3(self, x):
        """Inside the resid stages (after the MLP, at a layer exit): a
        keep."""
        return self._move(x, "resid", "resid", "bsc")

    def wrap3(self, x):
        """Top of each period: the carry already holds the resid layout, a
        keep."""
        return self._move(x, "resid", "resid", "bsc")

    def mixer_exit3(self, x, *, src: str = "mixer"):
        """Out of a mixer stage into the residual stream (the paper's
        switch back), on the (B, S, C) view: the attention output before
        ``wo`` (channel-sharded, C = heads·D), or, with ``src="resid"``, a
        tensor already back in it (a keep)."""
        return self._move(x, src, "resid", "bsc")

    # -- (B, H, S, D) attention heads -------------------------------------------
    def heads_enter(self, x):
        """Into the mixer stage, one (B, H, S, D) tensor: one switch from
        the sequence to the heads."""
        return self._move(x, "resid", "mixer", "bhsd")

    def heads_stacked(self, x):
        """Into the mixer stage, stacked (k, B, H, S, D) q/k/v: ONE switch
        for all k (the fused DSP switch)."""
        return self._move(x, "resid", "mixer", "kbhsd")

    def heads(self, x):
        """Inside the mixer stage (the attention output): a keep."""
        return self._move(x, "mixer", "mixer", "bhsd")

    def q_seq(self, x):
        """(B, H, S, D) q kept sequence-sharded (the kv-gather path, whose
        heads do not divide the SP size): a keep."""
        return self._move(x, "resid", "resid", "bhsd")

    def kv_gathered(self, x):
        """(2, B, Hkv, S, D) stacked K/V gathered to the whole sequence:
        one all-gather (the paper's gather primitive)."""
        return self._move(x, "resid", "whole", "kbhsd")

    # -- (B, L, D) scan operands --------------------------------------------------
    def mixer3(self, x, *, src: str):
        """A flat scan operand into the mixer layout on its channel dim:
        from the sequence-sharded stream (``src="resid"``, one switch), or
        kept inside the scan (``src="mixer"``)."""
        return self._move(x, src, "mixer", "bsc")

    def scan_out3(self, x):
        """The scan's output back to the resid layout: one switch."""
        return self.mixer_exit3(x)

    def replicated(self, x, *, src: str = "resid"):
        """Small tensors whole on every rank (the SSM's B/C groups: G may
        undershoot the SP size): one all-gather of the sequence."""
        return self._move(x, src, "whole", "bsc")

    def xent_chunks(self, x):
        """The loss's chunks: each rank's chunks are its own sequence
        shard, a keep."""
        return self._move(x, "resid", "resid", "bsc")

    def seq_halo(self, x, rows: int) -> Optional[torch.Tensor]:
        """The ``rows`` positions just before this rank's sequence shard of
        (B, S, C) ``x``: the previous rank's last rows, sent with one
        cyclic permute from rank r to r + 1, zeroed on rank 0 (whose
        backward sends the last rank a zero cotangent).  None where the
        sequence is whole, at one rank too: no neighbour, no call."""
        if (self.ctx is None or self.plan.mode != "dsp"
                or self.resid_dim != 1 or self.sp_size == 1):
            return None
        if x.shape[1] < rows:
            raise ValueError(f"a sequence shard of {x.shape[1]} positions "
                             f"cannot hold a halo of {rows}")
        n = self.sp_size
        halo = dsp.ppermute(x[:, x.shape[1] - rows:],
                            [(r, (r + 1) % n) for r in range(n)],
                            self.ctx.sp_group)
        return halo * (self.sp_index != 0)


def _check_schedule(schedule, *, on_mesh: bool) -> None:
    if schedule is not None and hasattr(schedule, "layouts"):
        raise TypeError(
            "make_sharder received a 2D (layout-pair) schedule; the "
            "class-hook Sharder executes one dim per stage class")
    if schedule is None or not on_mesh:
        return
    if schedule.initial != 1 or schedule.final != 1:
        raise ValueError(
            f"the LM's batch arrives split on the sequence and its loss "
            f"reads it there: the schedule must enter and leave on dim 1, "
            f"not {schedule.initial} and {schedule.final}")
    if any(s != "dsp" for s in (schedule.strategies or ())):
        raise NotImplementedError(
            f"embedded strategies {sorted(set(schedule.strategies))} in the "
            f"LM's stages are not ported (ROADMAP queue 1 item 3's "
            f"remainder)")
    if not schedule.mirrored:
        raise NotImplementedError(
            "a planned (non-mirrored) backward: the hooks' primitives "
            "transpose the forward, and JAX runs it only through XLA "
            "(ROADMAP queue 1, standing notes)")
    if schedule.overlap is not None:
        raise NotImplementedError(
            f"overlap {schedule.overlap!r} for the LM's switches comes with "
            f"the overlapped switch that overlaps (ROADMAP queue 1 item 2)")


def _stage_dims(plan: ParallelPlan,
                schedule) -> Tuple[Optional[int], Optional[int]]:
    """Planned (resid_dim, mixer_dim) of the logical (B, S, H·Dh) stage
    view: mixer stages compute along the sequence (dim 1 in
    ``compute_dims``), everything else is a residual/channel stage.
    Without a schedule the mode-based defaults apply.  The hooks execute
    ONE layout per stage class, so a plan that gives same-class stages
    different dims is rejected."""
    if schedule is not None:
        resid = mixer = None
        for st, d in zip(schedule.stages, schedule.dims):
            name = "mixer" if 1 in st.compute_dims else "resid"
            have = mixer if name == "mixer" else resid
            if have is not None and have != d:
                raise ValueError(
                    f"non-uniform plan: {name} stage {st.name!r} shards dim "
                    f"{d}, earlier {name} stages shard {have}; the Sharder "
                    f"hook path needs one layout per stage class")
            if name == "mixer":
                mixer = d
            else:
                resid = d
        return resid, mixer
    if plan.mode in ("dsp", "tp"):
        return 1, 2
    return None, None


def make_sharder(mesh, plan: ParallelPlan, schedule=None) -> Sharder:
    """The hooks for ``plan`` on ``mesh`` (a ``DeviceMesh`` with a
    ``model`` dim, the others splitting the batch), or the identity hooks
    when ``mesh`` is None.  ``schedule`` (``models.lm.dsp_schedule``) gives
    the stage layouts; without one, forwards plan their own from the
    batch's shape, priced in bytes.

    On a mesh only plan mode ``dsp`` with ``zero``, ``shard_vocab`` and
    ``ep`` off runs, under a mirrored all-"dsp" schedule with no
    ``overlap``; the rest raises ``NotImplementedError`` naming the
    ROADMAP item that brings it."""
    if plan.mode not in MODES:
        raise ValueError(f"plan mode {plan.mode!r} not in {MODES}")
    ctx = None
    if mesh is not None:
        ctx = from_mesh(mesh)
        if ctx.sp_axes != ("model",):
            raise NotImplementedError(
                f"the LM's hooks run over one 'model' mesh dim, not the SP "
                f"grid {ctx.sp_axes} (ROADMAP queue 1 item 3's remainder)")
        if plan.mode == "none":
            raise ValueError("plan mode 'none' shares no work over the "
                             "model dim: pass mesh=None")
        refused = {
            "mode='tp'": (plan.mode == "tp", "the parameter layouts of "
                          "ROADMAP queue 1 item 3's remainder: tp's column- "
                          "and row-parallel weights"),
            "zero=True": (plan.zero, "the parameter layouts of ROADMAP "
                          "queue 1 item 3's remainder: ZeRO over data"),
            "shard_vocab=True": (plan.shard_vocab, "the parameter layouts "
                                 "of ROADMAP queue 1 item 3's remainder: "
                                 "sharded_embed's vocab ring"),
            "ep=True": (plan.ep, "MoE with ep, ROADMAP queue 1 item 7"),
        }
        for what, (hit, item) in refused.items():
            if hit:
                raise NotImplementedError(
                    f"ParallelPlan {what} on a mesh is not ported yet: "
                    f"{item}")
    _check_schedule(schedule, on_mesh=ctx is not None)
    resid, mixer = _stage_dims(plan, schedule)
    return Sharder(ctx=ctx, plan=plan, schedule=schedule, resid_dim=resid,
                   mixer_dim=mixer)


def null_sharder() -> Sharder:
    """One device, plan ``none``: every hook the identity."""
    return make_sharder(None, ParallelPlan(mode="none"))


__all__ = ["ParallelPlan", "Sharder", "make_sharder", "null_sharder"]
