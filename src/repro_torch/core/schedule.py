"""Plan-driven DSP schedule executor (counterpart of
``repro.core.schedule``): the ONE place stage-boundary layout transitions
are emitted.

``core.plan`` decides *where* the sharded sequence dimension moves (a shard
dim per stage, minimising paper-Table-2 per-device bytes); this module turns
that plan into the actual transitions.  The plan side (``Transition``,
``Schedule`` and its periodic and unrolled views, the ``plan_*_schedule``
solvers, and the 2D ``Schedule2D`` classes) is the JAX package's, copied
whole.  The executor has two of its three backends:

* ``backend="explicit"`` — runs on each rank's local tensors and issues the
  paper's primitives over ``torch.distributed`` (``core.dsp``):
  ``dynamic_switch`` (one tiled all-to-all, M/N), ``gather`` (one
  all-gather, M), ``split`` (local slice, 0).  Each primitive is an
  autograd ``Function`` whose backward is its transpose, so the backward
  retraces the forward plan mirrored: local tensor shapes pin each
  cotangent to its primal's layout, and non-mirrored (planned-backward)
  schedules are rejected, as in JAX.
* ``backend="null"`` — every method is the identity (no mesh), so model
  code stays branch-free.

JAX's ``backend="auto"`` lowers each transition as a sharding constraint
through XLA's SPMD partitioner; PyTorch has no such partitioner, so it
raises here.  With ``overlap`` ("chunked" | "double_buffer", given or
carried by the schedule) the explicit backend runs each switch whose
consuming stage has a compute estimate as ``core.overlap
.overlapped_switch``: n - 1 per-shard permutes instead of one all-to-all.
The 2D executor, ``ScheduleExecutor2D``, runs ``forward2d``'s dim-pair
layouts on the ``("sp_out", "sp_in")`` grid the same way: one primitive
over the group of each grid axis a boundary changes, one over the grid
flattened for a joint change of a diagonal, nothing on unchanged axes.

Scanned models execute a *periodic* schedule (``Schedule.periodic``: the
per-period boundaries plus the wrap-around back to the period's first
layout); non-periodic plans execute through the ``UnrolledSchedule`` view
with boundaries addressed by absolute stage index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import dsp
from repro_torch.core.layout import SP2D_AXES
from repro_torch.core.overlap import OVERLAP_MODES, overlapped_switch

from repro_torch.core.plan import (JointCost, JointPlan, Stage, StrategyPlan,
                             joint_cost_bytes, joint_cost_seconds, make_plan,
                             pair_placement_equal, pair_transition_kinds,
                             plan_cost_bytes,
                             plan_cost_seconds, plan_joint, plan_strategy_dp,
                             plan_switches_2d, plan2d_cost_bytes,
                             plan2d_cost_seconds, strategy_plan_cost,
                             switch_count, transition_kind,
                             _as_pair, _pair_joint)

# HLO collective emitted per transition kind (None = communication-free).
COLLECTIVE_OF = {"switch": "all-to-all", "gather": "all-gather",
                 "split": None, "keep": None}


@dataclasses.dataclass(frozen=True)
class Transition:
    """One stage-boundary layout change (a paper Table-2 primitive)."""

    kind: str                  # "keep" | "switch" | "split" | "gather"
    src: Optional[int]
    tgt: Optional[int]

    @property
    def collective(self) -> Optional[str]:
        return COLLECTIVE_OF[self.kind]


def classify(src: Optional[int], tgt: Optional[int]) -> Transition:
    """Wrap a (src, tgt) layout change as a ``Transition`` (Table-2 kind +
    the HLO collective it must compile to).  docs/architecture.md §1."""
    return Transition(transition_kind(src, tgt), src, tgt)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A solved plan: shard dim per stage plus entry/exit layouts.

    ``initial`` is the layout the input arrives with (dataloader split);
    ``final`` pins the exit layout (loss/head) or is None for "free".
    ``topology`` is the mesh model the plan was solved against (None = the
    byte-uniform model); it travels with the plan so every consumer — the
    Sharder, the serving engine, benchmarks — prices it consistently.

    ``bwd_dims`` (optional) is the PLANNED backward: the cotangent's shard
    dim while each stage's backward computes, in stage order.  None means
    the mirrored default — the backward retraces the forward plan, which is
    exactly what autodiff transposition executes, so pricing helpers treat
    None as ``dims``.  See docs/architecture.md §2.4/§3.3.

    ``overlap`` ("chunked" | "double_buffer" | None) records the executor
    mode the plan was priced for: switches decompose into per-shard
    ``ppermute`` hops interleaved with the consuming kernel
    (``core.overlap.overlapped_switch``).  ``overlap_mode(t)`` selects the
    mode PER BOUNDARY — only switches whose consuming stage carries a
    ``compute_seconds`` estimate run overlapped; everything else stays
    synchronous.  See docs/architecture.md §3.6.

    ``strategies`` (optional) is the per-stage EXECUTION strategy from the
    unified (stage, dim, strategy) DP (``core.plan.plan_strategy_dp``):
    "dsp" for stages the boundary switches serve (today's behaviour, the
    None default everywhere), or an embedded strategy
    (``core.topology.STRATEGIES``) for stages that compute ON the resident
    shard with in-stage collectives.  ``strategy(t)`` reads it per stage.
    """

    stages: Tuple[Stage, ...]
    dims: Tuple[int, ...]
    initial: Optional[int] = None
    final: Optional[int] = None
    topology: Optional[object] = None
    bwd_dims: Optional[Tuple[int, ...]] = None
    overlap: Optional[str] = None
    strategies: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        assert len(self.stages) == len(self.dims), (len(self.stages),
                                                    len(self.dims))
        if self.bwd_dims is not None:
            assert len(self.bwd_dims) == len(self.dims), (len(self.bwd_dims),
                                                          len(self.dims))
        if self.strategies is not None:
            assert len(self.strategies) == len(self.dims), (
                len(self.strategies), len(self.dims))
        if self.overlap not in (None, "chunked", "double_buffer"):
            raise ValueError(f"overlap {self.overlap!r}")

    # -- boundary transitions ------------------------------------------------
    def boundary(self, t: int) -> Transition:
        """Transition INTO stage ``t`` (t == 0: from the initial layout)."""
        src = self.initial if t == 0 else self.dims[t - 1]
        return classify(src, self.dims[t])

    def exit(self) -> Transition:
        src = self.dims[-1] if self.dims else self.initial
        return classify(src, self.final if self.final is not None else src)

    def transitions(self) -> List[Transition]:
        out = [self.boundary(t) for t in range(len(self.dims))]
        if self.final is not None:
            out.append(self.exit())
        return out

    # -- per-stage execution strategy ----------------------------------------
    def strategy(self, t: int) -> str:
        """Execution strategy of stage ``t`` ("dsp" when the schedule
        carries no strategy assignment — every pre-strategy plan)."""
        return self.strategies[t] if self.strategies is not None else "dsp"

    @property
    def has_embedded(self) -> bool:
        """True when any stage runs an embedded (non-DSP) strategy."""
        return (self.strategies is not None
                and any(s != "dsp" for s in self.strategies))

    def strategy_seconds(self, topology=None) -> float:
        """Planned seconds of the FULL (dim, strategy) assignment — boundary
        transitions plus each stage's embedded in-stage collectives
        (``core.plan.strategy_plan_cost``; equals ``per_device_seconds``
        for all-"dsp" assignments)."""
        topo = topology if topology is not None else self.topology
        if topo is None:
            raise ValueError("strategy_seconds needs a Topology (none was "
                             "attached at plan time)")
        plan = StrategyPlan(self.dims,
                            self.strategies if self.strategies is not None
                            else ("dsp",) * len(self.dims))
        return strategy_plan_cost(self.stages, plan, n=topo.size,
                                  initial=self.initial, final=self.final,
                                  topology=topo, overlap=self.overlap)

    def expected_strategy_collectives(self, n: int,
                                      outer: int = 1) -> Dict[str, int]:
        """HLO collectives the EMBEDDED stages add per full pass, with the
        conventions of ``analysis.roofline.parse_collectives`` (while-body
        instructions multiply by trip count; K and V rotate as two leaves):
        ulysses/hybrid scatter q,k,v in and o out (4 all-to-alls); a ring
        over a g-device group streams 2g permutes; megatron wraps each
        block in an AG/RS pair.  ``n`` is the full SP degree, ``outer`` the
        hybrid's outer-ring size."""
        counts: Dict[str, int] = {}

        def add(kind: str, k: int):
            if k:
                counts[kind] = counts.get(kind, 0) + k

        for s in (self.strategies or ()):
            if s == "dsp":
                continue
            if s == "ulysses":
                add("all-to-all", 4)
            elif s == "ring":
                add("collective-permute", 2 * n)
            elif s == "megatron":
                add("all-gather", 2)
                add("reduce-scatter", 2)
            elif s == "hybrid":
                add("all-to-all", 4)
                add("collective-permute", 2 * outer)
            else:
                raise ValueError(f"unknown strategy {s!r}")
        return counts

    # -- planned backward ----------------------------------------------------
    @property
    def mirrored(self) -> bool:
        """True when the backward retraces the forward (no separate plan)."""
        return self.bwd_dims is None or self.bwd_dims == self.dims

    @property
    def bwd_plan(self) -> Tuple[int, ...]:
        """Backward layout per stage (the forward dims when mirrored)."""
        return self.bwd_dims if self.bwd_dims is not None else self.dims

    def joint(self) -> JointPlan:
        return JointPlan(self.dims, self.bwd_plan)

    def bwd_seam(self) -> Transition:
        """Cotangent creation at the loss boundary: from the pinned
        ``final`` layout (or the forward's exit layout) into the last
        stage's backward layout."""
        src = self.final if self.final is not None else (
            self.dims[-1] if self.dims else self.initial)
        return classify(src, self.bwd_plan[-1] if self.dims else src)

    def bwd_boundary(self, t: int) -> Transition:
        """Transition of the cotangent leaving stage ``t``'s backward across
        boundary ``t`` (t == 0: the input gradient returns to ``initial``)."""
        bwd = self.bwd_plan
        tgt = self.initial if t == 0 else bwd[t - 1]
        return classify(bwd[t], tgt if tgt is not None else bwd[t])

    def bwd_transitions(self) -> List[Transition]:
        """The backward leg in execution order: seam, then boundaries from
        the last stage back to the input."""
        out = [self.bwd_seam()]
        out.extend(self.bwd_boundary(t)
                   for t in range(len(self.dims) - 1, -1, -1))
        return out

    # -- comm-compute overlap -------------------------------------------------
    def overlap_mode(self, t: int) -> Optional[str]:
        """Executor mode for the boundary INTO stage ``t``: the schedule's
        ``overlap`` mode when that boundary is a switch the consuming stage
        can hide behind (``Stage.compute_seconds`` attached), else None —
        the per-boundary selection the planner priced (gathers don't
        decompose, keeps move nothing, stages without a compute estimate
        have no hide budget)."""
        if self.overlap is None:
            return None
        if self.boundary(t).kind != "switch":
            return None
        if not self.stages[t].compute_seconds:
            return None
        return self.overlap

    def exposed_seconds(self, topology=None) -> float:
        """Planned EXPOSED collective seconds of the forward plan — each
        switch discounted by the consuming stage's ``compute_seconds``
        under this schedule's ``overlap`` mode (``== per_device_seconds``
        when ``overlap`` is None)."""
        topo = topology if topology is not None else self.topology
        if topo is None:
            raise ValueError("exposed_seconds needs a Topology (none was "
                             "attached at plan time)")
        return plan_cost_seconds(self.stages, self.dims, topo,
                                 initial=self.initial, final=self.final,
                                 overlap=self.overlap)

    def hidden_comm_seconds(self, topology=None) -> float:
        """Planned comm seconds the executor HIDES behind kernel compute:
        synchronous cost minus exposed cost (0.0 when ``overlap`` is
        None)."""
        topo = topology if topology is not None else self.topology
        if topo is None:
            raise ValueError("hidden_comm_seconds needs a Topology (none "
                             "was attached at plan time)")
        return self.per_device_seconds(topo) - self.exposed_seconds(topo)

    # -- accounting ----------------------------------------------------------
    def n_switches(self) -> int:
        return sum(1 for tr in self.transitions() if tr.kind == "switch")

    def expected_collectives(self) -> Dict[str, int]:
        """HLO collective kind -> count this schedule must compile to.

        Counts the SYNCHRONOUS lowering; a boundary running overlapped
        (``overlap_mode(t)`` non-None on the explicit backend) lowers its
        all-to-all to ``n - 1`` ``collective-permute`` ops instead —
        tests/test_hlo_collectives.py accounts that form directly."""
        counts: Dict[str, int] = {}
        for tr in self.transitions():
            c = tr.collective
            if c is not None:
                counts[c] = counts.get(c, 0) + 1
        return counts

    def per_device_bytes(self, n: int) -> float:
        """Planned per-device collective bytes (paper Table 2 constant —
        identical to what benchmarks/comm_volume.py prices)."""
        return plan_cost_bytes(self.stages, self.dims, n=n,
                               initial=self.initial, final=self.final)

    def per_device_seconds(self, topology=None) -> float:
        """Planned collective seconds on ``topology`` (defaults to the
        topology the plan was solved against)."""
        topo = topology if topology is not None else self.topology
        if topo is None:
            raise ValueError("per_device_seconds needs a Topology (none was "
                             "attached at plan time)")
        return plan_cost_seconds(self.stages, self.dims, topo,
                                 initial=self.initial, final=self.final)

    def roundtrip_bytes(self, n: int) -> JointCost:
        """Planned per-device bytes of the full training round trip, split
        by leg (``.fwd`` / ``.bwd`` / ``.total``) — what dry-run metas and
        ``benchmarks/comm_volume.py`` report for train cells."""
        return joint_cost_bytes(self.stages, self.joint(), n=n,
                                initial=self.initial, final=self.final)

    def roundtrip_seconds(self, topology=None) -> JointCost:
        """Planned round-trip seconds on ``topology`` (defaults to the one
        the plan was solved against), split by leg."""
        topo = topology if topology is not None else self.topology
        if topo is None:
            raise ValueError("roundtrip_seconds needs a Topology (none was "
                             "attached at plan time)")
        return joint_cost_seconds(self.stages, self.joint(), topo,
                                  initial=self.initial, final=self.final)

    # -- periodic (scan) form ------------------------------------------------
    def periodic(self, period: int) -> "PeriodicSchedule":
        """Validate the plan is steady-state with the given stage period and
        return the scan-body view.  Scanned execution cannot vary layouts
        across iterations, so a non-periodic plan (forward OR planned
        backward) is a hard error — execute those through ``unrolled()``."""
        if len(self.dims) % period:
            raise ValueError(f"{len(self.dims)} stages not a multiple of "
                             f"period {period}")
        for label, dims in (("plan", self.dims),
                            ("backward plan", self.bwd_dims or ())):
            for t, d in enumerate(dims):
                if d != dims[t % period]:
                    raise ValueError(
                        f"{label} is not periodic with period {period}: "
                        f"stage {t} shards dim {d} but stage {t % period} "
                        f"shards {dims[t % period]} (scanned layers need a "
                        f"steady-state plan; pass final=initial, or execute "
                        f"the plan via Schedule.unrolled())")
        for t, s in enumerate(self.strategies or ()):
            if s != self.strategies[t % period]:
                raise ValueError(
                    f"strategy plan is not periodic with period {period}: "
                    f"stage {t} runs {s!r} but stage {t % period} runs "
                    f"{self.strategies[t % period]!r} (scanned layers need "
                    f"a steady-state strategy assignment; execute via "
                    f"Schedule.unrolled())")
        return PeriodicSchedule(self, period)

    def unrolled(self) -> "UnrolledSchedule":
        """Non-periodic (unrolled) execution view: boundaries addressed by
        absolute stage index, no steady-state requirement — the layer loop
        must be python-unrolled instead of scanned."""
        return UnrolledSchedule(self)


@dataclasses.dataclass(frozen=True)
class PeriodicSchedule:
    """Scan-body view of a periodic schedule: entry transition before the
    scan, per-period boundaries inside the body, wrap-around at the body's
    end, exit transition after the scan."""

    schedule: Schedule
    period: int

    @property
    def dims(self) -> Tuple[int, ...]:
        return self.schedule.dims[:self.period]

    @property
    def strategies(self) -> Tuple[str, ...]:
        """Per-period execution strategies (all-"dsp" when the schedule
        carries none); ``Schedule.periodic`` validated periodicity."""
        if self.schedule.strategies is None:
            return ("dsp",) * self.period
        return self.schedule.strategies[:self.period]

    def enter(self) -> Transition:
        return classify(self.schedule.initial, self.dims[0])

    def boundary(self, i: int) -> Transition:
        """Transition into in-period stage ``i`` (1 <= i < period)."""
        assert 1 <= i < self.period, i
        return classify(self.dims[i - 1], self.dims[i])

    def wrap(self) -> Transition:
        """End-of-body transition back to the period's first layout."""
        return classify(self.dims[-1], self.dims[0])

    def exit(self) -> Transition:
        final = self.schedule.final
        return classify(self.dims[0], final if final is not None
                        else self.dims[0])

    # -- planned backward (scan-body view) -----------------------------------
    @property
    def bwd_dims(self) -> Tuple[int, ...]:
        """Per-period backward layouts (the fwd dims when mirrored);
        ``Schedule.periodic`` validated the full backward plan repeats with
        the period, so this prefix IS the steady state."""
        return self.schedule.bwd_plan[:self.period]

    def bwd_seam(self) -> Transition:
        """Cotangent creation at the loss boundary: lands ONCE on the
        backward scan's carry init (outside the while body)."""
        return self.schedule.bwd_seam()

    def bwd_boundary(self, i: int) -> Transition:
        """Cotangent crossing in-period boundary ``i`` backward
        (1 <= i < period): the transpose of ``boundary(i)``'s constraint,
        re-laid-out to the planned backward dims."""
        assert 1 <= i < self.period, i
        bwd = self.bwd_dims
        return classify(bwd[i], bwd[i - 1])

    def bwd_wrap(self) -> Transition:
        """Cotangent leaving the period toward the previous one: the scan
        carry's backward anchor.  The body emits this every iteration, so a
        steady-state plan wants it to be a keep (class-uniform plans with a
        resid-class first and last stage make it one for free)."""
        bwd = self.bwd_dims
        return classify(bwd[0], bwd[-1])

    def bwd_carry_init(self) -> Transition:
        """Reshard of the seam-laid-out cotangent into the backward loop's
        steady-state carry layout (``bwd_dims[0]`` for a stage-0-anchored
        body); lands once, outside the while body, right after the seam."""
        bwd = self.bwd_dims
        return classify(bwd[-1], bwd[0])

    def bwd_enter(self) -> Transition:
        """Input gradient leaving the scan for the ``initial`` layout (the
        dataloader split owns both ends); lands once, after the loop.  A
        stage-0-anchored body exits the carry in ``bwd_dims[0]``."""
        initial = self.schedule.initial
        bwd = self.bwd_dims
        return classify(bwd[0], initial if initial is not None else bwd[0])


@dataclasses.dataclass(frozen=True)
class UnrolledSchedule:
    """Absolute-index view of a (possibly non-periodic) schedule: entry
    transition, one boundary per stage index, exit transition.  The model's
    layer loop must be python-unrolled — there is no wrap-around, every
    boundary may differ, and the fwd and bwd halves of a training step may
    use different layouts per stage (``Schedule.bwd_dims``)."""

    schedule: Schedule

    @property
    def dims(self) -> Tuple[int, ...]:
        return self.schedule.dims

    @property
    def n_stages(self) -> int:
        return len(self.schedule.dims)

    def enter(self) -> Transition:
        return classify(self.schedule.initial, self.dims[0])

    def boundary(self, t: int) -> Transition:
        """Transition into stage ``t`` (1 <= t < n_stages, absolute)."""
        assert 1 <= t < len(self.dims), t
        return classify(self.dims[t - 1], self.dims[t])

    def exit(self) -> Transition:
        final = self.schedule.final
        return classify(self.dims[-1], final if final is not None
                        else self.dims[-1])


def plan_schedule(stages: Sequence[Stage], seq_dims: Sequence[int], *,
                  n: int = 2, initial: Optional[int] = None,
                  final: Optional[int] = None, topology=None,
                  overlap: Optional[str] = None) -> Schedule:
    """Solve the switching plan (``core.plan.make_plan``: Belady greedy on
    uniform costs, exact DP otherwise — in seconds when a Topology is given)
    and wrap it as a Schedule carrying that topology.

    Args:
      stages: the model's stage declaration (``models.*.stages(cfg)``).
      seq_dims: switchable sequence-dim indices.
      n: SP degree for byte pricing (ignored when ``topology`` is given).
      initial/final: entry layout and pinned exit layout (None = free).
      topology: price plans in seconds on this mesh model.
      overlap: executor overlap mode ("chunked" | "double_buffer"); the
        solver prices each switch at its EXPOSED seconds against the
        consuming stage's ``compute_seconds`` and the mode travels on the
        returned schedule for the executor to pick up.
    Returns:
      a ``Schedule`` with a mirrored (autodiff-transposed) backward.
    """
    dims = make_plan(stages, seq_dims, n=n, initial=initial, final=final,
                     topology=topology, overlap=overlap)
    return Schedule(tuple(stages), tuple(dims), initial=initial, final=final,
                    topology=topology, overlap=overlap)


def plan_joint_schedule(stages: Sequence[Stage], seq_dims: Sequence[int], *,
                        n: int = 2, initial: Optional[int] = None,
                        final: Optional[int] = None, topology=None,
                        couple: bool = False,
                        require_mirrored: bool = False,
                        overlap: Optional[str] = None) -> Schedule:
    """Solve the joint forward+backward round trip
    (``core.plan.plan_joint``) and wrap it as a Schedule.

    The returned schedule carries ``bwd_dims`` ONLY when the joint DP found
    a round trip strictly cheaper than the mirrored plan — so consumers
    (the executor, dry-run metas) get the mirrored default for free on
    symmetric instances.  Same arguments as ``plan_schedule`` plus
    ``couple`` (charge residual re-shards when the backward deviates; leave
    False under full remat) and ``require_mirrored`` (skip the joint DP and
    return the mirrored baseline — for scanned forwards that can only
    execute the autodiff transpose).  See docs/architecture.md §2.4.
    """
    jp = plan_joint(stages, seq_dims, n=n, initial=initial, final=final,
                    topology=topology, couple=couple,
                    require_mirrored=require_mirrored, overlap=overlap)
    return Schedule(tuple(stages), jp.fwd, initial=initial, final=final,
                    topology=topology,
                    bwd_dims=None if jp.mirrored else jp.bwd,
                    overlap=overlap)


def plan_strategy_schedule(stages: Sequence[Stage], seq_dims: Sequence[int],
                           *, n: int = 2, initial: Optional[int] = None,
                           final: Optional[int] = None, topology=None,
                           overlap: Optional[str] = None) -> Schedule:
    """Solve the unified (stage, dim, strategy) DP
    (``core.plan.plan_strategy_dp``) and wrap it as a Schedule that carries
    the per-stage strategy assignment.

    On a uniform (or absent) topology the DP collapses to the classic
    switch planner bit-for-bit and the returned schedule is all-"dsp" —
    byte-identical to ``plan_schedule``'s.  On a tiered fabric
    (e.g. ``Topology.multihost``) stages may come back with embedded
    strategies ("ulysses" / "ring" / "megatron" / "hybrid"); the executor
    and ``Sharder`` read ``Schedule.strategies`` to pick layouts and
    collectives per stage.
    """
    sp = plan_strategy_dp(stages, seq_dims, n=n, initial=initial,
                          final=final, topology=topology, overlap=overlap)
    return Schedule(tuple(stages), sp.dims, initial=initial, final=final,
                    topology=topology, overlap=overlap,
                    strategies=sp.strategies)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class ScheduleExecutor:
    """Applies a schedule's transitions to activations.

    One executor object serves a whole forward pass; models call
    ``enter`` / ``boundary`` / ``wrap`` / ``exit`` at stage boundaries.
    ``psched`` is the execution view of the plan: a ``PeriodicSchedule``
    (in-period boundary indices) or an ``UnrolledSchedule`` (absolute
    indices, no ``wrap``).  ``ctx`` (a ``core.layout.ParallelContext``)
    names the process group the switches run over, its ``model`` dim; the
    accounting (``expected_*``) reads none.

    ``overlap`` (explicit backend only; inherited from ``Schedule.overlap``
    when not given): every switch whose consuming stage carries a
    ``compute_seconds`` estimate runs as ``core.overlap
    .overlapped_switch``, n - 1 per-shard permutes instead of one
    all-to-all (the same values and fewer bytes; eagerly they run in
    series and hide behind nothing, see ``core.overlap``).  The accounting
    (``expected_*``) counts the synchronous all-to-alls, as JAX's does.
    """

    def __init__(self, psched: Optional[Union[PeriodicSchedule,
                                              UnrolledSchedule]], *,
                 backend: str, ctx=None, overlap: Optional[str] = None):
        if backend == "auto":
            raise NotImplementedError(
                "backend='auto' has no PyTorch counterpart: JAX lowers each "
                "transition as a sharding constraint through XLA's SPMD "
                "partitioner, which PyTorch lacks; use backend='explicit'")
        if backend not in ("explicit", "null"):
            raise ValueError(backend)
        if backend != "null" and psched is None:
            raise ValueError(f"{backend} backend needs a schedule")
        if overlap not in OVERLAP_MODES:
            raise ValueError(f"overlap {overlap!r}")
        if overlap is not None and backend != "explicit":
            raise ValueError("overlap executes on the explicit backend only")
        sched = psched.schedule if psched is not None else None
        if sched is not None and not sched.mirrored:
            raise ValueError(
                "explicit backend executes the mirrored backward only: "
                "local shapes pin each cotangent to its primal's layout")
        # an explicit overlap argument wins; otherwise the explicit backend
        # inherits the mode the planner attached to the schedule
        if overlap is None and sched is not None:
            overlap = sched.overlap
        self.psched = psched
        self.backend = backend
        self.ctx = ctx
        self.overlap = overlap
        self.unrolled = isinstance(psched, UnrolledSchedule)

    @classmethod
    def null(cls) -> "ScheduleExecutor":
        return cls(None, backend="null")

    def _overlap_for(self, tr: Transition,
                     consumer: Optional[int]) -> Optional[str]:
        """Overlap mode for one applied transition: the executor's mode when
        the transition is a switch whose consuming stage (``consumer``, an
        index into ``Schedule.stages``) carries a ``compute_seconds``
        estimate — the same per-boundary selection the planner priced."""
        if self.overlap is None or tr.kind != "switch" or consumer is None:
            return None
        if not self.psched.schedule.stages[consumer].compute_seconds:
            return None
        return self.overlap

    def apply(self, x, tr: Transition, consumer: Optional[int] = None):
        """Apply one boundary transition: the paper's primitive over the
        context's ``model`` group.  ``consumer`` is the stage whose kernels
        consume the result; it selects the overlap mode of a switch (None,
        as at the exit, runs it synchronously)."""
        if self.backend == "null" or tr.kind == "keep":
            return x
        if self.ctx is None:
            raise ValueError("the explicit backend needs a ParallelContext "
                             "to apply a transition")
        group = self.ctx.sp_group
        if tr.kind == "switch":
            mode = self._overlap_for(tr, consumer)
            if mode is not None:
                return overlapped_switch(x, tr.src, tr.tgt, group, mode=mode)
            return dsp.dynamic_switch(x, tr.src, tr.tgt, group)
        if tr.kind == "split":
            return dsp.split(x, tr.tgt, group)
        if tr.kind == "gather":
            return dsp.gather(x, tr.src, group)
        raise ValueError(tr.kind)

    def enter(self, x):
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.enter(), consumer=0)

    def boundary(self, x, i: int):
        """Transition into stage ``i`` — in-period index for a periodic
        schedule, absolute index for an unrolled one."""
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.boundary(i), consumer=i)

    def wrap(self, x):
        if self.backend == "null":
            return x
        if self.unrolled:
            raise ValueError("unrolled schedules have no wrap-around; "
                             "iterate boundary(t) over absolute indices")
        # the wrap feeds the next period's first stage
        return self.apply(x, self.psched.wrap(), consumer=0)

    def exit(self, x):
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.exit())

    # -- accounting ----------------------------------------------------------
    def expected_collectives(self, n_periods: int = 1) -> Dict[str, int]:
        """Collective counts of the full forward execution — entry + body x
        ``n_periods`` for a periodic schedule (the exit "keep" adds
        nothing), entry + every absolute boundary + exit for an unrolled
        one (``n_periods`` is ignored there)."""
        if self.psched is None:
            return {}
        counts: Dict[str, int] = {}

        def add(tr):
            c = tr.collective
            if c is not None:
                counts[c] = counts.get(c, 0) + 1

        add(self.psched.enter())
        if self.unrolled:
            for t in range(1, self.psched.n_stages):
                add(self.psched.boundary(t))
        else:
            for _ in range(n_periods):
                for i in range(1, self.psched.period):
                    add(self.psched.boundary(i))
                add(self.psched.wrap())
        add(self.psched.exit())
        return counts

    def expected_bwd_collectives(self, n_periods: int = 1) -> Dict[str, int]:
        """Collective counts of the backward leg: each primitive's backward
        is one collective of the transposed kind's count (a switch's is a
        switch, a gather's a reduce-scatter), so the mirrored leg issues
        the forward's counts with every all-gather a reduce-scatter."""
        fwd = self.expected_collectives(n_periods)
        return {("reduce-scatter" if c == "all-gather" else c): k
                for c, k in fwd.items()}


# ---------------------------------------------------------------------------
# 2D layouts (TSP fold): schedules over dim pairs on an ("sp_out","sp_in")
# grid — the execution layer of ``core.plan.plan_switches_2d``
# ---------------------------------------------------------------------------

Pair = Tuple[Optional[int], Optional[int]]


@dataclasses.dataclass(frozen=True)
class PairTransition:
    """One stage-boundary 2D layout change.

    Decomposes PER AXIS: component ``k`` classifies with the 1D Table-2
    kinds, and a changed axis owes one SUB-MESH collective over just that
    grid axis — unchanged axes owe nothing.  Diagonal-to-diagonal changes
    (``(d,d) -> (e,e)``, the embedded 1D plans) are JOINT: the executor
    runs them as ONE full-group primitive, exactly the 1D transition."""

    src: Pair
    tgt: Pair

    @property
    def joint(self) -> bool:
        return _pair_joint(self.src, self.tgt)

    @property
    def axis_kinds(self) -> Tuple[str, str]:
        return pair_transition_kinds(self.src, self.tgt)

    @property
    def kind(self) -> str:
        """Coarse kind for display: the joint kind when joint, else
        "keep" if no axis moves data, else "switch"/"gather" if any axis
        does (switch wins — mixed boundaries are dominated by the a2a)."""
        kinds = self.axis_kinds
        if self.joint:
            return kinds[0]
        if "switch" in kinds:
            return "switch"
        if "gather" in kinds:
            return "gather"
        return "keep"

    def collective_counts(self) -> Dict[str, int]:
        """HLO collectives this boundary must compile to: ONE full-group
        primitive for joint changes, one sub-axis collective per changed
        axis otherwise — and NOTHING on unchanged axes (the compiled
        contract pinned by the (2,4) md_scenario)."""
        counts: Dict[str, int] = {}
        kinds = (self.axis_kinds[:1] if self.joint else self.axis_kinds)
        for kind in kinds:
            c = COLLECTIVE_OF[kind]
            if c is not None:
                counts[c] = counts.get(c, 0) + 1
        return counts


def classify2(src, tgt) -> PairTransition:
    """Wrap a 2D layout change as a ``PairTransition`` (ints lift to the
    diagonal, None to fully unsharded)."""
    return PairTransition(_as_pair(src) or (None, None),
                          _as_pair(tgt) or (None, None))


@dataclasses.dataclass(frozen=True)
class Schedule2D:
    """A solved 2D plan: one dim-pair layout per stage plus entry/exit
    layouts, on a ``grid = (n_out, n_in)`` SP mesh.  ``topology`` (axes
    mapped positionally onto the grid) travels with the plan for seconds
    pricing, exactly like the 1D ``Schedule``.  Forward-only: 2D training
    legs are future work (docs/architecture.md §9)."""

    stages: Tuple[Stage, ...]
    layouts: Tuple[Pair, ...]
    grid: Tuple[int, int]
    initial: Optional[Pair] = None
    final: Optional[Pair] = None
    topology: Optional[object] = None

    def __post_init__(self):
        assert len(self.stages) == len(self.layouts), (
            len(self.stages), len(self.layouts))
        object.__setattr__(self, "layouts",
                           tuple(_as_pair(lo) for lo in self.layouts))
        object.__setattr__(self, "initial", _as_pair(self.initial))
        object.__setattr__(self, "final", _as_pair(self.final))

    @property
    def size(self) -> int:
        return self.grid[0] * self.grid[1]

    # -- boundary transitions ------------------------------------------------
    def boundary(self, t: int) -> PairTransition:
        """Transition INTO stage ``t`` (t == 0: from the initial layout)."""
        src = self.initial if t == 0 else self.layouts[t - 1]
        return classify2(src, self.layouts[t])

    def exit(self) -> PairTransition:
        src = self.layouts[-1] if self.layouts else self.initial
        return classify2(src, self.final if self.final is not None else src)

    def transitions(self) -> List[PairTransition]:
        out = [self.boundary(t) for t in range(len(self.layouts))]
        if self.final is not None:
            out.append(self.exit())
        return out

    # -- accounting ----------------------------------------------------------
    def expected_collectives(self) -> Dict[str, int]:
        """HLO collective kind -> count of the unrolled plan (one sub-axis
        collective per changed axis, one full-group primitive per joint
        change, zero on unchanged axes)."""
        counts: Dict[str, int] = {}
        for tr in self.transitions():
            for c, k in tr.collective_counts().items():
                counts[c] = counts.get(c, 0) + k
        return counts

    def per_device_bytes(self) -> float:
        """Planned per-device collective bytes (per-axis Table-2 model —
        ``core.plan.plan2d_cost_bytes``)."""
        return plan2d_cost_bytes(self.stages, self.layouts, grid=self.grid,
                                 initial=self.initial, final=self.final)

    def per_device_seconds(self, topology=None) -> float:
        """Planned collective seconds on ``topology`` (defaults to the one
        the plan was solved against; axes map positionally onto the
        grid)."""
        topo = topology if topology is not None else self.topology
        if topo is None:
            raise ValueError("per_device_seconds needs a Topology (none was "
                             "attached at plan time)")
        return plan2d_cost_seconds(self.stages, self.layouts, topo,
                                   initial=self.initial, final=self.final)

    # -- periodic (scan) form ------------------------------------------------
    def periodic(self, period: int) -> "PeriodicSchedule2D":
        """Validate the plan repeats with ``period`` stages and return the
        scan-body view (same steady-state requirement as the 1D
        ``Schedule.periodic``)."""
        if len(self.layouts) % period:
            raise ValueError(f"{len(self.layouts)} stages not a multiple "
                             f"of period {period}")
        for t, lo in enumerate(self.layouts):
            if lo != self.layouts[t % period]:
                raise ValueError(
                    f"2D plan is not periodic with period {period}: stage "
                    f"{t} holds {lo} but stage {t % period} holds "
                    f"{self.layouts[t % period]}")
        return PeriodicSchedule2D(self, period)


@dataclasses.dataclass(frozen=True)
class PeriodicSchedule2D:
    """Scan-body view of a periodic 2D schedule: entry transition before
    the scan, per-period boundaries inside the body, wrap-around at the
    body's end, exit transition after the scan."""

    schedule: Schedule2D
    period: int

    @property
    def layouts(self) -> Tuple[Pair, ...]:
        return self.schedule.layouts[:self.period]

    def enter(self) -> PairTransition:
        return classify2(self.schedule.initial, self.layouts[0])

    def boundary(self, i: int) -> PairTransition:
        """Transition into in-period stage ``i`` (1 <= i < period)."""
        assert 1 <= i < self.period, i
        return classify2(self.layouts[i - 1], self.layouts[i])

    def wrap(self) -> PairTransition:
        """End-of-body transition back to the period's first layout."""
        return classify2(self.layouts[-1], self.layouts[0])

    def exit(self) -> PairTransition:
        final = self.schedule.final
        return classify2(self.layouts[0], final if final is not None
                         else self.layouts[0])


def plan2d_schedule(stages: Sequence[Stage], seq_dims: Sequence[int], *,
                    grid: Tuple[int, int], initial=None, final=None,
                    topology=None) -> Schedule2D:
    """Solve the 2D switching plan (``core.plan.plan_switches_2d`` — exact
    DP over (stage, dim pair), delegating to the 1D DP on degenerate grids)
    and wrap it as a ``Schedule2D`` carrying the grid and topology."""
    layouts = plan_switches_2d(stages, seq_dims, grid=grid, initial=initial,
                               final=final, topology=topology)
    return Schedule2D(tuple(stages), tuple(layouts), grid=tuple(grid),
                      initial=initial, final=final, topology=topology)


Order = Tuple[int, int]


def _reorder(x: torch.Tensor, dim: int, perm: Sequence[int]) -> torch.Tensor:
    """Chunk c of ``x``'s dim ``dim`` (``len(perm)`` equal chunks) becomes
    chunk ``perm[c]``'s: a local copy (differentiable), none when ``perm``
    is the identity."""
    if list(perm) == list(range(len(perm))):
        return x
    index = torch.tensor(perm, device=x.device)
    return x.unflatten(dim, (len(perm), -1)).index_select(
        dim, index).flatten(dim, dim + 1)


def _inverse_perm(perm: Sequence[int]) -> List[int]:
    inv = [0] * len(perm)
    for q, c in enumerate(perm):
        inv[c] = q
    return inv


class ScheduleExecutor2D:
    """Applies a 2D schedule's transitions to each rank's local tensors.

    JAX's executor constrains each boundary to a per-axis ``NamedSharding``
    and XLA's SPMD partitioner lowers it (``backend="auto"``); PyTorch has
    no partitioner, so ``auto`` raises here and the explicit backend issues
    the collectives itself, exactly the ones ``expected_collectives`` and
    ``expected_carry_collectives`` count:

    * a boundary that changes one grid axis k runs ONE ``core.dsp``
      primitive (``dynamic_switch``, ``split`` or ``gather``) over axis
      k's group; one that changes both runs one per axis, in the order
      that keeps each step inside its axis' groups;
    * a joint (diagonal-to-diagonal) change runs ONE primitive over
      ``ParallelContext.flat_group``, the grid flattened;
    * unchanged axes issue nothing.

    Local chunks follow JAX's shardings: component k of a pair shards its
    tensor dim over ``sp_axes[k]``; a diagonal ``(d, d)`` shards d over
    both, ``_stage_order``'s first axis major.  A single-axis all-to-all
    splits the rank's chunk further (into a diagonal, the unchanged axis
    stays major) or merges the chunks of its axis' group (out of a
    diagonal, which needs the unchanged axis major), so each single-axis
    step checks that order and raises ValueError where the boundary would
    need traffic across the other axis' groups.  A joint all-to-all takes
    the source and target orders as it finds them: the flattened group
    numbers its ranks in mesh order (``sp_out`` major), and a diagonal
    numbered ``sp_in`` major has its chunks permuted locally on the way in
    or out (``flat_chunks``).  Only grids with both axes above 1 have an
    order to keep.

    ``dims`` maps stage-view dims (B, T, S, C) to the dims of the tensor
    at hand (the stacked q/k/v, the attention output); no component may
    land on ``batch_dim``.  ``anchor`` and ``fold_anchor`` are identities
    on local tensors, kept so model code reads like JAX's.  Each primitive
    is an autograd ``Function``, so the backward runs the transposes in
    reverse; no 2D backward schedule is planned.  ``backend="null"`` is
    the identity."""

    def __init__(self, psched: Optional[PeriodicSchedule2D], *,
                 backend: str, ctx=None):
        if backend == "auto":
            raise NotImplementedError(
                "backend='auto' has no PyTorch counterpart: JAX lowers each "
                "2D boundary as a per-axis sharding constraint through "
                "XLA's SPMD partitioner, which PyTorch lacks; use "
                "backend='explicit'")
        if backend not in ("explicit", "null"):
            raise ValueError(backend)
        if backend != "null" and psched is None:
            raise ValueError(f"{backend} backend needs a schedule")
        if backend == "explicit":
            if ctx is None or tuple(ctx.sp_axes) != SP2D_AXES:
                raise ValueError("the explicit backend needs the "
                                 "ParallelContext of a mesh with dims "
                                 f"{SP2D_AXES}")
            grid = (ctx.size("sp_out"), ctx.size("sp_in"))
            if grid != tuple(psched.schedule.grid):
                raise ValueError(f"the schedule was planned for grid "
                                 f"{psched.schedule.grid}, the mesh is "
                                 f"{grid}")
        self.psched = psched
        self.backend = backend
        self.ctx = ctx
        # per-stage diagonal component order (major axis first), as JAX's
        self._orders = (tuple(self._stage_order(i)
                              for i in range(psched.period))
                        if psched is not None else ())

    @classmethod
    def null(cls) -> "ScheduleExecutor2D":
        return cls(None, backend="null")

    def _stage_order(self, i: int) -> Order:
        """Component order for stage ``i``'s DIAGONAL layout: which grid
        axis is MAJOR in the joint sharding of the dim.

        A single-axis all-to-all into a diagonal splits the rank's chunk
        further, so the UNCHANGED axis ends up major; one out of a diagonal
        merges the chunks of the changed axis' group, which needs the
        unchanged axis major.  A joint all-to-all takes any order
        (``apply``).  So the run of stages holding this diagonal (around
        the period) takes the order its single-axis entry gives (JAX's
        rule, which looks at the predecessor only), else the one its
        single-axis exit needs, else grid order (outer major).  Where JAX's
        rule fixes an order this is the same; where it leaves one free
        (a joint entry, or the same diagonal again, which JAX numbers
        outer-major and XLA renumbers with a permute the plan does not
        count) the run keeps one order throughout."""
        lays = [lo or (None, None) for lo in self.psched.layouts]
        lo, p = lays[i], len(lays)
        if lo[0] is None or lo[0] != lo[1] or all(x == lo for x in lays):
            return (0, 1)
        start, end = i, i
        while lays[(start - 1) % p] == lo:
            start -= 1
        while lays[(end + 1) % p] == lo:
            end += 1
        for nb in (lays[(start - 1) % p], lays[(end + 1) % p]):
            keep = [k for k in (0, 1) if nb[k] == lo[k]]
            if len(keep) == 1:
                return (keep[0], 1 - keep[0])
        return (0, 1)

    # -- execution -------------------------------------------------------------
    @property
    def _ordered(self) -> bool:
        """True when a diagonal's order places data: both axes above 1."""
        grid = self.psched.schedule.grid
        return grid[0] > 1 and grid[1] > 1

    def same_placement(self, i: int, j: int) -> bool:
        """True when in-period stages ``i`` and ``j`` give a tensor the same
        local chunks: the same pair on the axes above 1 and, on a diagonal,
        the same order where the grid has one."""
        a, b = self.psched.layouts[i], self.psched.layouts[j]
        if not pair_placement_equal(a, b, self.psched.schedule.grid):
            return False
        return (not self._ordered or a is None or a[0] != a[1]
                or self._orders[i] == self._orders[j])

    def _axis_step(self, src, src_order: Order, k: int, tgt_k):
        """The single-axis step that sets component ``k`` of ``src`` to
        ``tgt_k``: (kind, source dim, target dim, the result's order), or
        None when it would need traffic across the other axis' groups."""
        a, c = src[k], src[1 - k]
        keep_major = (1 - k, k)
        if self._ordered and a is not None and a == c \
                and src_order != keep_major:
            return None           # merging a diagonal's minor factor
        order = keep_major if tgt_k is not None and tgt_k == c else (0, 1)
        return transition_kind(a, tgt_k), a, tgt_k, order

    def _steps(self, tr: PairTransition, src_order: Order, tgt_order: Order):
        """The primitives ``tr`` runs, from a source numbered ``src_order``
        into a target numbered ``tgt_order``."""
        src, tgt = tr.src, tr.tgt
        if tr.joint:
            kind = tr.axis_kinds[0]
            if kind == "keep" and src[0] is not None and self._ordered \
                    and src_order != tgt_order:
                raise ValueError(
                    f"{src} numbered {src_order} -> {tgt_order}: a keep that "
                    f"renumbers a diagonal needs a permute the plan does "
                    f"not count")
            return [("joint", kind, src[0], tgt[0])]
        changed = [k for k in (0, 1) if src[k] != tgt[k]]
        for seq in ([changed] if len(changed) < 2 else ([0, 1], [1, 0])):
            steps, cur, order = [], tuple(src), src_order
            for k in seq:
                step = self._axis_step(cur, order, k, tgt[k])
                if step is None:
                    break
                kind, a, b, order = step
                steps.append(("axis", kind, a, b, k))
                cur = tuple(tgt[j] if j == k else cur[j] for j in (0, 1))
            else:
                diagonal = tgt[0] is not None and tgt[0] == tgt[1]
                if not (diagonal and self._ordered and order != tgt_order):
                    return steps
        raise ValueError(
            f"{src} numbered {src_order} -> {tgt} numbered {tgt_order} needs "
            f"traffic across both grid axes' groups, which the plan does "
            f"not count")

    def apply(self, x, tr: PairTransition, *, order: Order = (0, 1),
              src_order: Order = (0, 1), dims=None, batch_dim=None):
        """Apply one 2D boundary transition to the local ``x``: ``order``
        numbers the target's diagonal (JAX's argument), ``src_order`` the
        source's; ``dims`` maps stage-view dims to ``x``'s."""
        if self.backend == "null":
            return x

        def td(d):
            t = dims[d] if dims is not None else d
            if t == batch_dim:
                raise ValueError(f"stage dim {d} lands on the batch dim "
                                 f"{batch_dim}")
            return t

        ctx = self.ctx
        for step in self._steps(tr, src_order, order):
            if step[0] == "axis":
                _, kind, a, b, k = step
                group = ctx.group(SP2D_AXES[k])
                if kind == "switch":
                    x = dsp.dynamic_switch(x, td(a), td(b), group)
                elif kind == "split":
                    x = dsp.split(x, td(b), group)
                elif kind == "gather":
                    x = dsp.gather(x, td(a), group)
                continue
            _, kind, a, b = step
            group = ctx.flat_group()
            if kind == "switch":
                # group rank q receives chunk flat_chunks(order)[q] of dim
                # b, and sends back its chunk flat_chunks(src_order)[q] of
                # dim a, which lands at position q
                x = _reorder(x, td(b), ctx.flat_chunks(order))
                x = dsp.dynamic_switch(x, td(a), td(b), group)
                x = _reorder(x, td(a), _inverse_perm(
                    ctx.flat_chunks(src_order)))
            elif kind == "split":
                n, idx = ctx.pair_index(tr.tgt, b, order)
                x = dsp.shard(x, td(b), n, idx)
            elif kind == "gather":
                x = _reorder(dsp.gather(x, td(a), group), td(a),
                             _inverse_perm(ctx.flat_chunks(src_order)))
        return x

    # -- schedule-view conveniences ------------------------------------------
    def enter(self, x, **kw):
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.enter(), order=self._orders[0],
                          **kw)

    def boundary(self, x, i: int, **kw):
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.boundary(i), order=self._orders[i],
                          src_order=self._orders[i - 1], **kw)

    def wrap(self, x, **kw):
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.wrap(), order=self._orders[0],
                          src_order=self._orders[-1], **kw)

    def exit(self, x, **kw):
        if self.backend == "null":
            return x
        return self.apply(x, self.psched.exit(), src_order=self._orders[0],
                          **kw)

    def carry_enter(self, x, **kw):
        """The entry of a forward that carries the LAST in-period layout
        (``forward2d``): ``initial`` -> ``layouts[-1]``, the first
        transition ``expected_carry_collectives`` counts."""
        if self.backend == "null":
            return x
        return self.apply(x, classify2(self.psched.schedule.initial,
                                       self.psched.layouts[-1]),
                          order=self._orders[-1], **kw)

    def carry_exit(self, x, **kw):
        """The exit of such a forward: ``layouts[-1]`` -> ``final`` (a keep
        when ``final`` is None), the last transition it counts."""
        if self.backend == "null":
            return x
        final = self.psched.schedule.final
        last = self.psched.layouts[-1]
        return self.apply(x, classify2(last, final if final is not None
                                       else last),
                          src_order=self._orders[-1], **kw)

    def anchor(self, x, i: int, **kw):
        """JAX re-asserts stage ``i``'s layout on an intra-stage tensor;
        a local tensor already holds it."""
        return x

    def fold_anchor(self, x, i: int, *, dims, merge_dim: int = 0):
        """JAX anchors a stage-folded view; the fold of a local tensor is a
        local reshape."""
        return x

    # -- accounting ----------------------------------------------------------
    def expected_collectives(self, n_periods: int = 1) -> Dict[str, int]:
        """Collective counts of the full forward execution: entry + body x
        ``n_periods`` + exit, each boundary contributing one sub-axis
        collective per changed axis (one full-group primitive when
        joint)."""
        if self.psched is None:
            return {}
        counts: Dict[str, int] = {}

        def add(tr: PairTransition):
            for c, k in tr.collective_counts().items():
                counts[c] = counts.get(c, 0) + k

        add(self.psched.enter())
        for _ in range(n_periods):
            for i in range(1, self.psched.period):
                add(self.psched.boundary(i))
            add(self.psched.wrap())
        add(self.psched.exit())
        return counts

    def expected_carry_collectives(self, n_periods: int = 1) -> Dict[str, int]:
        """Collective counts when the carry holds the LAST in-period
        stage's layout and the transition into stage 0 executes inside the
        body (``models.transformer2d.forward2d``: the attention-core
        layouts live strictly inside the block, so the first in-period
        boundary lands on the stacked qkv as the wrap): entry
        initial -> layouts[-1], then per period wrap + boundaries 1..p-1,
        then exit layouts[-1] -> final."""
        if self.psched is None:
            return {}
        counts: Dict[str, int] = {}

        def add(tr: PairTransition):
            for c, k in tr.collective_counts().items():
                counts[c] = counts.get(c, 0) + k

        sched = self.psched.schedule
        add(classify2(sched.initial, self.psched.layouts[-1]))
        for _ in range(n_periods):
            add(self.psched.wrap())
            for i in range(1, self.psched.period):
                add(self.psched.boundary(i))
        final = sched.final
        if final is not None:
            add(classify2(self.psched.layouts[-1], final))
        return counts


__all__ = [
    "Transition", "classify", "Schedule", "PeriodicSchedule",
    "UnrolledSchedule", "plan_schedule", "plan_joint_schedule",
    "plan_strategy_schedule", "ScheduleExecutor", "COLLECTIVE_OF",
    "PairTransition", "classify2", "Schedule2D", "PeriodicSchedule2D",
    "plan2d_schedule", "ScheduleExecutor2D",
]
