"""Cost-aware switching-plan solver: choose shard dims per computation stage
(counterpart of ``repro.core.plan``, a whole copy: it is pure Python).

The paper leaves "automatically determine the most effective switching
strategy" as future work (§6).  We implement it.  A computation is a sequence
of *stages*; each stage declares the set of sequence dimensions it computes
along (the shard dim must avoid those) and, optionally, the global shape and
dtype width of the activation that crosses into it.  Transitions between
stage layouts are weighted with the paper's Table-2 per-device byte costs
(``M`` = global activation bytes, ``N`` = SP degree):

    keep    s_i -> s_i   : 0
    switch  s_i -> s_j   : M / N      (one tiled all-to-all)
    split   s_hat -> s_i : 0          (local slice)
    gather  s_i -> s_hat : M          (one all-gather)

Bytes are not time, though: the same byte count over a DCN hop costs far
more than over ICI.  Both solvers therefore price transitions in SECONDS on
a ``repro_torch.core.topology.Topology`` (per-link bandwidth/latency, alpha+beta
collective models) when one is given; with ``topology=None`` the byte model
applies unchanged — and ``Topology.uniform(n)`` is constructed so its
seconds equal the Table-2 byte counts exactly, making the byte model the
uniform special case (plans reproduce bit-for-bit; property-tested).

Two solvers share this cost model:

* ``plan_switches`` — the Belady (farthest-next-conflict) greedy.  With
  uniform per-boundary bytes every switch costs the same, the problem is
  offline cache replacement with a single slot, and the greedy is exactly
  optimal (property-tested against brute force).  This is the fast path.

* ``plan_switches_dp`` — exact dynamic program over (stage, shard_dim),
  O(stages * dims^2).  Required whenever boundary bytes differ (asymmetric
  T/S extents, enc-dec stage graphs whose encoder tensors dwarf the decoder,
  SSM scan stages at a different width), when a *final* layout is pinned
  (loss/head wants the dataloader split back), or when a non-uniform
  topology makes per-(src, tgt) switch costs differ (ICI-local dims vs
  DCN-crossing dims): the greedy ignores all three and can lose.

``make_plan`` dispatches between them; ``plan_cost_bytes`` prices any plan so
benchmarks can report planned-vs-measured collective volume with the same
constant (``repro_torch.core.dsp.comm_volume_bytes``) the executor uses, and
``plan_cost_seconds`` prices it on a Topology.

Training adds a third solver: the backward pass is a first-class stage
graph, not the autodiff transposition of the forward plan.  ``plan_joint``
solves the ROUND TRIP — a forward layout per stage plus an independent
cotangent layout per stage's backward, coupled only at the *pinned seam*
(the loss boundary, where the cotangent is created in the loss layout) —
with an exact DP over (stage, fwd_dim, bwd_dim).  Stages may declare
separate gradient shapes (``Stage.bwd_shape`` / ``bwd_dtype_bytes``); when
forward and backward tensor sizes or link placements are asymmetric the
optimal backward path can diverge from the mirrored forward, and the solver
keeps the mirrored plan whenever the DP finds nothing strictly cheaper.

Models do not call these directly — they declare a ``stages(cfg)`` sequence
and ``repro_torch.core.schedule`` turns the plan into boundary transitions (the
one plan-driven executor for both the explicit shard_map path and the auto
constraint path).  The full walk-through of this module's cost model and
DPs, with the Table-2 derivation, lives in docs/architecture.md §2.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Stage:
    """One computation stage of a multi-dimensional transformer.

    ``compute_dims``: logical sequence-dim indices the stage computes along
    (attention over S_i, a scan over S_i, ...).  The shard dim must not be in
    this set — for the stage's backward too: the VJP of a computation along
    S_i also computes along S_i.  ``name`` is cosmetic.

    ``shape``/``dtype_bytes`` describe the global activation entering the
    stage; when given they weight the cost of the transition at the stage's
    entry boundary (paper Table 2), when absent the boundary gets unit
    weight (pure switch counting).

    ``bwd_shape``/``bwd_dtype_bytes`` describe the GRADIENT crossing the
    same boundary during the backward pass (grad of the stage's input).  The
    usual case — grads shaped like activations, same dtype — needs neither:
    both default to the forward values.  Declare them when the backward
    tensor differs (f32 grad accumulation over bf16 activations, stages
    whose VJP carries extra payload); asymmetric fwd/bwd bytes are what make
    the joint round-trip DP (``plan_joint``) diverge from the mirrored plan.
    See docs/architecture.md §2.4.

    ``compute_seconds`` (optional) is the stage's per-device kernel time
    (``analysis.roofline.stage_compute_seconds`` /
    ``attach_compute_seconds``) — the budget an OVERLAPPED switch into this
    stage can hide behind.  Ignored unless a solver/pricer is called with
    ``overlap=`` and a topology; plans are bit-for-bit unchanged otherwise.

    The last three fields feed the (stage, dim, strategy) DP
    (``plan_strategy_dp``) and are inert everywhere else.  ``strategies``
    restricts the embedded strategy candidates this stage may run with when
    the shard sits ON its compute dim (None = all of
    ``core.topology.STRATEGIES``; () = DSP-switch only, today's
    behaviour).  ``kv_bytes``/``kv_heads`` describe the stage's K/V
    activations for the strategies that stream or head-scatter them
    (defaults: 2x the stream, MHA head counts — the Table-3 conventions).

    ``extents`` (optional) overrides ``shape`` for DIVISIBILITY checks
    only: the switchable extent per dim, used by the 2D-layout planner to
    rule out layouts whose shard factor does not divide the dim.  Declare
    it when the shardable granularity is coarser than the shape — e.g. a
    channel dim whose byte extent is ``H * dh`` but which only shards on
    head boundaries (extent ``H``).  Inert in the 1D planners.
    """

    compute_dims: FrozenSet[int]
    name: str = ""
    shape: Optional[Tuple[int, ...]] = None
    dtype_bytes: int = 2
    bwd_shape: Optional[Tuple[int, ...]] = None
    bwd_dtype_bytes: Optional[int] = None
    compute_seconds: Optional[float] = None
    strategies: Optional[Tuple[str, ...]] = None
    kv_bytes: Optional[float] = None
    kv_heads: Optional[int] = None
    extents: Optional[Tuple[int, ...]] = None

    def allows(self, dim: int) -> bool:
        return dim not in self.compute_dims

    @property
    def nbytes(self) -> Optional[float]:
        if self.shape is None:
            return None
        n = 1
        for d in self.shape:
            n *= d
        return float(n) * self.dtype_bytes

    @property
    def bwd_nbytes(self) -> Optional[float]:
        """Global bytes of the gradient entering this stage's backward
        (defaults to the forward activation bytes, re-priced at
        ``bwd_dtype_bytes`` when only the dtype differs)."""
        shape = self.bwd_shape if self.bwd_shape is not None else self.shape
        if shape is None:
            return None
        db = (self.bwd_dtype_bytes if self.bwd_dtype_bytes is not None
              else self.dtype_bytes)
        n = 1
        for d in shape:
            n *= d
        return float(n) * db


def transition_kind(src: Optional[int], tgt: Optional[int]) -> str:
    """Classify a layout change as a paper Table-2 primitive.

    Args:
      src/tgt: shard dim before/after the boundary (None = unsharded s_hat).
    Returns:
      "keep" | "split" | "gather" | "switch".  docs/architecture.md §1.
    """
    if src == tgt:
        return "keep"
    if src is None:
        return "split"
    if tgt is None:
        return "gather"
    return "switch"


def transition_bytes(src: Optional[int], tgt: Optional[int],
                     global_bytes: float, n: int) -> float:
    """Per-device bytes of one layout transition (paper Table 2, via the
    repo's single shared constant ``core.dsp.comm_volume_bytes``).

    Args:
      src/tgt: shard dim before/after (None = unsharded).
      global_bytes: global tensor bytes (M).
      n: SP degree (N).
    Returns:
      per-device bytes (switch = M/N, gather = M, keep/split = 0).
    """
    from repro_torch.core.dsp import comm_volume_bytes
    return comm_volume_bytes(transition_kind(src, tgt), global_bytes, n)


def transition_seconds(src: Optional[int], tgt: Optional[int],
                       global_bytes: float, topology) -> float:
    """Seconds of one layout transition on a ``core.topology.Topology``
    (alpha+beta collective models; per-dim placements make the cost depend
    on WHICH dims are involved).  docs/architecture.md §4."""
    return topology.transition_seconds(transition_kind(src, tgt),
                                       global_bytes, src, tgt)


def _transition_cost(src: Optional[int], tgt: Optional[int],
                     global_bytes: float, n: int, topology, *,
                     hide: float = 0.0) -> float:
    """The ONE edge weight both solvers and all pricers use: Table-2 bytes
    without a topology, seconds on it otherwise.  ``hide`` (seconds of
    kernel compute the edge can overlap with — zero unless the caller plans
    with ``overlap=``) turns a switch's cost into its EXPOSED seconds,
    ``max(comm, hide) - hide`` (``Topology.exposed_seconds``)."""
    if topology is None:
        return transition_bytes(src, tgt, global_bytes, n)
    if hide > 0.0:
        return topology.exposed_seconds(transition_kind(src, tgt),
                                        global_bytes, src, tgt,
                                        compute_seconds=hide)
    return transition_seconds(src, tgt, global_bytes, topology)


# executor overlap modes (None = synchronous one-shot all-to-all), which
# the ``overlap=`` planner arguments take (``core.overlap`` runs them)
OVERLAP_MODES = (None, "chunked", "double_buffer")


def _check_overlap(overlap: Optional[str]) -> None:
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap {overlap!r} not in {OVERLAP_MODES}")


def _hide_seconds(stages: Sequence[Stage], t: int,
                  overlap: Optional[str]) -> float:
    """Compute seconds available to hide the switch INTO stage ``t``:
    the consuming stage's kernel under ``"chunked"`` (shard ``i+1`` streams
    while the kernel consumes shard ``i``), plus the PRODUCING stage's
    kernel under ``"double_buffer"`` (the staged hops carry no inter-chunk
    dependencies, so in a scanned body they hide behind the whole period).
    Stages without a ``compute_seconds`` estimate contribute nothing — the
    boundary stays fully exposed."""
    if overlap is None:
        return 0.0
    c = stages[t].compute_seconds or 0.0
    if overlap == "double_buffer" and t > 0:
        c += stages[t - 1].compute_seconds or 0.0
    return c


def _bwd_hide_seconds(stages: Sequence[Stage], t: int,
                      overlap: Optional[str]) -> float:
    """Hide budget for the cotangent crossing boundary ``t`` BACKWARD, into
    stage ``t-1``'s backward kernel (its VJP computes along the same dims,
    for at least as long — the forward estimate is the conservative floor).
    ``"double_buffer"`` adds the producing stage ``t``'s backward (the loss
    seam, ``t == len(stages)``, has no producing kernel)."""
    if overlap is None or t <= 0:
        return 0.0
    c = stages[t - 1].compute_seconds or 0.0
    if overlap == "double_buffer" and t < len(stages):
        c += stages[t].compute_seconds or 0.0
    return c


def _boundary_bytes(stages: Sequence[Stage], t: int,
                    default: float = 1.0) -> float:
    """Global bytes of the tensor crossing the boundary INTO stage ``t``."""
    nb = stages[t].nbytes
    return default if nb is None else nb


def _bwd_boundary_bytes(stages: Sequence[Stage], t: int,
                        default: float = 1.0) -> float:
    """Global bytes of the GRADIENT crossing boundary ``t`` backward — the
    cotangent leaving stage ``t``'s backward for stage ``t-1``'s."""
    nb = stages[t].bwd_nbytes
    return default if nb is None else nb


def _uniform_cost(stages: Sequence[Stage]) -> bool:
    return len({_boundary_bytes(stages, t) for t in range(len(stages))}) <= 1


def _check_feasible(stages: Sequence[Stage], seq_dims: Sequence[int]) -> None:
    for st in stages:
        if all(not st.allows(d) for d in seq_dims):
            raise ValueError(f"stage {st.name!r} forbids every sequence dim")


# ---------------------------------------------------------------------------
# Greedy (uniform-cost fast path)
# ---------------------------------------------------------------------------

def _next_conflict(stages: Sequence[Stage], start: int, dim: int) -> int:
    """Index of the first stage >= start that forbids ``dim`` (len() if none)."""
    for t in range(start, len(stages)):
        if not stages[t].allows(dim):
            return t
    return len(stages)


def plan_switches(stages: Sequence[Stage], seq_dims: Sequence[int],
                  initial: Optional[int] = None) -> List[int]:
    """Return shard dim per stage, minimising switch count (Belady greedy).

    Optimal only under uniform boundary costs with a free final layout; use
    ``make_plan`` to dispatch to the exact DP otherwise.

    Args:
      stages: the stage sequence.
      seq_dims: all switchable sequence-dim indices.
      initial: shard dim the input arrives with (e.g. the dataloader split);
        None lets the planner pick freely for stage 0.
    """
    if not stages:
        return []
    _check_feasible(stages, seq_dims)

    plan: List[int] = []
    cur = initial
    for t, st in enumerate(stages):
        if cur is not None and st.allows(cur):
            plan.append(cur)
            continue
        # forced (or first) placement: farthest next conflict wins
        candidates = [d for d in seq_dims if st.allows(d)]
        cur = max(candidates, key=lambda d: (_next_conflict(stages, t, d), -d))
        plan.append(cur)
    return plan


# ---------------------------------------------------------------------------
# Exact DP (non-uniform costs / pinned final layout)
# ---------------------------------------------------------------------------

def plan_switches_dp(stages: Sequence[Stage], seq_dims: Sequence[int],
                     *, n: int = 2, initial: Optional[int] = None,
                     final: Optional[int] = None,
                     final_bytes: Optional[float] = None,
                     topology=None,
                     overlap: Optional[str] = None) -> List[int]:
    """Exact minimum-cost plan: DP over (stage, shard_dim).

    Transition into stage ``t`` is weighted by the bytes of the activation
    entering it (``Stage.nbytes``, unit weight when unset) — in Table-2
    bytes by default, in seconds on ``topology`` when one is given (per-dim
    placements then make switch costs depend on WHICH dims are involved,
    e.g. ICI-local vs DCN-crossing); a pinned ``final`` layout adds the exit
    transition priced at ``final_bytes`` (defaults to the last stage's
    bytes).  Mid-plan gathers never help for n > 1 (gather moves the full M
    over the group's bottleneck link, a direct switch only the re-tiled
    shard), so the state space stays on ``seq_dims``.  Ties break toward
    keeping the current shard, then the smaller dim, so uniform instances
    reproduce the greedy's plans.

    ``overlap`` ("chunked" | "double_buffer") prices each switch at its
    EXPOSED seconds — ``max(comm, hide) - hide`` with the hide budget from
    the consuming stage's ``Stage.compute_seconds`` (``_hide_seconds``) —
    so the DP prefers hiding a switch behind a long flash-attention stage
    over a cheap-but-exposed boundary.  Requires a topology to matter
    (exposure is a seconds concept); with ``overlap=None`` or no
    ``compute_seconds`` annotations the costs — and hence the plans — are
    bit-for-bit the synchronous ones.  The exit transition to ``final`` has
    no consuming kernel and stays fully exposed.
    """
    if not stages:
        return []
    _check_feasible(stages, seq_dims)
    _check_overlap(overlap)
    dims = list(seq_dims)
    INF = float("inf")

    nb0 = _boundary_bytes(stages, 0)
    h0 = _hide_seconds(stages, 0, overlap)
    cost: Dict[int, float] = {
        d: (_transition_cost(initial, d, nb0, n, topology, hide=h0)
            if initial is not None else 0.0) if stages[0].allows(d) else INF
        for d in dims}
    back: List[Dict[int, Optional[int]]] = []

    for t in range(1, len(stages)):
        nb = _boundary_bytes(stages, t)
        ht = _hide_seconds(stages, t, overlap)
        ncost: Dict[int, float] = {}
        bp: Dict[int, Optional[int]] = {}
        for d in dims:
            if not stages[t].allows(d):
                ncost[d], bp[d] = INF, None
                continue
            best, arg, best_key = INF, None, None
            for d0 in dims:
                c0 = cost[d0]
                if c0 == INF:
                    continue
                c = c0 + _transition_cost(d0, d, nb, n, topology, hide=ht)
                # tie-break: prefer keeping the shard, then the smaller dim
                key = (c, d0 != d, d0)
                if best_key is None or key < best_key:
                    best, arg, best_key = c, d0, key
            ncost[d], bp[d] = best, arg
        back.append(bp)
        cost = ncost

    if final is not None:
        fb = final_bytes if final_bytes is not None else _boundary_bytes(
            stages, len(stages) - 1)

        def total(d):
            return cost[d] + _transition_cost(d, final, fb, n, topology)
    else:
        def total(d):
            return cost[d]

    feas = [d for d in dims if cost[d] < INF]
    end = min(feas, key=lambda d: (total(d), d != final, d))
    plan = [end]
    for bp in reversed(back):
        plan.append(bp[plan[-1]])
    plan.reverse()
    return plan


def _overlap_active(stages: Sequence[Stage], topology,
                    overlap: Optional[str]) -> bool:
    """Overlap pricing changes edge weights only when a mode is requested,
    seconds are being priced (topology given), AND at least one stage has a
    compute estimate to hide behind — otherwise every hide budget is zero
    and the costs are the synchronous ones."""
    return (overlap is not None and topology is not None
            and any(st.compute_seconds for st in stages))


def make_plan(stages: Sequence[Stage], seq_dims: Sequence[int],
              *, n: int = 2, initial: Optional[int] = None,
              final: Optional[int] = None,
              final_bytes: Optional[float] = None,
              topology=None, overlap: Optional[str] = None) -> List[int]:
    """Dispatch: Belady greedy when it is provably optimal (uniform boundary
    costs — uniform bytes AND a cost-uniform topology — with a free final
    layout and no active overlap pricing), exact DP otherwise."""
    _check_overlap(overlap)
    topo_uniform = topology is None or topology.is_uniform
    if (final is None and topo_uniform and _uniform_cost(stages)
            and not _overlap_active(stages, topology, overlap)):
        return plan_switches(stages, seq_dims, initial)
    return plan_switches_dp(stages, seq_dims, n=n, initial=initial,
                            final=final, final_bytes=final_bytes,
                            topology=topology, overlap=overlap)


# ---------------------------------------------------------------------------
# Joint forward+backward planner (the round-trip stage graph)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JointPlan:
    """A solved round trip: one shard dim per stage for the forward pass and
    one per stage for the backward pass.

    ``fwd[t]`` is the layout stage ``t`` computes in; ``bwd[t]`` the layout
    the cotangent holds while stage ``t``'s BACKWARD computes (both listed
    in stage order).  The two legs meet at the *seam* — the loss boundary,
    where the forward exits to the pinned ``final`` layout and the cotangent
    is created in that same layout — and close at the entry: the forward
    enters from ``initial`` and the input gradient returns to ``initial``
    (the dataloader split owns both ends).

    ``mirrored`` is True when the backward simply retraces the forward
    (``bwd == fwd``) — the layout sequence autodiff transposition would
    produce, and the executor's default.  See docs/architecture.md §2.4.
    """

    fwd: Tuple[int, ...]
    bwd: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.fwd) == len(self.bwd), (len(self.fwd), len(self.bwd))

    @property
    def mirrored(self) -> bool:
        return self.fwd == self.bwd

    def to_dict(self) -> Dict:
        """JSON-safe form (checkpoint manifests record the plan a run was
        solved with so restore can re-solve — or compare — on any fabric)."""
        return {"kind": "joint", "fwd": list(self.fwd), "bwd": list(self.bwd)}

    @classmethod
    def from_dict(cls, d: Dict) -> "JointPlan":
        return cls(tuple(int(x) for x in d["fwd"]),
                   tuple(int(x) for x in d["bwd"]))


@dataclasses.dataclass(frozen=True)
class JointCost:
    """Round-trip cost split by leg (bytes, or seconds on a Topology).

    ``fwd``: the forward leg (entry from ``initial`` through every stage
    boundary to the ``final`` seam).  ``bwd``: the backward leg (seam,
    reverse boundaries, input-gradient exit back to ``initial``).
    ``couple``: residual re-shard penalty at stages whose backward layout
    deviates from the forward layout (zero under full rematerialisation —
    the recompute runs in the backward's own layout)."""

    fwd: float
    bwd: float
    couple: float = 0.0

    @property
    def total(self) -> float:
        return self.fwd + self.bwd + self.couple


def _bwd_leg_cost(stages: Sequence[Stage], fwd: Sequence[int],
                  bwd: Sequence[int], *, n: int, initial: Optional[int],
                  final: Optional[int], topology,
                  overlap: Optional[str] = None) -> float:
    """Cost of the cotangent's path: seam -> bwd[T-1] -> ... -> bwd[0] ->
    initial.  The gradient crossing boundary ``t`` is priced at stage
    ``t``'s ``bwd_nbytes`` (same boundary tensor as the forward, in
    gradient form).  With ``overlap`` each edge is priced at its exposed
    seconds against the consuming backward kernel (``_bwd_hide_seconds``);
    the input-gradient return to ``initial`` has no consumer and stays
    fully exposed."""
    if not bwd:
        return 0.0
    total = 0.0
    T = len(stages)
    # pinned seam: the cotangent is created in the loss layout (``final``
    # when pinned, else wherever the forward ended)
    seam = final if final is not None else fwd[-1]
    total += _transition_cost(seam, bwd[-1], _bwd_boundary_bytes(stages, T - 1),
                              n, topology,
                              hide=_bwd_hide_seconds(stages, T, overlap))
    for t in range(T - 1, 0, -1):
        total += _transition_cost(bwd[t], bwd[t - 1],
                                  _bwd_boundary_bytes(stages, t), n, topology,
                                  hide=_bwd_hide_seconds(stages, t, overlap))
    if initial is not None:
        # input gradient returns in the dataloader layout
        total += _transition_cost(bwd[0], initial,
                                  _bwd_boundary_bytes(stages, 0), n, topology)
    return total


def _couple_cost(stages: Sequence[Stage], t: int, f: int, b: int,
                 *, n: int, topology) -> float:
    """Residual re-shard penalty: without remat, stage ``t``'s saved
    activations sit in the forward layout ``f``; running its backward in
    ``b != f`` re-shards them (one switch of the stage's activation
    bytes)."""
    if f == b:
        return 0.0
    return _transition_cost(f, b, _boundary_bytes(stages, t), n, topology)


def _joint_cost(stages: Sequence[Stage], fwd: Sequence[int],
                bwd: Sequence[int], *, n: int, initial: Optional[int],
                final: Optional[int], final_bytes: Optional[float],
                topology, couple: bool,
                overlap: Optional[str] = None) -> JointCost:
    fc = _plan_cost(stages, fwd, n=n, initial=initial, final=final,
                    final_bytes=final_bytes, topology=topology,
                    overlap=overlap)
    bc = _bwd_leg_cost(stages, fwd, bwd, n=n, initial=initial, final=final,
                       topology=topology, overlap=overlap)
    cc = 0.0
    if couple:
        for t, (f, b) in enumerate(zip(fwd, bwd)):
            cc += _couple_cost(stages, t, f, b, n=n, topology=topology)
    return JointCost(fc, bc, cc)


def joint_cost_bytes(stages: Sequence[Stage], plan: JointPlan, *, n: int,
                     initial: Optional[int] = None,
                     final: Optional[int] = None,
                     final_bytes: Optional[float] = None,
                     couple: bool = False) -> JointCost:
    """Price a joint plan's round trip in paper-Table-2 per-device bytes.

    Args:
      stages: the stage sequence the plan was solved over.
      plan: the (fwd, bwd) layout assignment.
      n: SP degree (the Table-2 ``N``).
      initial/final: entry layout and pinned seam layout (None = free).
      final_bytes: bytes of the seam tensor (defaults to the last stage's).
      couple: include the residual re-shard penalty (no-remat execution).
    Returns:
      a ``JointCost`` with the fwd/bwd legs priced separately.
    """
    return _joint_cost(stages, plan.fwd, plan.bwd, n=n, initial=initial,
                       final=final, final_bytes=final_bytes, topology=None,
                       couple=couple)


def joint_cost_seconds(stages: Sequence[Stage], plan: JointPlan, topology, *,
                       initial: Optional[int] = None,
                       final: Optional[int] = None,
                       final_bytes: Optional[float] = None,
                       couple: bool = False,
                       overlap: Optional[str] = None) -> JointCost:
    """Price a joint plan's round trip in seconds on a ``Topology`` — the
    objective ``plan_joint`` minimises when a topology is given.  Same
    arguments as ``joint_cost_bytes``; ``overlap`` prices every switch at
    its EXPOSED seconds against the consuming kernel's
    ``Stage.compute_seconds``."""
    _check_overlap(overlap)
    return _joint_cost(stages, plan.fwd, plan.bwd, n=topology.size,
                       initial=initial, final=final, final_bytes=final_bytes,
                       topology=topology, couple=couple, overlap=overlap)


def plan_joint(stages: Sequence[Stage], seq_dims: Sequence[int], *,
               n: int = 2, initial: Optional[int] = None,
               final: Optional[int] = None,
               final_bytes: Optional[float] = None,
               topology=None, couple: bool = False,
               require_mirrored: bool = False,
               overlap: Optional[str] = None) -> JointPlan:
    """Solve the round trip exactly: DP over (stage, fwd_dim, bwd_dim).

    The forward leg prices boundary transitions exactly as
    ``plan_switches_dp``; the backward leg prices the cotangent's reverse
    path at each stage's ``bwd_nbytes`` with the seam pinned at the loss
    boundary (``final``) and the input gradient returning to ``initial``.
    With ``couple=True`` a stage whose backward layout deviates from its
    forward layout additionally pays one residual re-shard (saved-activation
    execution; leave False under full remat, where the recompute runs in the
    backward's own layout).

    The mirrored plan — forward-optimal layouts, backward retracing them,
    which is exactly what autodiff transposition executes — is always priced
    as the baseline and returned unless the joint DP finds a strictly
    cheaper round trip, so uniform instances reproduce the mirrored plan
    bit-for-bit.  Asymmetry that makes the DP win: per-stage fwd/bwd byte
    differences (``Stage.bwd_shape``/``bwd_dtype_bytes``), and non-uniform
    topologies whose switch costs are direction-dependent (per-dim link
    placements: leaving an ICI-local dim is cheaper than re-entering it).

    Args:
      stages: stage sequence (compute_dims constrain fwd and bwd alike).
      seq_dims: switchable sequence-dim indices.
      n: SP degree (byte model); ignored when ``topology`` is given.
      initial: entry layout; also pins the input-gradient exit.
      final: pinned seam (loss) layout; None couples the cotangent to the
        forward's exit layout instead.
      final_bytes: seam tensor bytes (defaults to the last stage's).
      topology: price in seconds on this mesh model instead of bytes.
      couple: charge residual re-shards when bwd deviates from fwd.
      require_mirrored: return the mirrored baseline without running the
        joint DP — for callers whose execution can only run the autodiff
        transpose (scanned model forwards), where a non-mirrored plan
        would be priced but never executed.
      overlap: price every switch at its EXPOSED seconds — forward edges
        hide behind the consuming stage's ``compute_seconds``
        (``_hide_seconds``), backward edges behind the consuming backward
        kernel (``_bwd_hide_seconds``) — so the round trip prefers
        boundaries the executor can hide.  No-op without a topology or
        without compute estimates.
    Returns:
      the optimal ``JointPlan`` (``.mirrored`` when the mirror was kept).
    """
    if not stages:
        return JointPlan((), ())
    _check_feasible(stages, seq_dims)
    _check_overlap(overlap)
    dims = list(seq_dims)
    T = len(stages)
    INF = float("inf")

    def cost_args(jp):
        return _joint_cost(stages, jp.fwd, jp.bwd, n=n, initial=initial,
                           final=final, final_bytes=final_bytes,
                           topology=topology, couple=couple,
                           overlap=overlap).total

    # mirrored baseline: the forward-optimal plan, backward retracing it
    mirror_fwd = tuple(plan_switches_dp(
        stages, dims, n=n, initial=initial, final=final,
        final_bytes=final_bytes, topology=topology, overlap=overlap))
    mirror = JointPlan(mirror_fwd, mirror_fwd)
    if require_mirrored:
        return mirror
    mirror_cost = cost_args(mirror)

    # exact DP over joint states (f, b); edges combine the forward edge
    # f0 -> f1 (bytes of boundary t), the backward edge b1 -> b0 (bwd bytes
    # of boundary t), and the per-state coupling penalty.
    def state_couple(t, f, b):
        if not couple:
            return 0.0
        return _couple_cost(stages, t, f, b, n=n, topology=topology)

    cost: Dict[Tuple[int, int], float] = {}
    for f in dims:
        for b in dims:
            if not (stages[0].allows(f) and stages[0].allows(b)):
                continue
            c = state_couple(0, f, b)
            if initial is not None:
                c += _transition_cost(initial, f, _boundary_bytes(stages, 0),
                                      n, topology,
                                      hide=_hide_seconds(stages, 0, overlap))
                # the input gradient's return has no consuming kernel
                c += _transition_cost(b, initial,
                                      _bwd_boundary_bytes(stages, 0),
                                      n, topology)
            cost[(f, b)] = c
    back: List[Dict[Tuple[int, int], Tuple[int, int]]] = []

    for t in range(1, T):
        fb = _boundary_bytes(stages, t)
        bb = _bwd_boundary_bytes(stages, t)
        fh = _hide_seconds(stages, t, overlap)
        bh = _bwd_hide_seconds(stages, t, overlap)
        ncost: Dict[Tuple[int, int], float] = {}
        bp: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for f1 in dims:
            if not stages[t].allows(f1):
                continue
            for b1 in dims:
                if not stages[t].allows(b1):
                    continue
                base = state_couple(t, f1, b1)
                best, arg, best_key = INF, None, None
                for (f0, b0), c0 in cost.items():
                    c = (c0 + base
                         + _transition_cost(f0, f1, fb, n, topology, hide=fh)
                         + _transition_cost(b1, b0, bb, n, topology, hide=bh))
                    # tie-break: prefer the mirror, then keeping both
                    # shards, then smaller dims — deterministic plans
                    key = (c, f0 != b0, f0 != f1, b0 != b1, f0, b0)
                    if best_key is None or key < best_key:
                        best, arg, best_key = c, (f0, b0), key
                if arg is not None:
                    ncost[(f1, b1)], bp[(f1, b1)] = best, arg
        back.append(bp)
        cost = ncost

    fbytes = final_bytes if final_bytes is not None else _boundary_bytes(
        stages, T - 1)
    bwd_fbytes = _bwd_boundary_bytes(stages, T - 1)

    seam_hide = _bwd_hide_seconds(stages, T, overlap)

    def seam_cost(f, b):
        if final is not None:
            # forward exit has no consuming kernel; the seam's cotangent
            # edge hides behind the last stage's backward
            return (_transition_cost(f, final, fbytes, n, topology)
                    + _transition_cost(final, b, bwd_fbytes, n, topology,
                                       hide=seam_hide))
        # free seam: the cotangent is created in the forward's exit layout
        return _transition_cost(f, b, bwd_fbytes, n, topology,
                                hide=seam_hide)

    best_state, best_key = None, None
    for (f, b), c in cost.items():
        total = c + seam_cost(f, b)
        key = (total, f != b, f != final, f, b)
        if best_key is None or key < best_key:
            best_state, best_key = (f, b), key
    if best_state is None:
        raise ValueError("infeasible stage sequence")

    states = [best_state]
    for bp in reversed(back):
        states.append(bp[states[-1]])
    states.reverse()
    dp = JointPlan(tuple(f for f, _ in states), tuple(b for _, b in states))
    dp_cost = cost_args(dp)

    # keep the mirrored plan unless the DP round trip is strictly cheaper
    if dp_cost < mirror_cost * (1.0 - 1e-12) - 1e-30:
        return dp
    return mirror


def brute_force_joint(stages: Sequence[Stage], seq_dims: Sequence[int], *,
                      n: int = 2, initial: Optional[int] = None,
                      final: Optional[int] = None,
                      final_bytes: Optional[float] = None,
                      topology=None, couple: bool = False,
                      overlap: Optional[str] = None) -> float:
    """Exponential exact minimum round-trip cost (test oracle only)."""
    best = None
    for fwd in itertools.product(seq_dims, repeat=len(stages)):
        if any(not st.allows(d) for st, d in zip(stages, fwd)):
            continue
        for bwd in itertools.product(seq_dims, repeat=len(stages)):
            if any(not st.allows(d) for st, d in zip(stages, bwd)):
                continue
            c = _joint_cost(stages, fwd, bwd, n=n, initial=initial,
                            final=final, final_bytes=final_bytes,
                            topology=topology, couple=couple,
                            overlap=overlap).total
            if best is None or c < best:
                best = c
    if best is None:
        raise ValueError("infeasible stage sequence")
    return best


# ---------------------------------------------------------------------------
# Plan pricing / oracles
# ---------------------------------------------------------------------------

def switch_count(plan: Sequence[int], initial: Optional[int] = None) -> int:
    """Number of layout switches a plan performs (entry from ``initial``
    counted when given; uniform-cost objective of the Belady greedy)."""
    count = 0
    prev = initial
    for d in plan:
        if prev is not None and d != prev:
            count += 1
        prev = d
    return count


def _plan_cost(stages: Sequence[Stage], plan: Sequence[int],
               *, n: int, initial: Optional[int], final: Optional[int],
               final_bytes: Optional[float], topology,
               overlap: Optional[str] = None) -> float:
    total = 0.0
    prev = initial
    for t, d in enumerate(plan):
        if prev is not None:
            total += _transition_cost(prev, d, _boundary_bytes(stages, t), n,
                                      topology,
                                      hide=_hide_seconds(stages, t, overlap))
        prev = d
    if final is not None and plan:
        fb = final_bytes if final_bytes is not None else _boundary_bytes(
            stages, len(stages) - 1)
        # exit to the pinned final layout has no consuming kernel
        total += _transition_cost(prev, final, fb, n, topology)
    return total


def plan_cost_bytes(stages: Sequence[Stage], plan: Sequence[int],
                    *, n: int, initial: Optional[int] = None,
                    final: Optional[int] = None,
                    final_bytes: Optional[float] = None) -> float:
    """Total per-device bytes of a plan under the Table-2 cost model — the
    same constant the executor and benchmarks use."""
    return _plan_cost(stages, plan, n=n, initial=initial, final=final,
                      final_bytes=final_bytes, topology=None)


def plan_cost_seconds(stages: Sequence[Stage], plan: Sequence[int],
                      topology, *, initial: Optional[int] = None,
                      final: Optional[int] = None,
                      final_bytes: Optional[float] = None,
                      overlap: Optional[str] = None) -> float:
    """Total seconds of a plan on a Topology (alpha+beta collective models)
    — what benchmarks report next to planned bytes, and the objective the
    topology-aware DP minimises.  With ``overlap`` the result is the plan's
    EXPOSED seconds (each switch discounted by the consuming stage's
    ``compute_seconds``); the difference vs ``overlap=None`` is the comm
    time the executor hides."""
    _check_overlap(overlap)
    return _plan_cost(stages, plan, n=topology.size, initial=initial,
                      final=final, final_bytes=final_bytes,
                      topology=topology, overlap=overlap)


def brute_force_plan(stages: Sequence[Stage], seq_dims: Sequence[int],
                     initial: Optional[int] = None) -> List[int]:
    """Exponential exact solver for switch COUNT (test oracle only)."""
    best, best_cost = None, None
    for assign in itertools.product(seq_dims, repeat=len(stages)):
        if any(not st.allows(d) for st, d in zip(stages, assign)):
            continue
        cost = switch_count(assign, initial)
        if best_cost is None or cost < best_cost:
            best, best_cost = list(assign), cost
    if best is None:
        raise ValueError("infeasible stage sequence")
    return best


def brute_force_cost(stages: Sequence[Stage], seq_dims: Sequence[int],
                     *, n: int = 2, initial: Optional[int] = None,
                     final: Optional[int] = None,
                     final_bytes: Optional[float] = None,
                     topology=None, overlap: Optional[str] = None) -> float:
    """Exponential exact minimum cost — bytes, or seconds on ``topology``
    (test oracle only)."""
    best = None
    for assign in itertools.product(seq_dims, repeat=len(stages)):
        if any(not st.allows(d) for st, d in zip(stages, assign)):
            continue
        c = _plan_cost(stages, assign, n=n, initial=initial,
                       final=final, final_bytes=final_bytes,
                       topology=topology, overlap=overlap)
        if best is None or c < best:
            best = c
    if best is None:
        raise ValueError("infeasible stage sequence")
    return best


# ---------------------------------------------------------------------------
# Unified SP plan space: (stage, dim, strategy) DP
# ---------------------------------------------------------------------------

# embedded candidates when Stage.strategies is None (the "dsp" resident
# strategy is always available at stages that allow the dim)
_EMBEDDED_STRATEGIES = ("ulysses", "ring", "megatron", "hybrid")


@dataclasses.dataclass(frozen=True)
class StrategyPlan:
    """A solved (dim, strategy) assignment per stage.

    ``dims[t]`` is the dim the residual stream is sharded on THROUGH stage
    ``t`` (the same meaning as the dim-only planners); ``strategies[t]`` is
    how the stage executes on that shard: ``"dsp"`` when the stage computes
    freely (the shard avoids its compute dims; boundary switches do the
    work), or an embedded strategy (``core.topology.STRATEGIES``) when the
    shard sits ON a compute dim and the stage pays in-stage collectives
    instead of re-sharding."""

    dims: Tuple[int, ...]
    strategies: Tuple[str, ...]

    def __post_init__(self):
        assert len(self.dims) == len(self.strategies)

    def to_dict(self) -> Dict:
        """JSON-safe form (see ``JointPlan.to_dict``)."""
        return {"kind": "strategy", "dims": list(self.dims),
                "strategies": list(self.strategies)}

    @classmethod
    def from_dict(cls, d: Dict) -> "StrategyPlan":
        return cls(tuple(int(x) for x in d["dims"]),
                   tuple(str(s) for s in d["strategies"]))


# ---------------------------------------------------------------------------
# Plan serialization (checkpoint manifests)
# ---------------------------------------------------------------------------

def plan_to_dict(plan) -> Dict:
    """Serialize any solved plan — a bare dim sequence, a ``JointPlan`` or a
    ``StrategyPlan`` — to a JSON-safe tagged dict.  ``train.checkpoint``
    stores this in the manifest next to the shards: DSP layouts are a
    planned property of the computation (paper §6), so the plan travels with
    the weights and the restoring host can re-solve or diff it on the new
    fabric."""
    if isinstance(plan, (JointPlan, StrategyPlan)):
        return plan.to_dict()
    plan = list(plan)
    if plan and isinstance(plan[0], (tuple, list)):
        return {"kind": "layout2d",
                "layouts": [[int(a), int(b)] for a, b in plan]}
    return {"kind": "dims", "dims": [int(d) for d in plan]}


def plan_from_dict(d: Dict):
    """Inverse of ``plan_to_dict`` (returns ``JointPlan`` / ``StrategyPlan``
    / ``list`` of dims by the recorded ``kind``)."""
    kind = d.get("kind")
    if kind == "joint":
        return JointPlan.from_dict(d)
    if kind == "strategy":
        return StrategyPlan.from_dict(d)
    if kind == "dims":
        return [int(x) for x in d["dims"]]
    if kind == "layout2d":
        return [(int(a), int(b)) for a, b in d["layouts"]]
    raise ValueError(f"unknown plan kind {kind!r}")


def _embedded_cost(stages: Sequence[Stage], t: int, d: int, strategy: str,
                   topology, overlap: Optional[str]) -> float:
    """Cost of executing stage ``t`` with the shard resident on ``d`` under
    ``strategy`` — 0 for "dsp" on a non-conflicting dim, the strategy's
    in-stage collectives (``Topology.embedded_seconds``) otherwise, INF when
    the combination is inadmissible (conflicting dim without an embedded
    strategy, byte-model pricing, partially-placed dim, hybrid on a
    single-axis group)."""
    INF = float("inf")
    st = stages[t]
    if strategy == "dsp":
        return 0.0 if st.allows(d) else INF
    if topology is None:
        return INF
    group = topology.group(d)
    if topology.group_size(d) < topology.size:
        return INF              # embedded SP computes across the whole group
    if strategy == "hybrid" and len(group) < 2:
        return INF
    c = (st.compute_seconds or 0.0) if overlap is not None else 0.0
    return topology.embedded_seconds(
        strategy, _boundary_bytes(stages, t), d,
        kv_bytes=st.kv_bytes, kv_heads=st.kv_heads, compute_seconds=c)


def _stage_candidates(stage: Stage) -> Tuple[str, ...]:
    emb = (stage.strategies if stage.strategies is not None
           else _EMBEDDED_STRATEGIES)
    return ("dsp",) + tuple(s for s in emb if s != "dsp")


def plan_strategy_dp(stages: Sequence[Stage], seq_dims: Sequence[int],
                     *, n: int = 2, initial: Optional[int] = None,
                     final: Optional[int] = None,
                     final_bytes: Optional[float] = None,
                     topology=None,
                     overlap: Optional[str] = None) -> StrategyPlan:
    """Exact minimum-cost plan over the UNIFIED SP plan space: DP over
    (stage, dim) where each stage additionally chooses the cheapest
    execution strategy for its resident dim — "dsp" (free) when the stage
    allows the dim, else the best embedded strategy
    (``Topology.embedded_seconds``: ulysses a2a / ring permute stream /
    megatron ag+rs / the USP ring x a2a hybrid).  Boundary transitions
    reuse the dim-only DP's edge weight (``_transition_cost``) and
    tie-breaks exactly.

    On ``topology=None`` or a UNIFORM topology this delegates wholesale to
    ``plan_switches_dp`` with every strategy "dsp" — the byte model stays
    the oracle and pre-strategy plans are reproduced bit-for-bit (the
    collapse property of tests/test_strategy_plan.py).  Embedded pricing is
    a seconds concept; it needs real links to compare against switches.

    ``overlap`` gives the inherently-pipelined permute streams (ring, the
    hybrid's outer ring) the stage's ``compute_seconds`` as a per-step hide
    budget; blocking strategies (ulysses/megatron) and the boundary
    transitions price exactly as in the dim-only DP.

    Returns a ``StrategyPlan``; raises ValueError when some stage admits no
    (dim, strategy) at all (every dim conflicted and no embedded strategy
    available).
    """
    if not stages:
        return StrategyPlan((), ())
    _check_overlap(overlap)
    if topology is None or topology.is_uniform:
        dims = plan_switches_dp(stages, seq_dims, n=n, initial=initial,
                                final=final, final_bytes=final_bytes,
                                topology=topology, overlap=overlap)
        return StrategyPlan(tuple(dims), ("dsp",) * len(dims))

    dims = list(seq_dims)
    INF = float("inf")

    def stage_best(t: int, d: int) -> Tuple[float, Optional[str]]:
        best, arg = INF, None
        for s in _stage_candidates(stages[t]):
            c = _embedded_cost(stages, t, d, s, topology, overlap)
            if c < best:
                best, arg = c, s
        return best, arg

    nb0 = _boundary_bytes(stages, 0)
    h0 = _hide_seconds(stages, 0, overlap)
    cost: Dict[int, float] = {}
    strat: List[Dict[int, Optional[str]]] = [{}]
    for d in dims:
        sc, sa = stage_best(0, d)
        if sc == INF:
            cost[d] = INF
            strat[0][d] = None
            continue
        c = (_transition_cost(initial, d, nb0, n, topology, hide=h0)
             if initial is not None else 0.0)
        c += sc
        cost[d] = c
        strat[0][d] = sa
    if all(cost[d] == INF for d in dims):
        raise ValueError(f"stage {stages[0].name!r} admits no "
                         f"(dim, strategy): every sequence dim conflicted "
                         f"and no embedded strategy available")
    back: List[Dict[int, Optional[int]]] = []

    for t in range(1, len(stages)):
        nb = _boundary_bytes(stages, t)
        ht = _hide_seconds(stages, t, overlap)
        ncost: Dict[int, float] = {}
        bp: Dict[int, Optional[int]] = {}
        sp: Dict[int, Optional[str]] = {}
        for d in dims:
            sc, sa = stage_best(t, d)
            if sc == INF:
                ncost[d], bp[d], sp[d] = INF, None, None
                continue
            best, arg, best_key = INF, None, None
            for d0 in dims:
                c0 = cost[d0]
                if c0 == INF:
                    continue
                c = c0 + _transition_cost(d0, d, nb, n, topology, hide=ht)
                c += sc
                # same tie-break as plan_switches_dp: keep shard, smaller dim
                key = (c, d0 != d, d0)
                if best_key is None or key < best_key:
                    best, arg, best_key = c, d0, key
            ncost[d], bp[d], sp[d] = best, arg, sa
        if all(ncost[d] == INF for d in dims):
            raise ValueError(f"stage {stages[t].name!r} admits no "
                             f"(dim, strategy): every sequence dim "
                             f"conflicted and no embedded strategy "
                             f"available")
        back.append(bp)
        strat.append(sp)
        cost = ncost

    if final is not None:
        fb = final_bytes if final_bytes is not None else _boundary_bytes(
            stages, len(stages) - 1)

        def total(d):
            return cost[d] + _transition_cost(d, final, fb, n, topology)
    else:
        def total(d):
            return cost[d]

    feas = [d for d in dims if cost[d] < INF]
    end = min(feas, key=lambda d: (total(d), d != final, d))
    plan = [end]
    for bp in reversed(back):
        plan.append(bp[plan[-1]])
    plan.reverse()
    return StrategyPlan(tuple(plan),
                        tuple(strat[t][d] for t, d in enumerate(plan)))


def strategy_plan_cost(stages: Sequence[Stage], plan: StrategyPlan,
                       *, n: int = 2, initial: Optional[int] = None,
                       final: Optional[int] = None,
                       final_bytes: Optional[float] = None,
                       topology=None,
                       overlap: Optional[str] = None) -> float:
    """Price a (dim, strategy) assignment with EXACTLY the DP's edge
    weights and accumulation order — the shared pricer of
    ``plan_strategy_dp`` and the brute-force oracle, so DP cost equals the
    oracle minimum with exact float equality.  INF for inadmissible
    assignments."""
    _check_overlap(overlap)
    total = 0.0
    prev = initial
    for t, (d, s) in enumerate(zip(plan.dims, plan.strategies)):
        if prev is not None:
            total += _transition_cost(prev, d, _boundary_bytes(stages, t), n,
                                      topology,
                                      hide=_hide_seconds(stages, t, overlap))
        total += _embedded_cost(stages, t, d, s, topology, overlap)
        prev = d
    if final is not None and plan.dims:
        fb = final_bytes if final_bytes is not None else _boundary_bytes(
            stages, len(stages) - 1)
        total += _transition_cost(prev, final, fb, n, topology)
    return total


def brute_force_strategy(stages: Sequence[Stage], seq_dims: Sequence[int],
                         *, n: int = 2, initial: Optional[int] = None,
                         final: Optional[int] = None,
                         final_bytes: Optional[float] = None,
                         topology=None,
                         overlap: Optional[str] = None
                         ) -> Tuple[float, StrategyPlan]:
    """Exponential exact minimum over the full (dim, strategy)^stages
    product (test oracle only).  Returns (cost, plan)."""
    choices = [[(d, s) for d in seq_dims for s in _stage_candidates(st)]
               for st in stages]
    best, best_plan = None, None
    for assign in itertools.product(*choices):
        plan = StrategyPlan(tuple(d for d, _ in assign),
                            tuple(s for _, s in assign))
        c = strategy_plan_cost(stages, plan, n=n, initial=initial,
                               final=final, final_bytes=final_bytes,
                               topology=topology, overlap=overlap)
        if c == float("inf"):
            continue
        if best is None or c < best:
            best, best_plan = c, plan
    if best_plan is None:
        raise ValueError("no admissible (dim, strategy) assignment")
    return best, best_plan


# ---------------------------------------------------------------------------
# 2D layouts (TSP fold): (d_out, d_in) pairs on an ("sp_out","sp_in") grid
# ---------------------------------------------------------------------------
#
# A 2D *layout* assigns one logical dim per mesh axis of a 2-axis SP grid
# (``launch.mesh.make_sp2d_mesh``): component 0 shards over the outer axis,
# component 1 over the inner axis.  The DIAGONAL layout ``(d, d)`` shards
# the single dim ``d`` jointly over both axes — the whole 1D machinery is
# the diagonal of this space, and on a degenerate ``(n, 1)`` / ``(1, n)``
# grid the 2D planner delegates wholesale to ``plan_switches_dp`` so plans
# and costs reproduce bit-for-bit (property-tested in tests/test_layout2d.py).
#
# Transitions decompose PER AXIS: an axis whose component is unchanged pays
# nothing, a changed axis pays one SUB-MESH collective over just that axis
# (all-to-all for a switch, all-gather for a gather) of the bytes visible to
# one fiber of the axis (M divided by the other axis' shard factor) — so a
# single-axis switch folds to exactly M/N per device, the same Table-2
# convention as the 1D switch.  Diagonal-to-diagonal transitions are priced
# as ONE full-group Table-2 primitive (that is what the executor runs), which
# is what makes the embedded 1D plans cost-identical.

def _as_pair(layout) -> Optional[Tuple[Optional[int], Optional[int]]]:
    """Normalize a layout argument: None stays None (free / unsharded),
    an int ``d`` lifts to the diagonal ``(d, d)``, a 2-tuple passes
    through."""
    if layout is None:
        return None
    if isinstance(layout, int):
        return (layout, layout)
    pair = tuple(layout)
    if len(pair) != 2:
        raise ValueError(f"2D layout must be a dim pair, got {layout!r}")
    return pair


def _pair_is_diagonal(pair) -> bool:
    return pair is not None and pair[0] == pair[1]


def pair_placement_equal(a, b, grid: Tuple[int, int]) -> bool:
    """True when two 2D layouts PLACE data identically on ``grid``:
    components over a size-1 axis shard nothing, so they are don't-cares
    (a degenerate-grid diagonal plan equals the 1D layout it collapsed
    to).  ``None`` layouts equal only other ``None`` layouts."""
    pa, pb = _as_pair(a), _as_pair(b)
    if pa is None or pb is None:
        return pa is None and pb is None
    return all(g <= 1 or x == y for g, x, y in zip(grid, pa, pb))


def pair_transition_kinds(src, tgt) -> Tuple[str, str]:
    """Per-axis Table-2 kinds of a 2D layout change (component k classified
    with the 1D ``transition_kind``).  Diagonal-to-diagonal changes are the
    joint case — both axes report the same kind and the pricer charges ONE
    full-group primitive, not two sub-mesh ones."""
    s = _as_pair(src) or (None, None)
    t = _as_pair(tgt) or (None, None)
    return (transition_kind(s[0], t[0]), transition_kind(s[1], t[1]))


def _pair_joint(src, tgt) -> bool:
    """True when the transition is diagonal-to-diagonal (including the
    unsharded ``None``): one full-group primitive covers both axes."""
    s = _as_pair(src) or (None, None)
    t = _as_pair(tgt) or (None, None)
    return s[0] == s[1] and t[0] == t[1]


def _fiber_factor(s, t, other: int, grid: Tuple[int, int]) -> int:
    """Shard factor the OTHER axis applies to the tensor while this axis
    re-tiles (``other`` indexes the other component): the other axis' grid
    size when it holds a sharded component, 1 when unsharded."""
    if s[other] is not None or t[other] is not None:
        return grid[other]
    return 1


def pair_transition_bytes(src, tgt, global_bytes: float,
                          grid: Tuple[int, int]) -> float:
    """Per-device bytes of one 2D layout transition.

    Joint (diagonal-to-diagonal) changes price as ONE full-group Table-2
    primitive over N = grid[0]*grid[1]; otherwise each changed axis pays
    its sub-mesh collective — switch = M/N (the fiber-visible M/s_other
    re-tiled over the axis), gather = the fiber-visible bytes every device
    ends with, keep/split = 0.
    """
    from repro_torch.core.dsp import comm_volume_bytes
    s = _as_pair(src) or (None, None)
    t = _as_pair(tgt) or (None, None)
    n = grid[0] * grid[1]
    if _pair_joint(src, tgt):
        return comm_volume_bytes(transition_kind(s[0], t[0]),
                                 global_bytes, n)
    total = 0.0
    for k in range(2):
        kind = transition_kind(s[k], t[k])
        if kind in ("keep", "split"):
            continue
        fiber = global_bytes / _fiber_factor(s, t, 1 - k, grid)
        if kind == "switch":
            total += fiber / grid[k]
        else:  # gather over this axis: every device ends with the fiber
            total += fiber
    return total


def pair_transition_seconds(src, tgt, global_bytes: float, topology) -> float:
    """Seconds of one 2D layout transition on a >=2-axis ``Topology`` whose
    axes map POSITIONALLY onto the grid (axis 0 = sp_out, 1 = sp_in).
    Joint changes price exactly as the 1D ``transition_seconds`` (one
    full-group primitive, per-dim placements honoured); per-axis changes
    pay one sub-mesh collective each (``Topology.axis_all_to_all_seconds``
    / ``axis_all_gather_seconds``)."""
    s = _as_pair(src) or (None, None)
    t = _as_pair(tgt) or (None, None)
    if _pair_joint(src, tgt):
        return topology.transition_seconds(transition_kind(s[0], t[0]),
                                           global_bytes, s[0], t[0])
    if len(topology.axes) < 2:
        raise ValueError(
            f"per-axis 2D transition {src!r} -> {tgt!r} needs a >=2-axis "
            f"topology; got {tuple(a.name for a in topology.axes)}")
    grid = (topology.axes[0].size, topology.axes[1].size)
    total = 0.0
    for k in range(2):
        kind = transition_kind(s[k], t[k])
        if kind in ("keep", "split"):
            continue
        fiber = global_bytes / _fiber_factor(s, t, 1 - k, grid)
        if kind == "switch":
            total += topology.axis_all_to_all_seconds(fiber, k)
        else:
            total += topology.axis_all_gather_seconds(fiber, k)
    return total


def _pair_cost(src, tgt, global_bytes: float, grid: Tuple[int, int],
               topology) -> float:
    """The one 2D edge weight: per-axis Table-2 bytes without a topology,
    per-axis sub-mesh seconds on one (the 2D analogue of
    ``_transition_cost``)."""
    if topology is None:
        return pair_transition_bytes(src, tgt, global_bytes, grid)
    return pair_transition_seconds(src, tgt, global_bytes, topology)


def _pair_changed_axes(src, tgt) -> int:
    s = _as_pair(src) or (None, None)
    t = _as_pair(tgt) or (None, None)
    return (s[0] != t[0]) + (s[1] != t[1])


def layout_allows(stage: Stage, layout, grid: Tuple[int, int]) -> bool:
    """Stage feasibility of a 2D layout: no component may sit on a compute
    dim, and each sharded dim's extent (``Stage.extents``, falling back to
    ``Stage.shape``) must divide by its total shard factor — the grid axis
    size per component, their product for the diagonal."""
    pair = _as_pair(layout)
    if pair is None:
        return True
    factors: Dict[int, int] = {}
    for k, d in enumerate(pair):
        if d is None:
            continue
        if not stage.allows(d):
            return False
        if grid[k] > 1:
            factors[d] = factors.get(d, 1) * grid[k]
    ext = stage.extents if stage.extents is not None else stage.shape
    if ext is not None:
        for d, f in factors.items():
            if d >= len(ext) or ext[d] % f != 0:
                return False
    return True


def _check_feasible_2d(stages: Sequence[Stage], layouts,
                       grid: Tuple[int, int]) -> None:
    for st in stages:
        if not any(layout_allows(st, lo, grid) for lo in layouts):
            raise ValueError(
                f"stage {st.name!r} admits no 2D layout on grid {grid}")


def _candidate_layouts(seq_dims: Sequence[int]) -> List[Tuple[int, int]]:
    """The DP state space: every ordered dim pair, diagonal included (the
    embedded 1D plans).  Mid-plan unsharded components never help for the
    same reason mid-plan gathers don't in 1D: the gather moves strictly
    more bytes than the switch it would replace."""
    return [(a, b) for a in seq_dims for b in seq_dims]


def _degenerate_component(pair, grid: Tuple[int, int]):
    """Collapse a pair to the component on the non-trivial axis of a
    degenerate grid (the other axis has size 1 — sharding over it is a
    no-op)."""
    if pair is None:
        return None
    k = 0 if grid[0] > 1 else 1
    return pair[k]


def plan_switches_2d(stages: Sequence[Stage], seq_dims: Sequence[int],
                     *, grid: Tuple[int, int],
                     initial=None, final=None,
                     final_bytes: Optional[float] = None,
                     topology=None) -> List[Tuple[int, int]]:
    """Exact minimum-cost 2D plan: DP over (stage, layout) where a layout
    is a dim pair over the ``("sp_out", "sp_in")`` grid.

    Transition into stage ``t`` is weighted by the bytes of the activation
    entering it, decomposed per axis (``pair_transition_bytes``; per-axis
    sub-mesh seconds on ``topology``, whose axes map positionally onto the
    grid).  Unchanged axes pay zero, so the DP naturally routes switches
    through single-axis changes when the fabric is asymmetric (a DCN outer
    axis makes outer changes expensive).  ``initial`` / ``final`` accept a
    pair, a bare dim (lifted to the diagonal) or None.

    On a degenerate grid — either axis of size 1 — this DELEGATES wholesale
    to ``plan_switches_dp`` and lifts its dims to diagonal pairs: the 1D
    planner stays the oracle and its plans/costs are reproduced bit-for-bit
    (the collapse property of tests/test_layout2d.py).

    Ties break toward the path with the fewest MULTI-axis boundaries (a
    single-axis change lowers to one clean sub-mesh all-to-all — the
    compiled contract the HLO tier pins — so equal-cost plans prefer
    spreading changes across boundaries), then toward fewer changed axes at
    this boundary, then the lexicographically smaller source layout —
    deterministic plans.
    """
    if len(grid) != 2 or grid[0] < 1 or grid[1] < 1:
        raise ValueError(f"grid must be two axis sizes >= 1, got {grid!r}")
    if not stages:
        return []
    ini, fin = _as_pair(initial), _as_pair(final)

    if grid[0] == 1 and grid[1] == 1:
        # Size-1 fabric: no transition moves any bytes, but the DP's M/N
        # convention still charges switches, so it minimizes switch COUNT —
        # and can save one by breaking the periodic tail.  All that matters
        # here is a stable layout per stage: greedy keep-else-smallest,
        # which stays periodic whenever the stage sequence is.
        plan1: List[int] = []
        prev1 = _degenerate_component(ini, grid)
        for st in stages:
            if prev1 is None or not st.allows(prev1):
                prev1 = min(d for d in seq_dims if st.allows(d))
            plan1.append(prev1)
        return [(d, d) for d in plan1]

    if grid[0] == 1 or grid[1] == 1:
        n = grid[0] * grid[1]
        plan = plan_switches_dp(
            stages, seq_dims, n=n,
            initial=_degenerate_component(ini, grid),
            final=_degenerate_component(fin, grid),
            final_bytes=final_bytes, topology=topology)
        return [(d, d) for d in plan]

    layouts = _candidate_layouts(seq_dims)
    _check_feasible_2d(stages, layouts, grid)
    INF = float("inf")

    def multi(src, tgt) -> int:
        # secondary objective: count boundaries changing BOTH axes (joint
        # diagonal moves are one full-group primitive, not a multi-axis
        # change)
        if _pair_joint(src, tgt):
            return 0
        return 1 if _pair_changed_axes(src, tgt) > 1 else 0

    nb0 = _boundary_bytes(stages, 0)
    cost: Dict[Tuple[int, int], float] = {}
    nmulti: Dict[Tuple[int, int], int] = {}
    for lo in layouts:
        if not layout_allows(stages[0], lo, grid):
            cost[lo] = INF
            nmulti[lo] = 0
            continue
        cost[lo] = (_pair_cost(ini, lo, nb0, grid, topology)
                    if ini is not None else 0.0)
        nmulti[lo] = multi(ini, lo) if ini is not None else 0
    back: List[Dict[Tuple[int, int], Optional[Tuple[int, int]]]] = []

    for t in range(1, len(stages)):
        nb = _boundary_bytes(stages, t)
        ncost: Dict[Tuple[int, int], float] = {}
        nm: Dict[Tuple[int, int], int] = {}
        bp: Dict[Tuple[int, int], Optional[Tuple[int, int]]] = {}
        for lo in layouts:
            if not layout_allows(stages[t], lo, grid):
                ncost[lo], nm[lo], bp[lo] = INF, 0, None
                continue
            best, bm, arg, best_key = INF, 0, None, None
            for lo0 in layouts:
                c0 = cost[lo0]
                if c0 == INF:
                    continue
                c = c0 + _pair_cost(lo0, lo, nb, grid, topology)
                m = nmulti[lo0] + multi(lo0, lo)
                key = (c, m, _pair_changed_axes(lo0, lo), lo0)
                if best_key is None or key < best_key:
                    best, bm, arg, best_key = c, m, lo0, key
            ncost[lo], nm[lo], bp[lo] = best, bm, arg
        back.append(bp)
        cost, nmulti = ncost, nm

    if fin is not None:
        fb = final_bytes if final_bytes is not None else _boundary_bytes(
            stages, len(stages) - 1)

        def total(lo):
            return (cost[lo] + _pair_cost(lo, fin, fb, grid, topology),
                    nmulti[lo] + multi(lo, fin))
    else:
        def total(lo):
            return (cost[lo], nmulti[lo])

    feas = [lo for lo in layouts if cost[lo] < INF]
    end = min(feas, key=lambda lo: (*total(lo), lo != fin, lo))
    plan = [end]
    for bp in reversed(back):
        plan.append(bp[plan[-1]])
    plan.reverse()
    return plan


def _plan2d_cost(stages: Sequence[Stage], plan, *, grid: Tuple[int, int],
                 initial, final, final_bytes: Optional[float],
                 topology) -> float:
    total = 0.0
    prev = _as_pair(initial)
    for t, lo in enumerate(plan):
        lo = _as_pair(lo)
        if prev is not None:
            total += _pair_cost(prev, lo, _boundary_bytes(stages, t),
                                grid, topology)
        prev = lo
    fin = _as_pair(final)
    if fin is not None and plan:
        fb = final_bytes if final_bytes is not None else _boundary_bytes(
            stages, len(stages) - 1)
        total += _pair_cost(prev, fin, fb, grid, topology)
    return total


def plan2d_cost_bytes(stages: Sequence[Stage], plan, *,
                      grid: Tuple[int, int], initial=None, final=None,
                      final_bytes: Optional[float] = None) -> float:
    """Total per-device bytes of a 2D plan under the per-axis Table-2 cost
    model (the 2D analogue of ``plan_cost_bytes``)."""
    return _plan2d_cost(stages, plan, grid=grid, initial=initial,
                        final=final, final_bytes=final_bytes, topology=None)


def plan2d_cost_seconds(stages: Sequence[Stage], plan, topology, *,
                        initial=None, final=None,
                        final_bytes: Optional[float] = None) -> float:
    """Total seconds of a 2D plan on a >=2-axis ``Topology`` (axes map
    positionally onto the grid; per-axis sub-mesh collectives)."""
    grid = (topology.axes[0].size,
            topology.axes[1].size if len(topology.axes) > 1 else 1)
    return _plan2d_cost(stages, plan, grid=grid, initial=initial,
                        final=final, final_bytes=final_bytes,
                        topology=topology)


def brute_force_plan2d(stages: Sequence[Stage], seq_dims: Sequence[int],
                       *, grid: Tuple[int, int], initial=None, final=None,
                       final_bytes: Optional[float] = None,
                       topology=None) -> float:
    """Exponential exact minimum 2D plan cost (test oracle only)."""
    layouts = _candidate_layouts(seq_dims)
    best = None
    for assign in itertools.product(layouts, repeat=len(stages)):
        if any(not layout_allows(st, lo, grid)
               for st, lo in zip(stages, assign)):
            continue
        c = _plan2d_cost(stages, assign, grid=grid, initial=initial,
                         final=final, final_bytes=final_bytes,
                         topology=topology)
        if best is None or c < best:
            best = c
    if best is None:
        raise ValueError("infeasible stage sequence")
    return best


# Canonical stage sequences ---------------------------------------------------

def transformer2d_stages(num_layers: int,
                         shape: Optional[Tuple[int, ...]] = None,
                         dtype_bytes: int = 2) -> List[Stage]:
    """The paper's OpenSora-like 2D DiT in the PAPER's ordering: per layer
    one temporal block (computes along dim T=1) then one spatial block
    (dim S=2); tensors are (B, T, S, C).

    NOTE: ``models/transformer2d.stages`` declares the sequence the repo's
    model actually EXECUTES (spatial first, matching its block order) —
    entry/exit switch placement differs between the two orderings, so use
    the model's declaration when pricing real runs; this builder exists for
    paper-faithful analysis and the planner tests."""
    out: List[Stage] = []
    for i in range(num_layers):
        out.append(Stage(frozenset({1}), f"layer{i}.temporal", shape,
                         dtype_bytes))
        out.append(Stage(frozenset({2}), f"layer{i}.spatial", shape,
                         dtype_bytes))
    return out


def lm_attention_stages(num_layers: int) -> List[Stage]:
    """Degenerate-1D LM: alternating attention (computes along seq=1,
    head dim 2 free) and channel-wise MLP (computes along none of the
    sequence dims).  Tensors treated as (B, S, H, D')."""
    out: List[Stage] = []
    for i in range(num_layers):
        out.append(Stage(frozenset({1}), f"layer{i}.attn"))
        out.append(Stage(frozenset(), f"layer{i}.mlp"))
    return out


def encdec_stages(n_enc_layers: int, n_dec_layers: int, *,
                  s_enc: Optional[int] = None, s_dec: Optional[int] = None,
                  batch: Optional[int] = None, d_model: Optional[int] = None,
                  dtype_bytes: int = 2,
                  grad_dtype_bytes: Optional[int] = None) -> List[Stage]:
    """Encoder-decoder stage graph on the logical (B, S, H·Dh) view:
    channel-wise stages (projections / FFN) compute along dim 2, attention
    cores along dim 1.  Encoder stages carry S_enc-sized tensors, decoder
    stages S_dec-sized — the asymmetry that makes the byte-weighted DP
    diverge from pure switch counting.  ``grad_dtype_bytes`` declares the
    gradient width for joint fwd+bwd planning (defaults to the activation
    dtype)."""
    def shp(s):
        if None in (s, batch, d_model):
            return None
        return (batch, s, d_model)

    gb = grad_dtype_bytes

    out: List[Stage] = []
    for i in range(n_enc_layers):
        out.append(Stage(frozenset({2}), f"enc{i}.proj", shp(s_enc),
                         dtype_bytes, bwd_dtype_bytes=gb))
        out.append(Stage(frozenset({1}), f"enc{i}.attn", shp(s_enc),
                         dtype_bytes, bwd_dtype_bytes=gb))
        out.append(Stage(frozenset({2}), f"enc{i}.mlp", shp(s_enc),
                         dtype_bytes, bwd_dtype_bytes=gb))
    for i in range(n_dec_layers):
        out.append(Stage(frozenset({2}), f"dec{i}.proj", shp(s_dec),
                         dtype_bytes, bwd_dtype_bytes=gb))
        out.append(Stage(frozenset({1}), f"dec{i}.self_attn", shp(s_dec),
                         dtype_bytes, bwd_dtype_bytes=gb))
        out.append(Stage(frozenset({1}), f"dec{i}.cross_attn", shp(s_dec),
                         dtype_bytes, bwd_dtype_bytes=gb))
        out.append(Stage(frozenset({2}), f"dec{i}.mlp", shp(s_dec),
                         dtype_bytes, bwd_dtype_bytes=gb))
    return out
