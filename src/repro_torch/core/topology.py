"""Topology-aware communication cost model: price DSP plans in SECONDS
(counterpart of ``repro.core.topology``, framework-free, copied whole
except for the JAX package's TPU link constants and the presets that
default to them: a ``Topology`` here is built from ``Link``s whose
bandwidth and latency the caller states, or fitted from timed collectives
by ``Topology.from_profile``).

The planner (``core.plan``) originally weighted stage-boundary transitions
with paper-Table-2 per-device *bytes* (switch = M/N, gather = M).  Bytes are
not time: an all-to-all over a slow DCN hop costs far more per byte than one
over ICI, which is exactly why hybrid sequence parallelism must be placed
topology-aware (USP, Fang & Zhao 2024) and why Ulysses reports its advantage
in link-bandwidth terms (Jacobs et al. 2023).  This module describes the
device mesh as *links* with per-link bandwidth/latency and prices the
paper's primitives with standard alpha+beta collective models.

Model
-----
A ``Topology`` is an ordered tuple of ``Link`` axes (outermost first); the
SP group is their product.  Each axis ``a`` has ``size`` s_a, ``bandwidth``
beta_a (bytes/s per device link) and ``latency`` alpha_a (seconds per hop).
For a collective over a sub-group G with N = prod s_a and global payload M:

  all-gather   (ring)        t = sum_a (s_a - 1) * alpha_a  +  M / min_a beta_a
  all-reduce   (ring RS+AG)  t = 2 * sum_a (s_a - 1) * alpha_a + 2M / min beta
  all-to-all   (tiled)       t = sum_a (s_a - 1) * alpha_a
                                 + sum_a (M/N) * phi_a / beta_a,
                             phi_a = N (s_a - 1) / (s_a (N - 1))

``phi_a`` is the wire-true fraction of a device's M/N shard whose peers
differ along axis ``a`` ((s_a-1)/s_a), renormalised by N/(N-1) so the
single-axis case folds to exactly M/N — the same Table-2 convention the
whole repo uses (``core.dsp.comm_volume_bytes`` counts the re-tiled shard,
not the on-wire (N-1)/N fraction, and HLO measurement uses result bytes).
Hierarchical groups therefore pay each axis phase sequentially, with the
slow (DCN) axis contributing its share at its own bandwidth.

Mapping to paper Table 2 (``transition_seconds``):

  keep    s_i -> s_i   : 0
  split   s_hat -> s_i : 0                         (local slice)
  switch  s_i -> s_j   : all_to_all_seconds(M, G)  (one tiled all-to-all)
  gather  s_i -> s_hat : all_gather_seconds(M, G)  (one all-gather)

``Topology.uniform(n)`` — one axis, bandwidth 1, latency 0 — makes every
transition *numerically equal to its Table-2 byte count*, so the byte model
is the uniform special case and all pre-topology plans are reproduced
bit-for-bit (property-tested in tests/test_topology.py).

Per-dim placement
-----------------
``placement`` optionally maps a logical sequence dim to the sub-axes that
shard it.  A dim placed on the inner ICI axis only (e.g. its extent divides
the per-host group but not the full pod) switches with ICI-local
all-to-alls; dims placed on the full (DCN x ICI) group pay the DCN share on
every switch.  This is what lets the DP *avoid switching across the slow
axis when an ICI-local dim is free* — the topology-aware regression in
tests/test_plan.py.  Switching between dims with different placements is
priced as an all-to-all over the union of both groups plus an all-gather of
the target shard over the axes that stop sharding (the tensor becomes
replicated along them).

"ICI" names a fast intra-node link and "DCN" a slow inter-node one; on an
H100 node they would be NVLink and the network.

The formula derivations, and how the planner consumes this model, are
walked through in docs/architecture.md §4.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

# Per-stage execution strategies the (stage, dim, strategy) DP searches over
# (``core.plan.plan_strategy_dp``).  "dsp" is the resident default — the
# shard sits on a dim the stage computes freely along, cost 0, with the
# stage-boundary transitions priced separately.  The EMBEDDED strategies run
# a stage whose compute dim IS the sharded dim without re-sharding the
# residual stream; ``Topology.embedded_seconds`` prices each one.
STRATEGIES = ("dsp", "ulysses", "ring", "megatron", "hybrid")


@dataclasses.dataclass(frozen=True)
class Link:
    """One mesh axis: ``size`` devices connected by links of ``bandwidth``
    bytes/s and ``latency`` seconds per hop (the alpha term)."""

    name: str
    size: int
    bandwidth: float
    latency: float = 0.0

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"axis {self.name!r}: size {self.size} < 1")
        if self.bandwidth <= 0:
            raise ValueError(f"axis {self.name!r}: bandwidth must be > 0")


@dataclasses.dataclass(frozen=True)
class Topology:
    """Device-mesh communication model for one SP group.

    ``axes``: ordered outermost-first (the DCN axis, when present, comes
    first).  ``placement``: optional map from logical sequence dim to the
    tuple of axis names sharding that dim; dims absent from the map (and all
    dims when ``placement`` is None) shard over the full group.
    """

    axes: Tuple[Link, ...]
    placement: Optional[Mapping[int, Tuple[str, ...]]] = None

    def __post_init__(self):
        names = [a.name for a in self.axes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names {names}")
        if self.placement:
            for dim, grp in self.placement.items():
                for nm in grp:
                    if nm not in names:
                        raise ValueError(
                            f"placement of dim {dim} names unknown axis "
                            f"{nm!r} (have {names})")
            # frozen dataclass + dict field: freeze to a hashable view
            object.__setattr__(self, "placement",
                               {d: tuple(g) for d, g in
                                sorted(self.placement.items())})

    # -- group selection -----------------------------------------------------

    @property
    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= a.size
        return n

    def axis(self, name: str) -> Link:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(name)

    def group(self, dim: Optional[int]) -> Tuple[Link, ...]:
        """Axes sharding logical dim ``dim`` (full group by default)."""
        if dim is None or not self.placement or dim not in self.placement:
            return self.axes
        names = self.placement[dim]
        return tuple(a for a in self.axes if a.name in names)

    def group_size(self, dim: Optional[int]) -> int:
        n = 1
        for a in self.group(dim):
            n *= a.size
        return n

    def _select(self, axes) -> Tuple[Link, ...]:
        if axes is None:
            return self.axes
        out = []
        for a in axes:
            out.append(a if isinstance(a, Link) else self.axis(a))
        return tuple(out)

    @property
    def is_uniform(self) -> bool:
        """True when every transition cost is a fixed multiple of its byte
        count: one effective link class, no latency, no per-dim placement."""
        return (not self.placement
                and len({(a.bandwidth, a.latency) for a in self.axes}) == 1
                and all(a.latency == 0.0 for a in self.axes))

    @property
    def bottleneck_bandwidth(self) -> float:
        return min(a.bandwidth for a in self.axes)

    # -- alpha+beta collective models ----------------------------------------

    @staticmethod
    def _alpha(group: Tuple[Link, ...]) -> float:
        return sum((a.size - 1) * a.latency for a in group)

    def all_gather_seconds(self, nbytes: float, axes=None) -> float:
        """Ring all-gather of a globally ``nbytes`` tensor over the group:
        every device ends with the full M (Table-2 gather convention).

        Args:
          nbytes: global tensor bytes (M).
          axes: sub-group as Link objects or axis names (full group when
            None).
        Returns:
          seconds (0.0 for a 1-device group).  docs/architecture.md §4.
        """
        group = self._select(axes)
        n = 1
        for a in group:
            n *= a.size
        if n <= 1:
            return 0.0
        return self._alpha(group) + nbytes / min(a.bandwidth for a in group)

    def all_reduce_seconds(self, nbytes: float, axes=None) -> float:
        """Ring all-reduce = reduce-scatter + all-gather: 2M over the
        bottleneck link (the same 2x convention roofline's HLO parser
        applies to all-reduce result bytes)."""
        group = self._select(axes)
        n = 1
        for a in group:
            n *= a.size
        if n <= 1:
            return 0.0
        return (2 * self._alpha(group)
                + 2 * nbytes / min(a.bandwidth for a in group))

    def reduce_scatter_seconds(self, nbytes: float, axes=None) -> float:
        """Ring reduce-scatter of a globally ``nbytes`` tensor: every device
        sends its full M partial and keeps the reduced M/N shard — same
        alpha+beta shape as the all-gather it mirrors (Megatron-SP's block
        exit; ``core.megatron_sp``).

        Args:
          nbytes: global tensor bytes (M).
          axes: sub-group as Link objects or axis names (full group when
            None).
        Returns:
          seconds (0.0 for a 1-device group).
        """
        group = self._select(axes)
        n = 1
        for a in group:
            n *= a.size
        if n <= 1:
            return 0.0
        return self._alpha(group) + nbytes / min(a.bandwidth for a in group)

    def ring_seconds(self, nbytes: float, axes=None) -> float:
        """N-step ring stream of a globally ``nbytes`` tensor
        (``core.overlap.ring_stream``: fixed perm ``i -> i+1``, N hops of
        M/N).  Unlike the phase-decomposed collectives, every hop crosses
        the SAME fixed neighbour pairs, so each step is gated by the slowest
        link on the ring — per-step cost ``max_a(alpha_a + (M/N)/beta_a)``,
        not a per-axis sum.  On a uniform topology this folds to exactly M
        (N steps x M/N), the Table-3 ring byte count.

        Args:
          nbytes: global tensor bytes of the streamed blocks (K+V for ring
            attention).
          axes: sub-group as Link objects or axis names (full group when
            None).
        Returns:
          SYNCHRONOUS seconds of the full stream (0.0 for a 1-device
          group); the per-step overlap with fold compute is applied by
          ``embedded_seconds``.
        """
        group = self._select(axes)
        n = 1
        for a in group:
            n *= a.size
        if n <= 1:
            return 0.0
        step = max(a.latency + (nbytes / n) / a.bandwidth for a in group)
        return n * step

    def all_to_all_seconds(self, nbytes: float, axes=None) -> float:
        """Tiled all-to-all re-tiling each device's M/N shard.  Hierarchical
        groups pay one phase per axis; phi_a folds the single-axis case to
        exactly M/N (see module docstring and docs/architecture.md §4).

        Args:
          nbytes: global tensor bytes (M).
          axes: sub-group as Link objects or axis names (full group when
            None).
        Returns:
          seconds (0.0 for a 1-device group).
        """
        group = self._select(axes)
        n = 1
        for a in group:
            n *= a.size
        if n <= 1:
            return 0.0
        shard = nbytes / n
        t = self._alpha(group)
        for a in group:
            if a.size == 1:
                continue
            phi = n * (a.size - 1) / (a.size * (n - 1))
            t += shard * phi / a.bandwidth
        return t

    def seconds_for_bytes(self, nbytes: float) -> float:
        """Price an already-counted per-device collective byte volume at the
        bottleneck link (the roofline collective term)."""
        return nbytes / self.bottleneck_bandwidth

    # -- per-axis (sub-mesh) pricing: 2D layouts ----------------------------

    def axis_link(self, index: int) -> Link:
        """The mesh axis at POSITION ``index`` (outermost first).  2D
        layouts map their grid axes positionally onto the topology — index
        0 is the ``sp_out`` (slow/outer) axis, index 1 ``sp_in`` — so
        per-axis sub-mesh collectives are keyed by position, not name."""
        if not 0 <= index < len(self.axes):
            raise IndexError(
                f"axis index {index} out of range for "
                f"{tuple(a.name for a in self.axes)}")
        return self.axes[index]

    def axis_all_to_all_seconds(self, nbytes: float, index: int) -> float:
        """Tiled all-to-all over ONE mesh axis (a sub-mesh collective: the
        other axes' coordinates are fixed, so the groups are the axis'
        fibers).  ``nbytes`` is the bytes VISIBLE to one fiber — the global
        tensor divided by the shard factor of the other axes; callers that
        switch one component of a 2D layout pass M / s_other, so the
        per-device volume folds to exactly M/N (the Table-2 convention,
        same as the full-group switch)."""
        return self.all_to_all_seconds(nbytes, (self.axis_link(index),))

    def axis_all_gather_seconds(self, nbytes: float, index: int) -> float:
        """Ring all-gather over ONE mesh axis (fiber sub-groups; see
        ``axis_all_to_all_seconds`` for the ``nbytes`` convention)."""
        return self.all_gather_seconds(nbytes, (self.axis_link(index),))

    # -- paper Table-2 transitions -------------------------------------------

    def switch_seconds(self, nbytes: float, src: int, tgt: int) -> float:
        """s_i -> s_j: one tiled all-to-all over the dims' shard group.
        Different placements re-tile over the union of both groups and
        additionally all-gather the target shard over axes that stop
        sharding (the tensor becomes replicated along them)."""
        gs, gt = self.group(src), self.group(tgt)
        if gs == gt:
            return self.all_to_all_seconds(nbytes, gs)
        in_either = {a.name for a in gs} | {a.name for a in gt}
        union = tuple(a for a in self.axes if a.name in in_either)
        t = self.all_to_all_seconds(nbytes, union)
        dropped = tuple(a for a in union if a not in gt)
        if dropped:
            n_tgt = 1
            for a in gt:
                n_tgt *= a.size
            t += self.all_gather_seconds(nbytes / n_tgt, dropped)
        return t

    def gather_seconds(self, nbytes: float, src: int) -> float:
        return self.all_gather_seconds(nbytes, self.group(src))

    def transition_seconds(self, kind: str, nbytes: float,
                           src: Optional[int], tgt: Optional[int]) -> float:
        """Seconds of one Table-2 primitive (same kinds as
        ``core.dsp.comm_volume_bytes``).

        Args:
          kind: "keep" | "split" | "switch" | "gather".
          nbytes: global tensor bytes (M).
          src/tgt: logical dims involved (select the placement groups).
        Returns:
          seconds; raises ValueError on an unknown kind.
        """
        if kind in ("keep", "split"):
            return 0.0
        if kind == "switch":
            return self.switch_seconds(nbytes, src, tgt)
        if kind == "gather":
            return self.gather_seconds(nbytes, src)
        raise ValueError(f"unknown primitive {kind!r}")

    def exposed_seconds(self, kind: str, nbytes: float,
                        src: Optional[int], tgt: Optional[int], *,
                        compute_seconds: float = 0.0) -> float:
        """Seconds of one Table-2 primitive that stay EXPOSED when the
        transition overlaps with ``compute_seconds`` of kernel compute:
        ``max(comm, compute) - compute``.

        Only switches decompose into per-shard ``ppermute`` chunks
        (``core.overlap.overlapped_switch``), so only they hide; gathers and
        the free kinds price as ``transition_seconds``.  With
        ``compute_seconds=0`` this IS ``transition_seconds`` — the overlap-
        aware planner (``core.plan``, ``overlap=`` arguments) reduces to the
        synchronous cost model whenever no compute estimate is attached.

        Args:
          kind: "keep" | "split" | "switch" | "gather".
          nbytes: global tensor bytes (M).
          src/tgt: logical dims involved (select the placement groups).
          compute_seconds: kernel seconds the transition can hide behind
            (per-stage estimates come from
            ``analysis.roofline.stage_compute_seconds``).
        Returns:
          exposed seconds (>= 0).
        """
        comm = self.transition_seconds(kind, nbytes, src, tgt)
        if kind != "switch" or compute_seconds <= 0.0:
            return comm
        return max(comm, compute_seconds) - compute_seconds

    # -- embedded strategy pricing (the (stage, dim, strategy) DP) -----------

    def embedded_seconds(self, strategy: str, nbytes: float,
                         dim: Optional[int], *,
                         kv_bytes: Optional[float] = None,
                         kv_heads: Optional[int] = None,
                         compute_seconds: float = 0.0) -> float:
        """Seconds a stage pays to compute along the SHARDED dim ``dim``
        with an embedded SP strategy instead of DSP-switching off it.
        Prices the strategy's in-stage collectives on the dim's shard group
        (same alpha+beta models as the Table-2 transitions), with the
        overlap each strategy structurally provides:

          dsp       0 — the stage computes freely; boundary transitions
                    price the switches (``transition_seconds``).
          ulysses   2 a2a of the stream (q in, out back) + 2 a2a of K/V —
                    or 2 ALL-GATHERS of K/V when ``kv_heads`` does not
                    divide over the group (GQA: too few heads to scatter).
                    Blocking collectives: never hides.
          ring      ``ring_seconds`` of the K/V blocks; each ppermute hop
                    overlaps the fold compute (``core.overlap.ring_stream``
                    is inherently pipelined), so with a compute budget c
                    the exposed cost is N * max(step - c/N, 0).
          megatron  2 x (all-gather + reduce-scatter) of the full stream
                    (attention and MLP halves; ``core.megatron_sp``).
                    Blocking: never hides.
          hybrid    USP (arxiv 2405.07719) on a >=2-axis group: Ulysses-
                    style a2a of host-local shards INSIDE the inner axes +
                    ring K/V stream ACROSS the outer (DCN) axis.  The inner
                    a2as block; the outer ring hops hide like "ring".

        Args:
          strategy: one of ``STRATEGIES``.
          nbytes: global bytes of the residual stream (M).
          dim: logical dim the shard sits on (selects the placement group).
            Embedded strategies parallelise the stage's compute across the
            whole SP group, so a dim placed on a strict sub-group cannot
            host one — raises ValueError (callers skip such candidates).
          kv_bytes: global bytes of the K/V activations streamed by
            ring/hybrid and scattered by ulysses (default 2M, the MHA
            convention of Table 3).
          kv_heads: K/V head count, for the GQA divisibility of head-
            scattering strategies (None = divisible, the MHA default).
          compute_seconds: per-device kernel seconds of the stage, the hide
            budget of the inherently-overlapped permute streams (0 under
            ``overlap=None`` — synchronous pricing).
        Returns:
          exposed seconds (>= 0); 0.0 for a 1-device group.
        """
        group = self.group(dim)
        n = 1
        for a in group:
            n *= a.size
        if strategy == "dsp":
            return 0.0
        if n <= 1:
            return 0.0
        if n < self.size:
            raise ValueError(
                f"embedded strategy {strategy!r} on dim {dim}: placement "
                f"group {tuple(a.name for a in group)} is a strict "
                f"sub-group ({n} < {self.size}); embedded SP computes "
                f"across the whole group")
        kv = float(kv_bytes) if kv_bytes is not None else 2.0 * nbytes
        c = max(compute_seconds, 0.0)

        def kv_scatter(sub, n_sub, kv_local):
            # q/out a2as always scatter (q heads = model heads, divisible by
            # construction of the mesh); K/V falls back to replication when
            # GQA leaves fewer heads than devices
            if kv_heads is None or kv_heads % n_sub == 0:
                return 2.0 * self.all_to_all_seconds(kv_local / 2.0, sub)
            return 2.0 * self.all_gather_seconds(kv_local / 2.0, sub)

        if strategy == "ulysses":
            return (2.0 * self.all_to_all_seconds(nbytes, group)
                    + kv_scatter(group, n, kv))
        if strategy == "ring":
            step = max(a.latency + (kv / n) / a.bandwidth for a in group)
            return n * max(step - c / n, 0.0)
        if strategy == "megatron":
            return 2.0 * (self.all_gather_seconds(nbytes, group)
                          + self.reduce_scatter_seconds(nbytes, group))
        if strategy == "hybrid":
            if len(group) < 2:
                raise ValueError(
                    "hybrid strategy needs a >=2-axis group (outer ring x "
                    f"inner a2a); dim {dim} shards over "
                    f"{tuple(a.name for a in group)}")
            outer, inner = group[0], group[1:]
            h = outer.size
            p = n // h
            inner_t = (2.0 * self.all_to_all_seconds(nbytes / h, inner)
                       + kv_scatter(inner, p, kv / h))
            step = outer.latency + (kv / n) / outer.bandwidth
            return inner_t + h * max(step - c / h, 0.0)
        raise ValueError(f"unknown strategy {strategy!r} "
                         f"(have {STRATEGIES})")

    # -- elastic resize ------------------------------------------------------

    def resized(self, n: int) -> "Topology":
        """Best-effort model of the same fabric at SP degree ``n`` (elastic
        serving resize).  One axis absorbs the change while the others keep
        their sizes — axis names and per-dim placements survive, so
        ICI-local pinnings keep steering the re-plan.  The innermost axis is
        tried first (shrinking within a host models dropping chips), but
        never down to size 1 when an OUTER axis can shrink instead: a 4x2
        DCN x ICI fabric resized to 4 is exactly two 2-chip hosts (2x2),
        not four isolated chips whose every link is DCN.  Only when no
        single-axis resize divides does the group collapse to one flat axis
        at the bottleneck bandwidth (placements become meaningless there: a
        single axis IS the full group, which is every dim's default)."""
        if n == self.size:
            return self
        if n < 1:
            raise ValueError(f"resized({n})")
        # candidate order: innermost axis first; a resize that would
        # degenerate a >1-sized axis to 1 is deferred to the second pass so
        # an exact multi-axis model wins over an effectively-flat one
        order = range(len(self.axes) - 1, -1, -1)
        for allow_degenerate in (False, True):
            for i in order:
                others = 1
                for j, a in enumerate(self.axes):
                    if j != i:
                        others *= a.size
                if n % others != 0:
                    continue
                q = n // others
                if q == 1 and self.axes[i].size > 1 and not allow_degenerate:
                    continue
                resized_axis = dataclasses.replace(self.axes[i], size=q)
                axes = (self.axes[:i] + (resized_axis,)
                        + self.axes[i + 1:])
                return Topology(axes, placement=self.placement)
        slowest = min(self.axes, key=lambda a: a.bandwidth)
        return Topology((dataclasses.replace(slowest, size=n),))

    # -- serialization (checkpoint manifests, portable fitted fabrics) -------

    def to_dict(self) -> Dict:
        """JSON-safe description of the fabric: per-link axes + per-dim
        placement.  Covers ``from_profile`` fits too — a fitted fabric is
        just a Link with measured bandwidth/latency — which is what makes a
        checkpoint manifest portable across machines: the restoring host
        re-solves the plan on the SAME fabric model the run was priced on
        (``train.checkpoint`` records this next to the shards)."""
        return {
            "axes": [{"name": a.name, "size": a.size,
                      "bandwidth": a.bandwidth, "latency": a.latency}
                     for a in self.axes],
            "placement": ({str(d): list(g)
                           for d, g in self.placement.items()}
                          if self.placement else None),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Topology":
        """Inverse of ``to_dict`` — bit-exact round trip (JSON floats are
        doubles, so measured bandwidths/latencies survive unchanged)."""
        axes = tuple(Link(a["name"], int(a["size"]), float(a["bandwidth"]),
                          float(a.get("latency", 0.0))) for a in d["axes"])
        placement = d.get("placement")
        if placement:
            placement = {int(k): tuple(v) for k, v in placement.items()}
        else:
            placement = None
        return cls(axes, placement=placement)

    # -- presets -------------------------------------------------------------

    @classmethod
    def uniform(cls, n: int, bandwidth: float = 1.0,
                latency: float = 0.0) -> "Topology":
        """The byte model as a topology: with the defaults (bandwidth 1,
        latency 0) every transition costs exactly its Table-2 byte count, so
        plans solved on it reproduce the byte-uniform plans bit-for-bit."""
        return cls((Link("sp", n, bandwidth, latency),))

    @classmethod
    def from_profile(cls, n: int,
                     samples: Sequence[Tuple[float, float]],
                     name: str = "measured") -> "Topology":
        """Fit a single-axis alpha+beta model from measured collectives.

        ``samples``: (global_bytes, seconds) pairs from timed all-gathers
        over the n-device group.  Least-squares fit of t = a + M/beta gives
        per-hop latency a/(n-1) and link bandwidth beta — the measured
        counterpart of the datasheet presets.
        """
        if n < 2:
            raise ValueError("from_profile needs a group of >= 2 devices")
        if len(samples) < 2:
            raise ValueError("from_profile needs >= 2 (bytes, seconds) "
                             "samples")
        xs = [float(b) for b, _ in samples]
        ys = [float(t) for _, t in samples]
        k = len(xs)
        mx, my = sum(xs) / k, sum(ys) / k
        sxx = sum((x - mx) ** 2 for x in xs)
        if sxx == 0:
            raise ValueError("from_profile samples must vary in bytes")
        slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
        if slope <= 0:
            raise ValueError(
                f"non-physical fit: seconds must grow with bytes "
                f"(slope {slope:.3e})")
        intercept = max(my - slope * mx, 0.0)
        return cls((Link(name, n, 1.0 / slope, intercept / (n - 1)),))


def plan_seconds(topology: Topology, kinds_bytes: Sequence[Tuple[str, float,
                                                                 Optional[int],
                                                                 Optional[int]]]
                 ) -> float:
    """Sum transition_seconds over (kind, bytes, src, tgt) tuples."""
    return sum(topology.transition_seconds(k, b, s, t)
               for k, b, s, t in kinds_bytes)


__all__ = [
    "Link", "Topology", "plan_seconds", "STRATEGIES",
]
