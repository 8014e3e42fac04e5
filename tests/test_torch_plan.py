"""The port's switching planner (``repro_torch.core.plan``, ``.topology``,
``.schedule``) against the JAX package's, on the CPU.

Both are pure Python over the same arithmetic, so every comparison is
exact (tolerance 0): on seeded random stage graphs every planner gives the
same plan and the same cost in both packages, with and without a
``Topology`` built from the same ``Link``s on both sides (the JAX
package's TPU presets are not ported; the links here state their own
bandwidth and latency).  Then the ``Schedule`` views and accounting, the
plan serialisation, the DiT's ``stages``/``dsp_schedule`` over a grid of
shapes (transformer2d-720m at n = 1 and 4 over 16 x 4096 among them), and
the train CLI's plan (priced in bytes) against JAX's (priced on its ICI
preset)."""
import types

import numpy as np
import pytest

from repro.configs import transformer2d_720m as jc720
from repro.core import plan as JP
from repro.core import schedule as JS
from repro.core import topology as JTopo
from repro.launch.mesh import mesh_topology
from repro.models import transformer2d as JT
from repro_torch.configs import transformer2d_720m as tc720
from repro_torch.core import plan as TP
from repro_torch.core import schedule as TS
from repro_torch.core import topology as TTopo
from repro_torch.models import transformer2d as TT
from _torch_threads import one_thread  # noqa: E402,F401

PACKAGES = {"jax": (JP, JTopo), "torch": (TP, TTopo)}


# ---------------------------------------------------------------------------
# Seeded instances, built the same on both sides
# ---------------------------------------------------------------------------

def _instance(seed: int, *, two_d: bool = False):
    """A random stage graph as plain specs: (dims, stage kwargs, initial,
    final)."""
    rng = np.random.RandomState(seed)
    n_dims = 3 if two_d else int(rng.randint(2, 4))
    dims = list(range(1, 1 + n_dims))
    specs = []
    for i in range(int(rng.randint(2, 7))):
        forbid = rng.choice(dims, size=int(rng.randint(0, n_dims)),
                            replace=False)
        kw = {"compute_dims": frozenset(int(d) for d in forbid),
              "name": f"s{i}"}
        if rng.rand() < 0.8:
            # on the 2D grid (2, 4) every extent divides by both factors
            sizes = [8, 16, 32] if two_d else [2, 4, 8, 16, 32]
            shape = tuple(int(v) for v in rng.choice(sizes, size=n_dims + 2))
            kw.update(shape=shape, dtype_bytes=int(rng.choice([2, 4])))
            if rng.rand() < 0.4:
                kw["bwd_dtype_bytes"] = 4
            nbytes = float(np.prod(shape)) * kw["dtype_bytes"]
            kw["kv_bytes"] = nbytes * float(rng.choice([0.5, 1.0, 2.0]))
            kw["kv_heads"] = int(rng.choice([1, 2, 8]))
            if two_d:
                kw["extents"] = shape[:-1] + (8,)
        specs.append(kw)
    initial = int(rng.choice(dims)) if rng.rand() < 0.7 else None
    final = initial if rng.rand() < 0.5 else None
    return dims, specs, initial, final


def _links(topo_mod, seed: int, placed: bool):
    """A two-tier fabric (2 hosts of 4 over a slow link) from stated
    values, the same on both sides; optionally one dim pinned inside a
    host."""
    rng = np.random.RandomState(1000 + seed)
    axes = (topo_mod.Link("dcn", 2, 2.5e9, 1e-5),
            topo_mod.Link("ici", 4, 5e10, 1e-6))
    placement = {int(rng.choice([1, 2, 3])): ("ici",)} if placed else None
    return topo_mod.Topology(axes, placement=placement)


def _stages(plan_mod, specs):
    return [plan_mod.Stage(**kw) for kw in specs]


def _solve(planner, pkg, seed, topo_kind):
    plan_mod, topo_mod = PACKAGES[pkg]
    two_d = planner == "plan_switches_2d"
    dims, specs, initial, final = _instance(seed, two_d=two_d)
    st = _stages(plan_mod, specs)
    topo = (None if topo_kind == "none"
            else _links(topo_mod, seed, topo_kind == "placed"))
    if planner == "plan_switches":
        plan = plan_mod.plan_switches(st, dims, initial=initial)
        return plan, plan_mod.plan_cost_bytes(st, plan, n=8, initial=initial)
    kw = dict(initial=initial, final=final, topology=topo)
    if planner == "plan_switches_2d":
        if topo is not None:
            topo = topo_mod.Topology(topo.axes)      # axes map onto the grid
        init2 = None if initial is None else (initial, initial)
        plan = plan_mod.plan_switches_2d(st, dims, grid=(2, 4),
                                         initial=init2, topology=topo)
        cost = (plan_mod.plan2d_cost_bytes(st, plan, grid=(2, 4),
                                           initial=init2)
                if topo is None else plan_mod.plan2d_cost_seconds(
                    st, plan, topo, initial=init2))
        return plan, cost
    if planner in ("plan_switches_dp", "make_plan"):
        plan = getattr(plan_mod, planner)(st, dims, n=8, **kw)
        cost = (plan_mod.plan_cost_bytes(st, plan, n=8, initial=initial,
                                         final=final)
                if topo is None else plan_mod.plan_cost_seconds(
                    st, plan, topo, initial=initial, final=final))
        return plan, cost
    if planner == "plan_joint":
        jp = plan_mod.plan_joint(st, dims, n=8, **kw)
        cost = (plan_mod.joint_cost_bytes(st, jp, n=8, initial=initial,
                                          final=final)
                if topo is None else plan_mod.joint_cost_seconds(
                    st, jp, topo, initial=initial, final=final))
        return (jp.fwd, jp.bwd), (cost.fwd, cost.bwd, cost.total)
    if planner == "plan_strategy_dp":
        sp = plan_mod.plan_strategy_dp(st, dims, n=8, **kw)
        cost = plan_mod.strategy_plan_cost(st, sp, n=8, **kw)
        return (sp.dims, sp.strategies), cost
    raise ValueError(planner)


PLANNER_CASES = (
    [("plan_switches", s, "none") for s in range(4)]
    + [(p, s, t) for p in ("plan_switches_dp", "make_plan", "plan_joint",
                           "plan_strategy_dp", "plan_switches_2d")
       for s in range(4) for t in ("none", "tiered", "placed")])


@pytest.mark.parametrize("planner,seed,topo_kind", PLANNER_CASES)
def test_planner_parity(planner, seed, topo_kind):
    """Equal plans and equal costs, exactly."""
    want = _solve(planner, "jax", seed, topo_kind)
    got = _solve(planner, "torch", seed, topo_kind)
    assert got == want


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

def test_topology_parity():
    """Every pricing function, the resize, the serialisation and the fit,
    on the same links in both packages."""
    out = {}
    for pkg, (_, tm) in PACKAGES.items():
        res = []
        for placed in (False, True):
            topo = _links(tm, 3, placed)
            for nb in (1e3, 7.5e6, 3.2e9):
                res += [topo.all_gather_seconds(nb),
                        topo.all_reduce_seconds(nb),
                        topo.reduce_scatter_seconds(nb),
                        topo.ring_seconds(nb),
                        topo.all_to_all_seconds(nb),
                        topo.all_to_all_seconds(nb, ("ici",)),
                        topo.axis_all_to_all_seconds(nb, 1),
                        topo.axis_all_gather_seconds(nb, 0),
                        topo.seconds_for_bytes(nb)]
                for s, t in ((1, 2), (2, 3), (3, 1)):
                    res += [topo.switch_seconds(nb, s, t),
                            topo.gather_seconds(nb, s),
                            topo.exposed_seconds("switch", nb, s, t,
                                                 compute_seconds=1e-4)]
                for strat in tm.STRATEGIES:
                    res.append(topo.embedded_seconds(
                        strat, nb, None, kv_bytes=nb / 2, kv_heads=2,
                        compute_seconds=1e-5))
            res += [topo.is_uniform, topo.bottleneck_bandwidth, topo.size,
                    topo.resized(4).to_dict(), topo.resized(3).to_dict(),
                    tm.Topology.from_dict(topo.to_dict()) == topo,
                    tm.plan_seconds(topo, [("switch", 1e6, 1, 2),
                                           ("gather", 2e6, 2, None),
                                           ("keep", 1e6, 1, 1)])]
        res += [tm.Topology.uniform(4).all_to_all_seconds(64.0),
                tm.Topology.from_profile(
                    4, [(1e6, 1e-4), (4e6, 2.5e-4), (1.6e7, 8.1e-4)]
                ).to_dict()]
        out[pkg] = res
    assert out["torch"] == out["jax"]
    assert not hasattr(TTopo, "ICI_BW")
    assert not hasattr(TTopo.Topology, "flat_ici")


# ---------------------------------------------------------------------------
# Schedules: views, accounting, serialisation
# ---------------------------------------------------------------------------

def _schedule_facts(sched_mod, plan_mod, sched, n):
    """Everything a consumer reads off a Schedule, as plain values."""
    def tr(t):
        return (t.kind, t.src, t.tgt, t.collective)

    facts = {"dims": sched.dims, "bwd": sched.bwd_plan,
             "mirrored": sched.mirrored,
             "transitions": [tr(t) for t in sched.transitions()],
             "bwd_transitions": [tr(t) for t in sched.bwd_transitions()],
             "collectives": sched.expected_collectives(),
             "switches": sched.n_switches(),
             "bytes": sched.per_device_bytes(n),
             "roundtrip": tuple(vars(sched.roundtrip_bytes(n)).values()),
             "dict": plan_mod.plan_to_dict(list(sched.dims)),
             "joint_dict": plan_mod.plan_to_dict(sched.joint())}
    for kind in ("dict", "joint_dict"):
        back = plan_mod.plan_from_dict(facts[kind])
        facts[kind + "_back"] = (list(back) if isinstance(back, list)
                                 else (back.fwd, back.bwd))
    try:
        ps = sched.periodic(2)
        facts["view"] = ("periodic", tr(ps.enter()), tr(ps.wrap()),
                         tr(ps.exit()), ps.dims)
        n_periods = len(sched.dims) // 2
    except ValueError:
        ps = sched.unrolled()
        facts["view"] = ("unrolled", tr(ps.enter()), tr(ps.exit()),
                         [tr(ps.boundary(t)) for t in range(1, ps.n_stages)])
        n_periods = 1
    facts["executor"] = _executor(sched_mod, ps).expected_collectives(
        n_periods)
    return facts


def _executor(sched_mod, psched):
    """An explicit executor, for its accounting only."""
    return sched_mod.ScheduleExecutor(psched, backend="explicit")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("solver", ["plan_schedule", "plan_joint_schedule",
                                    "plan_strategy_schedule"])
def test_schedule_parity(solver, seed):
    """The same solved Schedule in both packages: dims, transitions both
    ways, the periodic or unrolled view, collective counts (the schedule's
    and the explicit executor's), per-device bytes and round-trip costs,
    and plan_to_dict / plan_from_dict round trips."""
    out = {}
    for pkg, sched_mod in (("jax", JS), ("torch", TS)):
        plan_mod = PACKAGES[pkg][0]
        rng = np.random.RandomState(seed)
        shape = (2, 8, int(rng.choice([4, 8, 64])), 16)
        pair = [plan_mod.Stage(frozenset({2}), "sp", shape, 2),
                plan_mod.Stage(frozenset({1}), "tp", shape, 2,
                               bwd_dtype_bytes=int(rng.choice([2, 4])))]
        stages = pair * int(rng.randint(1, 4))
        sched = getattr(sched_mod, solver)(stages, [1, 2], n=4, initial=1,
                                           final=1 if seed % 2 else None)
        out[pkg] = _schedule_facts(sched_mod, plan_mod, sched, 4)
        out[pkg]["strategies"] = sched.strategies
        if solver == "plan_strategy_schedule":
            sp = plan_mod.StrategyPlan(sched.dims, sched.strategies)
            back = plan_mod.plan_from_dict(plan_mod.plan_to_dict(sp))
            out[pkg]["strategy_back"] = (back.dims, back.strategies)
    assert out["torch"] == out["jax"]


def test_schedule2d_parity():
    """The 2D schedule classes: layouts, per-axis collective counts, bytes
    and the periodic view, on a (2, 4) grid."""
    out = {}
    for pkg, sched_mod in (("jax", JS), ("torch", TS)):
        plan_mod = PACKAGES[pkg][0]
        shape, ext = (2, 8, 16, 64), (2, 8, 16, 4)
        period = [plan_mod.Stage(frozenset({2}), "sa", shape, 2, extents=ext),
                  plan_mod.Stage(frozenset({3}), "sm", shape, 2, extents=ext),
                  plan_mod.Stage(frozenset({1}), "ta", shape, 2, extents=ext),
                  plan_mod.Stage(frozenset({3}), "tm", shape, 2, extents=ext)]
        # one period with entry = exit, as the DiT's dsp2d_schedule solves
        s2 = sched_mod.plan2d_schedule(period, [1, 2, 3], grid=(2, 4),
                                       initial=(1, 2), final=(1, 2))
        ps = s2.periodic(4)
        out[pkg] = (s2.layouts,
                    [(t.src, t.tgt, t.kind, t.joint, t.collective_counts())
                     for t in s2.transitions()],
                    s2.expected_collectives(), s2.per_device_bytes(),
                    ps.layouts, ps.wrap().kind,
                    sched_mod.classify2(1, 2).axis_kinds)
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# The DiT's stages and schedules, and the train CLI's plan
# ---------------------------------------------------------------------------

SMOKE_T2D = dict(name="t", n_layers=4, d_model=64, n_heads=4, d_ff=128,
                 in_dim=16)


def _dit_cfgs(which):
    if which == "720m":
        return jc720.CONFIG, tc720.CONFIG
    import jax.numpy as jnp
    import torch
    return (JT.T2DConfig(**SMOKE_T2D, dtype=jnp.float32),
            TT.T2DConfig(**SMOKE_T2D, dtype=torch.float32))


@pytest.mark.parametrize("which,n,t_len,s_len,batch,joint", [
    ("720m", 1, 16, 4096, 1, False), ("720m", 1, 16, 4096, 1, True),
    ("720m", 4, 16, 4096, 1, False), ("720m", 4, 16, 4096, 1, True),
    ("720m", 8, 128, 4096, 32, True), ("smoke", 4, 8, 16, 2, False),
    ("smoke", 2, 8, 16, 2, True), ("smoke", 4, 8, 4, 1, True)])
def test_dit_schedule_parity(which, n, t_len, s_len, batch, joint):
    """``stages`` and ``dsp_schedule`` give the same stages, plan and
    executor counts in both packages; at every grid point the DiT pays
    exactly 2 all-to-alls per layer pair."""
    jcfg, tcfg = _dit_cfgs(which)
    kw = dict(t_len=t_len, s_len=s_len, batch=batch)
    assert TT.stages(tcfg, **kw) == [
        TP.Stage(**vars(s)) for s in JT.stages(jcfg, **kw)]
    out = {}
    for pkg, mod, cfg, sched_mod in (("jax", JT, jcfg, JS),
                                     ("torch", TT, tcfg, TS)):
        ps = mod.dsp_schedule(cfg, n, joint=joint, **kw)
        plan_mod = PACKAGES[pkg][0]
        out[pkg] = _schedule_facts(sched_mod, plan_mod, ps.schedule, n)
        out[pkg]["view_type"] = type(ps).__name__
    assert out["torch"] == out["jax"]
    pairs = tcfg.n_layers // 2
    assert out["torch"]["executor"] == {"all-to-all": 2 * pairs}


@pytest.mark.parametrize("which", ["720m", "smoke"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 4), (2, 2)])
def test_cli_plan_matches_jax(which, mesh_shape):
    """The port's train CLI plans in bytes (``topology=None``); the JAX CLI
    prices the same plan on ``mesh_topology(mesh, "ici")``, its TPU
    preset.  On the DiT both give the same joint schedule."""
    jcfg, tcfg = _dit_cfgs(which)
    dp, mp = mesh_shape
    batch, spatial = 8, 16
    mesh = types.SimpleNamespace(shape={"data": dp, "model": mp})
    want = JT.dsp_schedule(jcfg, mp, t_len=8, s_len=spatial, batch=batch,
                           topology=mesh_topology(mesh, "ici"), joint=True)
    got = TT.dsp_schedule(tcfg, mp, t_len=8, s_len=spatial, batch=batch,
                          topology=None, joint=True)
    assert type(got).__name__ == type(want).__name__
    assert got.schedule.dims == want.schedule.dims
    assert got.schedule.bwd_plan == want.schedule.bwd_plan
    assert got.schedule.mirrored
    assert _executor(TS, got).expected_collectives(tcfg.n_layers // 2) == \
        _executor(JS, want).expected_collectives(jcfg.n_layers // 2)


def test_executor_refuses_what_has_no_counterpart():
    """``backend="auto"`` has no PyTorch counterpart; the explicit backend
    takes ``overlap`` (given, or carried by the schedule) and runs the
    mirrored backward only, as in JAX."""
    ps = TT.dsp_schedule(_dit_cfgs("smoke")[1], 4, t_len=8, s_len=16,
                         batch=2)
    with pytest.raises(NotImplementedError, match="no PyTorch counterpart"):
        TS.ScheduleExecutor(ps, backend="auto", ctx=object())
    assert TS.ScheduleExecutor(ps, backend="explicit", ctx=object(),
                               overlap="chunked").overlap == "chunked"
    with pytest.raises(ValueError, match="needs a ParallelContext"):
        TS.ScheduleExecutor(ps, backend="explicit").wrap(object())
    swapped = TS.Schedule(ps.schedule.stages, ps.schedule.dims, initial=1,
                          final=1, bwd_dims=tuple(3 - d for d in
                                                  ps.schedule.dims))
    with pytest.raises(ValueError, match="mirrored backward only"):
        TS.ScheduleExecutor(swapped.unrolled(), backend="explicit",
                            ctx=object())
    carried = TT.dsp_schedule(_dit_cfgs("smoke")[1], 4, t_len=8, s_len=16,
                              batch=2, overlap="chunked")
    assert TS.ScheduleExecutor(carried, backend="explicit",
                               ctx=object()).overlap == "chunked"
    null = TS.ScheduleExecutor.null()
    x = object()
    assert null.enter(x) is x and null.boundary(x, 1) is x
    assert null.wrap(x) is x and null.exit(x) is x
    assert null.expected_collectives() == {}
