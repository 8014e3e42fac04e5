"""The port's 2D layouts (``forward2d`` over dim pairs on the ``("sp_out",
"sp_in")`` grid, run by the explicit ``ScheduleExecutor2D``) against the
JAX package's on the CPU: 8 gloo processes (``tests/_torch_l2d_worker.py``)
on one ``FileStore``, and the JAX side on 8 simulated devices in a
subprocess (``tests/_torch_l2d_jax.py``).

Configs (``_torch_l2d_jax.configs``): ``t`` is the ``layout2d_t2d``
scenario's DiT (4 blocks, d 32, 4 heads, f32) from JAX's init with every
block's modulation drawn from seeded normals, ``t6`` the same at 6
blocks; ``fold`` is
``comm_volume.py``'s TSP-fold instance (T 4, S 12, 4 heads, no
modulation) at d 32.  Bars, each stated where it is checked: the plans,
stage orders and collective counts are exact; ``forward2d`` within 1e-5
of the largest |value| of JAX's ``forward2d`` (f32, sums in another
order); the gradient of mean(out²) within 2e-2 of each leaf's max (the
grad bar of ``chip_smoke.py``); single transitions move values exactly."""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import schedule as JS
from repro.core.plan import layout_allows
from repro.models import transformer2d as JT
from repro_torch import bridge
from repro_torch.core import dsp
from repro_torch.core import schedule as TS
from repro_torch.core.layout import from_mesh
from repro_torch.core.schedule import classify2
from repro_torch.models import transformer2d as TT

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_l2d_jax import CASES, HLO_KINDS, configs  # noqa: E402
from _torch_l2d_worker import KINDS, TRANSITIONS  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

WORLD = 8
# case -> (B, T, S) of its input
SHAPES = {"x24": (2, 4, 8), "x18": (2, 8, 8), "x22": (2, 16, 16),
          "xf": (2, 4, 12)}
# transformer2d-720m's plans at chip_smoke's grids (1 x 16 x 4096)
DIT_GRIDS = ((1, 1), (2, 2), (1, 4), (4, 1))


def _cfgs():
    return ({k: TT.T2DConfig(**kw) for k, kw in configs(torch.float32).items()},
            {k: JT.T2DConfig(**kw) for k, kw in configs(jnp.float32).items()})


def _params(name):
    """JAX's init of config ``name`` as numpy, with the modulation of
    ``t`` drawn from seeded normals (adaLN-zero makes each block the
    identity)."""
    cfg = _cfgs()[1][name]
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_t2d(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(100)
    for kind in ("spatial", "temporal"):
        if not cfg.modulate:
            break
        proj = tree["layers"][kind]["mod"]["proj"]
        d = proj["w"].shape[-2]
        proj["w"] = (rng.standard_normal(proj["w"].shape)
                     * 0.5 / np.sqrt(d)).astype(np.float32)
        proj["b"] = (rng.standard_normal(proj["b"].shape)
                     * 0.1).astype(np.float32)
    return tree


def _inputs():
    rng = np.random.RandomState(2)
    f32 = np.float32
    out = {k: rng.standard_normal(shape + (16 if k == "xf" else 8,))
           .astype(f32) for k, shape in SHAPES.items()}
    out["t"] = rng.rand(2).astype(f32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 8 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("l2d"))
    params = {name: _params(name) for name in configs(jnp.float32)}
    inputs = _inputs()
    for name, tree in params.items():
        np.savez(os.path.join(work, f"params_{name}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(8),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_l2d_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_l2d_worker.py"),
                            str(r), str(WORLD), work]
    procs, logs = {}, {}
    try:
        for name, cmd in cmds.items():
            logs[name] = open(os.path.join(work, f"{name}.log"), "w+")
            procs[name] = subprocess.Popen(cmd, env=env, stdout=logs[name],
                                           stderr=subprocess.STDOUT)
        for p in procs.values():
            p.wait(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        logs[name].seek(0)
        text = logs[name].read()
        logs[name].close()
        assert p.returncode == 0, f"{name} failed:\n{text[-4000:]}"
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(WORLD)]
    return {"params": params, "inputs": inputs, "ranks": ranks,
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


def _calls(rank, name):
    return {k: n for k, n in zip(KINDS, rank[f"{name}/calls"].tolist()) if n}


def _schedules(cname, grid, b, t, s):
    tcfg, jcfg = (c[cname] for c in _cfgs())
    kw = dict(t_len=t, s_len=s, batch=b)
    return (TT.dsp2d_schedule(tcfg, grid, **kw),
            JT.dsp2d_schedule(jcfg, grid, **kw))


def _jax_carry(cname, grid, b, t, s):
    """JAX's ``expected_carry_collectives`` of one forward."""
    ps = _schedules(cname, grid, b, t, s)[1]
    return JS.ScheduleExecutor2D(ps, backend="null") \
        .expected_carry_collectives(_cfgs()[1][cname].n_layers // 2)


def _case_plan(case):
    cname, xname, (p_out, p_in, _) = CASES[case]
    return (cname, (p_out, p_in)) + SHAPES[xname]


# ---------------------------------------------------------------------------
# The plans, in one process
# ---------------------------------------------------------------------------

PLAN_CASES = ({case: _case_plan(case) for case in CASES}
              | {f"dit{g[0]}x{g[1]}": ("dit", g, 1, 16, 4096)
                 for g in DIT_GRIDS})


def _dit_cfgs():
    from repro.configs import transformer2d_720m as JC
    from repro_torch.configs import transformer2d_720m as TC
    return TC.CONFIG, JC.CONFIG


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plans_match_jax(case):
    """``stages2d`` and ``dsp2d_schedule`` give JAX's stages, layouts and
    planned bytes, and the 2D executor's accounting (``expected_*``) JAX's
    counts, at every grid the CPU tests and ``chip_smoke.py`` run."""
    cname, grid, b, t, s = PLAN_CASES[case]
    if cname == "dit":
        tcfg, jcfg = _dit_cfgs()
        kw = dict(t_len=t, s_len=s, batch=b)
        tp, jp = (TT.dsp2d_schedule(tcfg, grid, **kw),
                  JT.dsp2d_schedule(jcfg, grid, **kw))
        tst, jst = TT.stages2d(tcfg, **kw), JT.stages2d(jcfg, **kw)
    else:
        tp, jp = _schedules(cname, grid, b, t, s)
        tc, jc = (c[cname] for c in _cfgs())
        tst = TT.stages2d(tc, t_len=t, s_len=s, batch=b)
        jst = JT.stages2d(jc, t_len=t, s_len=s, batch=b)
    assert [(st.name, st.compute_dims, st.shape, st.extents, st.dtype_bytes)
            for st in tst] == [(st.name, st.compute_dims, st.shape,
                                st.extents, st.dtype_bytes) for st in jst]
    assert tp.layouts == jp.layouts and tp.period == jp.period == 4
    assert tp.schedule.layouts == jp.schedule.layouts
    assert tp.schedule.per_device_bytes() == jp.schedule.per_device_bytes()
    te = TS.ScheduleExecutor2D(tp, backend="null")
    je = JS.ScheduleExecutor2D(jp, backend="null")
    n = len(tst) // 4
    assert te.expected_collectives(n) == je.expected_collectives(n)
    assert te.expected_carry_collectives(n) == \
        je.expected_carry_collectives(n)


def test_the_plans_this_slice_runs():
    """The layouts the checks below and ``chip_smoke.py`` phase 15 hold the
    port to, and their all-to-alls per forward: (2, 4) mixes single-axis
    switches (8 at 2 periods), (1, 8) and (1, 1) are joint (6), (2, 2)
    takes 3 a period (9 at 3); the DiT at (1, 1) plans 2 x 14 + 2 = 30,
    at (2, 2) 3 x 14 = 42."""
    want = {"g24": ((1, 3), (1, 2), (2, 2), (1, 2)),
            "g18": ((1, 1), (2, 2), (2, 2), (2, 2)),
            "g11": ((1, 1), (1, 1), (2, 2), (2, 2)),
            "g222": ((1, 1), (2, 2), (2, 2), (1, 2))}
    counts = {"g24": 8, "g18": 6, "g11": 6, "g222": 9}
    for case, layouts in want.items():
        assert _schedules(*_case_plan(case))[0].layouts == layouts
        assert _jax_carry(*_case_plan(case)) == {"all-to-all": counts[case]}
    tcfg = _dit_cfgs()[0]
    for grid, n in (((1, 1), 30), ((2, 2), 42), ((1, 4), 30), ((4, 1), 30)):
        ps = TT.dsp2d_schedule(tcfg, grid, t_len=16, s_len=4096, batch=1)
        assert TS.ScheduleExecutor2D(ps, backend="null") \
            .expected_carry_collectives(14) == {"all-to-all": n}


def test_stage_orders():
    """Where JAX's ``_stage_order`` fixes a diagonal's order (a single-axis
    entry) the port's is the same; where JAX's leaves it free the port's
    takes the order the diagonal's single-axis exit needs: the DiT at
    (2, 2) enters (2, 2) jointly and leaves it over ``sp_out``, so its
    run is ``sp_in`` major, where JAX numbers it ``sp_out`` major and XLA
    pays a permute for it."""
    tp, jp = _schedules(*_case_plan("g24"))
    got = [TS.ScheduleExecutor2D(tp, backend="null")._stage_order(i)
           for i in range(4)]
    assert got == [JS.ScheduleExecutor2D(jp, backend="null")._stage_order(i)
                   for i in range(4)] == [(0, 1), (0, 1), (1, 0), (0, 1)]
    tp, jp = _schedules(*_case_plan("g222"))
    assert [TS.ScheduleExecutor2D(tp, backend="null")._stage_order(i)
            for i in range(4)] == [(0, 1), (1, 0), (1, 0), (0, 1)]
    assert [JS.ScheduleExecutor2D(jp, backend="null")._stage_order(i)
            for i in range(4)] == [(0, 1)] * 4


def test_fold_instance_needs_dim_pairs():
    """No dim of the TSP-fold instance divides 8 ways, so no diagonal (1D)
    layout fits any stage on the (2, 4) grid; the 2D plan shards every
    stage 8 ways over two dims."""
    jcfg = _cfgs()[1]["fold"]
    stages = JT.stages2d(jcfg, t_len=4, s_len=12, batch=2)
    assert not any(layout_allows(st, (d, d), (2, 4))
                   for st in stages for d in (1, 2, 3))
    tp, _ = _schedules(*_case_plan("fold"))
    assert tp.layouts == ((1, 3), (1, 2), (3, 2), (1, 2))


# ---------------------------------------------------------------------------
# forward2d over 8 gloo ranks against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "g11"))
def test_forward2d_matches_jax(runs, case):
    """``make_spmd_forward2d`` takes the global batch on every rank and
    returns the rank's shard at the plan's final layout; gathered, it
    matches JAX's ``forward2d`` within 1e-5 of the largest |value|.  Every
    rank issues exactly JAX's ``expected_carry_collectives`` (the
    all-to-alls) and nothing else."""
    want = runs["jax"][case]
    expected = _jax_carry(*_case_plan(case))
    for rank in runs["ranks"]:
        got = rank[case]
        assert got.shape == want.shape
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 1e-5, rel
        assert _calls(rank, case) == expected


def test_jax_forward2d_departs_from_its_accounting_at_2x2(runs):
    """Why the port moves the stream itself into and out of a core that
    keeps C whole, and issues every counted switch.  At (2, 2) (3 periods;
    the residual at (2, 2) after the spatial block, at (1, 2) after the
    temporal one, a diagonal renumbered) JAX's compiled ``forward2d``
    holds 15 all-to-alls and 9 collective-permutes where its own
    ``expected_carry_collectives`` counts 9 all-to-alls; the port issues
    exactly the accounting (``test_forward2d_matches_jax``)."""
    got = {k: n for k, n in zip(HLO_KINDS, runs["jax"]["hlo/g222"].tolist())
           if n}
    assert _jax_carry(*_case_plan("g222")) == {"all-to-all": 9}
    assert got == {"all-to-all": 15, "collective-permute": 9}


def test_grads_match_jax(runs):
    """mean(out²) at (2, 4) with every layer pair checkpointed: each rank's
    share and its gradient, summed over the world in one all-reduce,
    match ``jax.grad`` of JAX's ``forward2d`` within the grad bar, 2e-2 of
    each leaf's max.  Per rank: the 8 planned all-to-alls three times
    (forward, recompute, backward) and the one all-reduce."""
    jx = runs["jax"]
    paths = [k[len("grad/"):] for k in jx if k.startswith("grad/")]
    assert len(paths) == len(flatten(runs["params"]["t"]))
    for rank in runs["ranks"]:
        for path in paths:
            g, w = rank[f"grad/{path}"], jx[f"grad/{path}"]
            assert g.shape == w.shape, path
            gap = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
            assert gap <= 2e-2, (path, gap)
        assert _calls(rank, "grad") == {"all-to-all": 24, "all-reduce": 1}


# ---------------------------------------------------------------------------
# Single transitions and the diagonal-order rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRANSITIONS))
def test_transition_moves_the_right_slices(runs, name):
    """Each transition of ``_torch_l2d_worker.TRANSITIONS`` on the (2, 4)
    grid leaves every rank exactly its slice of the global tensor at the
    target layout, with the collectives ``PairTransition`` counts (one per
    changed axis, one joint); the three that would need traffic across the
    other axis' groups raise ValueError before any call."""
    src, _, tgt, _ = TRANSITIONS[name]
    refused = name.startswith("refused")
    for rank in runs["ranks"]:
        assert int(rank[f"tr/{name}/refused"]) == refused
        if refused:
            assert _calls(rank, f"tr/{name}") == {}
            continue
        assert int(rank[f"tr/{name}/ok"]) == 1
        assert _calls(rank, f"tr/{name}") == \
            classify2(src, tgt).collective_counts()


def test_joint_switch_needs_the_flattening_order(runs):
    """The joint switch from (2, 2) numbered ``sp_in`` major to (1, 1)
    numbered ``sp_out`` major: as one all-to-all over the flattened group
    taking chunks in the group's own (``sp_out``-major) order it misses
    the oracle on every rank (the received S chunks land out of order);
    the executor, which renumbers the chunks on the way, hits it, and its
    gradient is the reverse switch's, exactly."""
    hits = [int(r["tr/bare_all_to_all/ok"]) for r in runs["ranks"]]
    assert not any(hits), hits
    assert all(int(r["tr/joint_grad/ok"]) for r in runs["ranks"])
    assert all(int(r["tr/joint_renumbered/ok"]) for r in runs["ranks"])


# ---------------------------------------------------------------------------
# One process: a world of one, the refusals
# ---------------------------------------------------------------------------

@pytest.fixture
def grid_of_one():
    """A gloo world of one rank in this process, on a FileStore, and its
    (1, 1) SP grid."""
    from repro_torch.launch.mesh import make_sp2d_mesh
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield make_sp2d_mesh(1, 1, device_type="cpu")
        finally:
            dist.destroy_process_group()


def test_forward2d_on_a_grid_of_one(runs, grid_of_one):
    """At (1, 1) every switch is still one all-to-all of one rank (6 at 2
    periods, JAX's count) and the output is JAX's ``forward2d`` at (1, 1)
    within 1e-5 of its largest |value|, and the 1D ``forward``'s."""
    tcfg = _cfgs()[0]["t"]
    params = bridge.params_from_numpy(runs["params"]["t"], device="cpu")
    x = torch.from_numpy(runs["inputs"]["x24"])
    t = torch.from_numpy(runs["inputs"]["t"])
    dsp.reset_calls()
    with torch.no_grad():
        got = TT.make_spmd_forward2d(tcfg, grid_of_one, backend="ref")(
            params, x, t)
    assert dict(dsp.calls) == _jax_carry(*_case_plan("g11"))
    want = runs["jax"]["g11"]
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
    with torch.no_grad():
        one = TT.forward(params, x, t, tcfg, backend="ref", remat=False)
    assert (got - one).abs().max() / one.abs().max() < 1e-5


def test_forward2d_refusals(grid_of_one):
    """``forward2d`` refuses GQA and a mesh without both SP axes, with
    JAX's messages; the executor refuses ``backend="auto"`` (XLA's
    partitioner has no PyTorch counterpart)."""
    from repro_torch.launch.mesh import make_mesh
    cfg = _cfgs()[0]["t"]
    gqa = TT.T2DConfig(**{**configs(torch.float32)["t"], "n_kv_heads": 2})
    with pytest.raises(ValueError, match="needs MHA"):
        TT.make_spmd_forward2d(gqa, grid_of_one)
    with pytest.raises(ValueError, match="missing"):
        TT.make_spmd_forward2d(cfg, make_mesh((1, 1), ("data", "model"),
                                              "cpu"))
    ps = TT.dsp2d_schedule(cfg, (1, 1), t_len=4, s_len=8, batch=2)
    with pytest.raises(NotImplementedError, match="auto"):
        TS.ScheduleExecutor2D(ps, backend="auto")
    with pytest.raises(ValueError, match="planned for grid"):
        TS.ScheduleExecutor2D(
            TT.dsp2d_schedule(cfg, (2, 4), t_len=4, s_len=8, batch=2),
            backend="explicit", ctx=from_mesh(grid_of_one))


def test_null_executor_is_the_identity():
    """``backend="null"`` passes every tensor through and its accounting
    reads the schedule; ``anchor`` and ``fold_anchor`` are identities."""
    ex = TS.ScheduleExecutor2D.null()
    x = torch.randn(2, 3)
    for fn in (ex.enter, ex.wrap, ex.exit, ex.carry_enter, ex.carry_exit):
        assert fn(x) is x
    assert ex.boundary(x, 1) is x and ex.anchor(x, 0) is x
    assert ex.fold_anchor(x, 0, dims={}) is x
    assert ex.expected_carry_collectives(3) == {}
