"""The port's DSP path over ``torch.distributed`` against the JAX package's
on the CPU: 4 gloo processes (``tests/_torch_dsp_worker.py``) on one
``FileStore``, and the JAX side on 4 simulated devices in a subprocess
(``tests/_torch_dsp_jax.py``), as ``tests/test_multidevice.py`` runs it.

The model is a small DiT (4 blocks, d 64, 4 heads, in_dim 16, f32) from
JAX's init with every block's modulation drawn from seeded normals
(adaLN-zero would make each block the identity).  Bars, each stated where
it is checked: the primitives move values exactly (0); the DSP forward at
meshes (1, 4) and (2, 2) within 2e-4 of the largest |value| of JAX's
``make_spmd_forward(mode="dsp")``, the bar ``tests/md_scenarios.py`` holds
JAX's DSP to; the loss within 1e-5 relative and every gradient leaf within
1e-4 of its max against ``jax.grad`` of JAX's ``t2d_loss`` at
``mesh=None``; a Trainer step under the mesh against one in one process
(see ``test_trainer_step_under_the_mesh_matches_one_process``).  The
collective counts are exact: per rank, what both packages'
``ScheduleExecutor.expected_collectives`` plan, 2 all-to-alls per layer
pair forward."""
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import schedule as JS
from repro.models import transformer2d as JT
from repro_torch import bridge
from repro_torch.core import dsp
from repro_torch.core import schedule as TS
from repro_torch.core.layout import (ParallelContext, SeqLayout, divisible,
                                     from_mesh, local_shape)
from repro_torch.models import transformer2d as TT
from repro_torch.train.trainer import Trainer, TrainerConfig

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce")
PAIRS = 2


def _flatten(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flatten(tree[key], f"{path}/{key}").items()}
    return {path.lstrip("/"): tree}


def _perturbed_params():
    import jax.numpy as jnp
    cfg = JT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                       d_ff=128, in_dim=16, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_t2d(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(100)
    for kind in ("spatial", "temporal"):
        proj = tree["layers"][kind]["mod"]["proj"]
        d = proj["w"].shape[-2]
        proj["w"] = (rng.standard_normal(proj["w"].shape)
                     * 0.5 / np.sqrt(d)).astype(np.float32)
        proj["b"] = (rng.standard_normal(proj["b"].shape)
                     * 0.1).astype(np.float32)
    return tree


def _inputs():
    rng = np.random.RandomState(1)
    f32 = np.float32
    return {"x": rng.standard_normal((2, 8, 16, 16)).astype(f32),
            "t": rng.rand(2).astype(f32),
            "target": rng.standard_normal((2, 8, 16, 16)).astype(f32),
            "prim_x": np.arange(2 * 8 * 8 * 6, dtype=f32).reshape(2, 8, 8, 6),
            "prim_w": rng.standard_normal((2, 8, 8, 6)).astype(f32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("dsp"))
    params = _perturbed_params()
    inputs = _inputs()
    np.savez(os.path.join(work, "params.npz"), **_flatten(params))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_dsp_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_dsp_worker.py"),
                            str(r), str(WORLD), work]
    procs, logs = {}, {}
    try:
        for name, cmd in cmds.items():
            logs[name] = open(os.path.join(work, f"{name}.log"), "w+")
            procs[name] = subprocess.Popen(cmd, env=env, stdout=logs[name],
                                           stderr=subprocess.STDOUT)
        for name, p in procs.items():
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


def _calls(rank, scenario):
    return dict(zip(KINDS, rank[f"{scenario}/calls"].tolist()))


def _expected(n, t_len=8, s_len=16, batch=2):
    """Per-rank collectives of one forward, from both packages'
    executors."""
    tcfg = TT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                        d_ff=128, in_dim=16, dtype=torch.float32)
    import jax.numpy as jnp
    jcfg = JT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                        d_ff=128, in_dim=16, dtype=jnp.float32)
    kw = dict(t_len=t_len, s_len=s_len, batch=batch)
    got = TS.ScheduleExecutor(TT.dsp_schedule(tcfg, n, **kw),
                              backend="explicit")
    want = JS.ScheduleExecutor(JT.dsp_schedule(jcfg, n, **kw),
                               backend="explicit")
    fwd = got.expected_collectives(PAIRS)
    assert fwd == want.expected_collectives(PAIRS) == {"all-to-all":
                                                       2 * PAIRS}
    assert got.expected_bwd_collectives(PAIRS) == fwd
    return fwd["all-to-all"]


# ---------------------------------------------------------------------------
# The primitives
# ---------------------------------------------------------------------------

def test_primitives_match_jax(runs):
    """On a (1, 4) mesh, T sharded: ``dynamic_switch(1 -> 2)`` gives each
    rank JAX's tiled all-to-all tile (its S slice, T whole), the switch
    back restores the T shard, ``gather`` the whole tensor and ``split``
    the shard again, all exactly; a target dim 4 does not divide raises
    before any call.  The switch's backward is the reverse
    switch (the cotangent's T slice); the gather's sums every rank's
    cotangent (4 equal ones here) onto the shard.  Calls per rank: 3
    all-to-alls (2 forward, 1 backward), 2 all-gathers, 1 reduce-scatter."""
    x, w = runs["inputs"]["prim_x"], runs["inputs"]["prim_w"]
    jx = runs["jax"]
    for r, rank in enumerate(runs["ranks"]):
        t_sl, s_sl = slice(2 * r, 2 * r + 2), slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(rank["prim/y"], jx["prim/y"][r])
        np.testing.assert_array_equal(rank["prim/y"], x[:, :, s_sl])
        assert tuple(rank["prim/shape"]) == (2, 8, 2, 6)
        np.testing.assert_array_equal(rank["prim/z"], jx["prim/z"][r])
        np.testing.assert_array_equal(rank["prim/z"], rank["prim/local"])
        np.testing.assert_array_equal(rank["prim/local"], x[:, t_sl])
        np.testing.assert_array_equal(rank["prim/full"], jx["prim/full"][r])
        np.testing.assert_array_equal(rank["prim/full"], x)
        np.testing.assert_array_equal(rank["prim/again"], x[:, t_sl])
        np.testing.assert_array_equal(rank["prim/switch_grad"], w[:, t_sl])
        np.testing.assert_allclose(rank["prim/gather_grad"],
                                   WORLD * w[:, t_sl], rtol=1e-6)
        assert _calls(rank, "prim") == {"all-to-all": 3, "all-gather": 2,
                                        "reduce-scatter": 1, "all-reduce": 0}
        assert rank["prim/refused"] == 1      # S of 6 over 4 ranks


# ---------------------------------------------------------------------------
# The DiT under DSP
# ---------------------------------------------------------------------------

def _assemble(ranks, key, shape):
    """The global tensor from each rank's (B / dp, T / sp, ...) shard."""
    dp, sp = shape
    rows = [[None] * sp for _ in range(dp)]
    for rank in ranks:
        d, s = rank[key.split("/")[0] + "/coord"].tolist()
        rows[d][s] = rank[key]
    return np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spmd_forward_matches_jax(runs, mesh):
    """``make_spmd_forward(mode="dsp")`` takes the global batch on every
    rank and returns the rank's shard; gathered, it matches JAX's within
    2e-4 of the largest |value|.  Every rank issues exactly the planned
    all-to-alls (2 per layer pair) and nothing else."""
    got = _assemble(runs["ranks"], f"fwd{mesh}/out", MESHES[mesh])
    want = runs["jax"][f"fwd{mesh}"]
    assert got.shape == want.shape == (2, 8, 16, 16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-4, rel
    n_a2a = _expected(MESHES[mesh][1])
    for rank in runs["ranks"]:
        assert _calls(rank, f"fwd{mesh}") == {
            "all-to-all": n_a2a, "all-gather": 0, "reduce-scatter": 0,
            "all-reduce": 0}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_loss_and_grads_match_jax(runs, mesh):
    """Each rank's ``t2d_loss(mesh=...)`` on its shard, with its grads,
    summed over the world in one all-reduce (``allreduce_grads``), equals
    JAX's global-mean loss within 1e-5 relative and its gradient within
    1e-4 of each leaf's max.  Per rank: the planned all-to-alls three times
    over (forward, the checkpointed recompute, the backward) and one
    all-reduce."""
    jx = runs["jax"]
    paths = [k[len("grad/"):] for k in jx if k.startswith("grad/")]
    assert len(paths) == len(_flatten(runs["params"]))
    n_a2a = _expected(MESHES[mesh][1])
    for rank in runs["ranks"]:
        loss = float(rank[f"grad{mesh}/loss"])
        assert abs(loss - float(jx["loss"])) <= 1e-5 * abs(float(jx["loss"]))
        for path in paths:
            g, w = rank[f"grad{mesh}/{path}"], jx[f"grad/{path}"]
            assert g.shape == w.shape, path
            gap = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
            assert gap <= 1e-4, (path, gap)
        assert _calls(rank, f"grad{mesh}") == {
            "all-to-all": 3 * n_a2a, "all-gather": 0, "reduce-scatter": 0,
            "all-reduce": 1}


def test_trainer_step_under_the_mesh_matches_one_process(runs):
    """One ``Trainer`` step on a (2, 2) mesh, each rank on its shard,
    against the same step in one process on the whole batch: the logged
    loss within 1e-5 relative, and each parameter's change within 1e-3 of
    its leaf's largest change (the grads are summed in another order;
    AdamW's eps of 1e-4 keeps its first step, lr * g / (|g| + eps),
    continuous in them).  One all-reduce a step."""
    opt = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
    from repro_torch.optim.adamw import OptConfig
    cfg = TT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                       d_ff=128, in_dim=16, dtype=torch.float32)
    batch = {k: torch.from_numpy(runs["inputs"][k])
             for k in ("x", "t", "target")}
    trainer = Trainer(
        loss_fn=lambda p, b: TT.t2d_loss(p, b, cfg, backend="kernel"),
        params=bridge.params_from_numpy(runs["params"], device="cpu"),
        opt_cfg=OptConfig(**opt),
        cfg=TrainerConfig(total_steps=1, log_every=1),
        data_fn=lambda step: batch, device="cpu")
    want_loss = trainer.run()["history"][0][1]
    before = _flatten(runs["params"])
    after = {k: v.numpy() for k, v in _flatten(trainer.params).items()}
    for rank in runs["ranks"]:
        assert abs(float(rank["train/loss"]) - want_loss) <= \
            1e-5 * abs(want_loss)
        for path, p0 in before.items():
            want = after[path] - p0
            got = rank[f"train/{path}"] - p0
            gap = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
            assert gap <= 1e-3, (path, gap)
        assert _calls(rank, "train")["all-reduce"] == 1


def test_unrolled_view_runs_the_same_plan(runs):
    """``forward`` with the plan's unrolled view (absolute boundaries, the
    last switch at the exit) gives the periodic view's values exactly and
    issues the same all-to-alls."""
    for rank in runs["ranks"]:
        assert float(rank["view/gap"]) == 0.0
        assert _calls(rank, "view/unrolled") == _calls(rank, "view/periodic")
        assert _calls(rank, "view/periodic")["all-to-all"] == _expected(4)


def test_mesh_and_context(runs):
    """``make_mesh((2, 2))`` puts rank r at (r // 2, r % 2), its ``model``
    group has 2 ranks; ``submesh(2)`` holds ranks 0 and 1 only."""
    for r, rank in enumerate(runs["ranks"]):
        assert rank["mesh/ctx"].tolist() == [2, 2, 4, r % 2, r // 2, 2]
        assert rank["mesh/sub"].tolist() == ([0, r] if r < 2 else [-1, -1])


# ---------------------------------------------------------------------------
# One process: the layout algebra, a world of one, the refusals
# ---------------------------------------------------------------------------

def test_layout_algebra():
    lay = SeqLayout(shard_dim=1)
    assert lay.switched(2).shard_dim == 2
    assert lay.gathered().split(1) == lay
    with pytest.raises(ValueError):
        lay.switched(0)
    with pytest.raises(ValueError):
        lay.gathered().switched(2)
    assert local_shape((4, 8, 16, 32), lay, 4, 2) == (2, 2, 16, 32)
    assert divisible(8, 4) and not divisible(6, 4)
    with pytest.raises(ValueError):
        local_shape((4, 6, 16, 32), lay, 4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        from_mesh(object())


@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, on a FileStore."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            from repro_torch.launch.mesh import make_mesh
            yield from_mesh(make_mesh((1, 1), ("data", "model"), "cpu"))
        finally:
            dist.destroy_process_group()


def test_world_of_one_still_switches(world_of_one):
    """At one rank each switch is still one all-to-all (as JAX's is one
    collective at any size), and moves no value; its backward is one more.
    A switch to the dim it is on issues nothing."""
    ctx = world_of_one
    assert isinstance(ctx, ParallelContext) and ctx.world_size == 1
    x = torch.randn(2, 3, 5, 4, requires_grad=True)
    dsp.reset_calls()
    y = dsp.dynamic_switch(x, 1, 2, ctx.sp_group)
    assert torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert dsp.calls == {"all-to-all": 2}
    assert dsp.dynamic_switch(x, 2, 2, ctx.sp_group) is x
    assert dsp.calls == {"all-to-all": 2}


def _gqa(**kw):
    return TT.T2DConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                        d_ff=128, in_dim=16, dtype=torch.float32, **kw)


# name -> (config, mode, overlap, mesh: "1d" (data, model), "2d" the SP
# grid (sp_out, sp_in), or "none"), each of which must raise ValueError
MODE_REFUSALS = {
    "unknown_mode": (_gqa(), "tensor", None, "1d"),
    "unknown_overlap": (_gqa(), "dsp", "eager", "1d"),
    "overlap_outside_dsp": (_gqa(), "ring", "chunked", "1d"),
    "megatron_gqa": (_gqa(n_kv_heads=2), "megatron", None, "1d"),
    "megatron_relu_mlp": (_gqa(mlp_kind="relu"), "megatron", None, "1d"),
    "ulysses_fused_gqa": (_gqa(n_kv_heads=2), "ulysses_fused", None, "1d"),
    "hybrid_without_2d_mesh": (_gqa(), "hybrid", None, "1d"),
    "dsp_without_model_dim": (_gqa(), "dsp", None, "2d"),
    "mode_without_mesh": (_gqa(), "ulysses", None, "none"),
}


@pytest.mark.parametrize("case", sorted(MODE_REFUSALS))
def test_mode_checks_raise(world_of_one, case):
    """Each mode runs only where it can: ``make_spmd_forward`` (and
    ``forward`` without a mesh) raise ValueError for an unknown mode or
    overlap, overlap outside ``dsp``, GQA under ``megatron`` and
    ``ulysses_fused``, ``megatron`` with an MLP other than ``gelu``,
    ``hybrid`` without the 2D SP grid and the other modes without a
    ``model`` dim."""
    from repro_torch.launch.mesh import make_sp2d_mesh
    cfg, mode, overlap, kind = MODE_REFUSALS[case]
    if kind == "none":
        x = torch.zeros(1, 2, 2, 16)
        with pytest.raises(ValueError, match="pass mesh="):
            TT.forward({}, x, None, cfg, mode=mode, overlap=overlap)
        return
    mesh = (world_of_one.mesh if kind == "1d"
            else make_sp2d_mesh(1, 1, device_type="cpu"))
    with pytest.raises(ValueError):
        TT.make_spmd_forward(cfg, mesh, mode=mode, overlap=overlap)


def test_auto_backend_raises():
    """JAX's ``backend="auto"`` (sharding constraints through XLA's SPMD
    partitioner) has no PyTorch counterpart; the explicit executor takes
    ``overlap`` and the null one refuses it."""
    ps = TT.dsp_schedule(_gqa(), 4, t_len=8, s_len=16, batch=2)
    with pytest.raises(NotImplementedError, match="auto"):
        TS.ScheduleExecutor(ps, backend="auto")
    assert TS.ScheduleExecutor(ps, backend="explicit",
                               overlap="chunked").overlap == "chunked"
    with pytest.raises(ValueError, match="explicit backend only"):
        TS.ScheduleExecutor(None, backend="null", overlap="chunked")


# ---------------------------------------------------------------------------
# The train CLI under torchrun
# ---------------------------------------------------------------------------

def test_train_cli_under_torchrun():
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
    transformer2d-720m --mesh 1,4 --device cpu --steps 3`` at SMOKE size:
    every rank logs the same global loss, and it falls."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "transformer2d-720m", "--mesh", "1,4", "--device", "cpu",
         "--steps", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("loss ")]
    assert len(lines) == 4 and len(set(lines)) == 1, proc.stdout
    first, last = (float(v) for v in lines[0].split()[1::2])
    assert last < first, lines[0]
