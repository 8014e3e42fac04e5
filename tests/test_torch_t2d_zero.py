"""ZeRO-3 training of the port's 2D DiT (``t2d_loss(param_specs=)``,
``transformer2d.param_contract``, ``Trainer(param_specs=)``) against the
JAX package's ``build_t2d_cell`` steps, on the CPU.

4 gloo processes (``tests/_torch_t2d_zero_worker.py``) on one
``FileStore`` beside JAX on 4 simulated devices
(``tests/_torch_t2d_zero_jax.py``), from JAX's init of ``tests/
test_torch_dsp.py``'s DiT (4 blocks, d 64, 4 heads, d_ff 128, in_dim 16,
f32) with every block's modulation drawn from seeded normals, batch 2 x 8
frames x 16 patches, under transformer2d-720m's own plan
(``ParallelPlan(mode="dsp", zero=True, shard_vocab=False)``), the
parameters placed by each package's ``param_pspecs``.  The bars, each
stated where it is checked:

1. ``dsp`` with ``remat`` at (2, 2) and (1, 4), and ``ulysses`` at (1,
   4): the loss within 1e-5 relative of JAX's, each rank's slice of every
   gradient within 1e-4 of its leaf's max (``tests/test_torch_dsp.py``'s
   bars), the clip's norm within 1e-5 relative; per rank the calls and
   bytes exactly ``step_contract`` (the mode's collectives three times
   over plus ``param_contract``; JAX's compiled counts read beside them,
   a finding);
2. 3 Trainer steps at (2, 2) on the slices against one process's Trainer
   on the whole parameters: each step's loss and grad norm, and every
   leaf gathered after them, within 1e-5 relative;
3. a checkpoint of that run after 2 steps, saved by the 4 ranks, restores
   bit-equal at (1, 4) (the ranks) and whole here through the port's
   manager and through JAX's, and the run resumed at (1, 4) takes step 3
   within 1e-5 relative of the uninterrupted run's;
4. in this process: a world of one issues every gather and gives the
   values of the whole parameters bit for bit; ``hybrid`` and
   ``forward2d`` refuse ``param_specs``; the Trainer refuses a sharder
   with ``param_specs``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.train.checkpoint as JC
from repro_torch import bridge
from repro_torch.core import dsp
from repro_torch.core.layout import from_mesh
from repro_torch.models import transformer2d as TT
from repro_torch.models.lm import tree_leaves
from repro_torch.optim.adamw import OptConfig
from repro_torch.parallel.partition import (mesh_sizes, null_sharder,
                                            param_pspecs, shard_params)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_t2d_zero_jax import HLO_KINDS, SCENARIOS, WORLD  # noqa: E402
from _torch_t2d_zero_worker import (CFG, CKPT_AT, PLAN,  # noqa: E402
                                    TRAIN_OPT, TRAIN_STEPS, train_batch)
from test_torch_dsp import _inputs, _perturbed_params  # noqa: E402
from _torch_world import world_of_one  # noqa: E402,F401
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("t2d_zero"))
    params = _perturbed_params()
    inputs = _inputs()
    np.savez(os.path.join(work, "params.npz"), **flatten(params))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(WORLD),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE,
                                                 "_torch_t2d_zero_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_t2d_zero_worker.py"),
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
    return {"work": work, "params": params,
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)],
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


def _counts(rank, key):
    return {k: n for k, n in zip(KINDS, rank[key].tolist()) if n}


# ---------------------------------------------------------------------------
# 1. Against JAX, on 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grad_slices_match_jax(runs, name):
    """Each rank's ``t2d_loss(param_specs=)`` on its slices and batch
    shard, summed by ``allreduce_grads`` (each grad over the dims its leaf
    is not split over), equals JAX's loss with the parameters placed by
    its ``param_pspecs`` within 1e-5 relative; each rank's slice of every
    gradient equals the same slice of ``jax.grad``'s within 1e-4 of the
    leaf's max; the clip's norm from the slices (``slices_norm``) equals
    the norm of JAX's whole gradient within 1e-5 relative."""
    jx = runs["jax"]
    paths = list(flatten(runs["params"]))
    want_loss = float(jx[f"{name}/loss"])
    want_norm = float(np.sqrt(sum(np.sum(np.square(
        jx[f"{name}/grad/{p}"].astype(np.float64))) for p in paths)))
    split = 0
    for rank in runs["ranks"]:
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss,
                                                                 want_loss)
        norm = float(rank[f"{name}/norm"])
        assert abs(norm - want_norm) <= 1e-5 * want_norm, (norm, want_norm)
        for path in paths:
            w = jx[f"{name}/grad/{path}"]
            index = rank[f"{name}/index/{path}"]
            got = rank[f"{name}/grad/{path}"]
            want = w[tuple(slice(a, b) for a, b in index)]
            assert got.shape == want.shape, path
            split += got.size < w.size
            gap = np.abs(got - want).max() / (np.abs(w).max() + 1e-30)
            assert gap <= 1e-4, (path, gap)
    # every block weight, the embedding, t_proj and head are split
    assert split == WORLD * 17, split


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, one step's loss, grads, grad sums and clip norm issue
    exactly ``step_contract``: the mode's collectives three times over
    (forward, recompute, backward) plus ``param_contract``, in calls and
    in bytes: per pair 2 all-gathers and 1 float32 reduce-scatter of each
    split block weight, 1 of each for the embedding, t_proj and head, one
    all-reduce of the whole leaves' bucket with the loss and one of the
    clip's norm."""
    for rank in runs["ranks"]:
        assert _counts(rank, f"{name}/calls") == \
            _counts(rank, f"{name}/contract_calls")
        assert _counts(rank, f"{name}/bytes") == \
            _counts(rank, f"{name}/contract_bytes")


def test_jax_compiles_other_collectives_than_the_contract(runs):
    """JAX's compiled steps are read beside the contract: the reference
    ran and XLA's pass counted their collectives.  XLA gathers the ZeRO
    weights and sums the grads its own way, so the counts (PERF.md §6)
    are recorded, not held; the port is held to its contract
    (``test_calls_and_bytes_are_the_contract``)."""
    for name in SCENARIOS:
        got = runs["jax"][f"{name}/hlo"]
        assert got.shape == (len(HLO_KINDS),) and got.sum() > 0, name


# ---------------------------------------------------------------------------
# 2. Trainer steps on slices
# ---------------------------------------------------------------------------

def _reference_trainer(params):
    """One process's Trainer on the whole parameters (plan ``none``),
    ``train_batch`` a step."""
    trainer = Trainer(
        loss_fn=lambda p, b: TT.t2d_loss(p, b, CFG),
        params=bridge.params_from_numpy(params, device="cpu"),
        opt_cfg=TRAIN_OPT,
        cfg=TrainerConfig(total_steps=TRAIN_STEPS, log_every=1),
        data_fn=train_batch, device="cpu")
    seen = []
    inner = trainer.step_fn

    def step(*args):
        res = inner(*args)
        seen.append([float(res[2]["loss"]), float(res[2]["grad_norm"])])
        return res
    trainer.step_fn = step
    trainer.run()
    return np.array(seen), flatten(trainer.params)


def test_trainer_steps_match_one_process(runs):
    """``TRAIN_STEPS`` Trainer steps on the ranks' slices at (2, 2) (the
    AdamW state made from the slices) against one process's Trainer on
    the whole parameters and the same global batches: each step's loss
    and grad norm, and every parameter gathered whole after the steps,
    within 1e-5 relative."""
    want, final = _reference_trainer(runs["params"])
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["train/metrics"], want, rtol=1e-5,
                                   atol=0)
        for path, p in final.items():
            w = p.numpy()
            gap = (np.abs(rank[f"train/param/{path}"] - w).max()
                   / (np.abs(w).max() + 1e-30))
            assert gap <= 1e-5, (path, gap)


# ---------------------------------------------------------------------------
# 3. Checkpoints of the slices
# ---------------------------------------------------------------------------

def test_checkpoint_restores_at_1x4_and_resumes(runs):
    """The state saved at (2, 2) after ``CKPT_AT`` steps (each rank its
    slices) restores at (1, 4) bit-equal (gathered on the ranks), and the
    resumed run's step 3 equals the uninterrupted run's within 1e-5
    relative."""
    for rank in runs["ranks"]:
        assert int(rank["ckpt/start_step"]) == CKPT_AT
        assert bool(rank["ckpt/restored_equal"])
        got = rank["ckpt/losses"]
        want = rank["train/metrics"][CKPT_AT:, 0]
        assert len(got) == TRAIN_STEPS - CKPT_AT
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _saved(work):
    raw = dict(np.load(os.path.join(work, "saved.npz")))
    return {k: (int(v) if v.ndim == 0 else torch.from_numpy(v))
            for k, v in raw.items()}


def test_checkpoint_restores_whole_in_both_packages(runs):
    """The 4 ranks' checkpoint, restored whole at world 1 by the port's
    manager and by JAX's, bit for bit; each split leaf was written once
    per distinct slice (4 for a block weight), each whole leaf once."""
    want = _saved(runs["work"])
    template = unflatten({k: v if isinstance(v, int) else torch.empty(
        v.shape, dtype=v.dtype, device="meta") for k, v in want.items()})
    d = os.path.join(runs["work"], "ck")
    step, got = CheckpointManager(d).restore(template, CKPT_AT,
                                             device="cpu")
    assert step == CKPT_AT
    got = flatten(got)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w, key
        else:
            assert torch.equal(got[key], w), key
    _, man = CheckpointManager(d).load_manifest(CKPT_AT)
    recs = {r["key"]: r for r in man["leaves"]}
    wq = "params/layers/spatial/wq/w"
    assert len(recs[wq]["shards"]) == 4 and recs[wq]["sharded_dims"] == [1]
    assert len(recs["opt/m/layers/temporal/ln1/scale"]["shards"]) == 1
    jtemplate = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct((), jnp.int32) if isinstance(t, int)
        else jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32),
        unflatten(want))
    _, jgot = JC.CheckpointManager(d).restore(jtemplate, CKPT_AT)
    for key, w in flatten(jgot).items():
        if isinstance(want[key], int):
            assert int(w) == want[key], key
        else:
            assert np.asarray(w).tobytes() == want[key].numpy().tobytes(), \
                key


# ---------------------------------------------------------------------------
# 4. One process
# ---------------------------------------------------------------------------

def test_world_of_one_issues_every_gather(world_of_one):
    """At one rank each slice is its whole leaf and every gather is still
    issued (an all-gather of one rank, a float32 reduce-scatter backward):
    the loss and every gradient equal those of the whole parameters
    without ``param_specs`` bit for bit, and the calls and bytes are
    exactly ``step_contract`` (the schedule's switches three times over
    plus ``param_contract``) less the trainer's all-reduces."""
    mesh = world_of_one
    ctx = from_mesh(mesh)
    whole = bridge.params_from_numpy(_perturbed_params(), device="cpu")
    specs = param_pspecs(whole, PLAN, axis_sizes=mesh_sizes(ctx))
    assert specs["layers"]["spatial"]["wq"]["w"] == (None, ("data", "model"),
                                                     None)
    assert specs["layers"]["spatial"]["mod"]["proj"]["b"] == (None, None)
    local = shard_params(whole, specs, ctx)
    assert all(a is b for a, b in zip(tree_leaves(local),
                                      tree_leaves(whole)))
    batch = {k: torch.from_numpy(v) for k, v in _inputs().items()
             if k in ("x", "t", "target")}
    psched = TT.dsp_schedule(CFG, 1, t_len=8, s_len=16, batch=2, joint=True)
    got = {}
    for name, sp in (("zero", specs), ("whole", None)):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(whole)]
        params = unflatten(dict(zip(flatten(whole), leaves)))
        dsp.reset_calls()
        loss, _ = TT.t2d_loss(params, batch, CFG, mesh=mesh, schedule=psched,
                              param_specs=sp)
        grads = torch.autograd.grad(loss, leaves)
        got[name] = (loss, grads, dict(dsp.calls), dict(dsp.volume))
    assert torch.equal(got["zero"][0], got["whole"][0])
    assert all(torch.equal(a, b) for a, b in zip(got["zero"][1],
                                                 got["whole"][1]))
    step = TT.step_contract(CFG, whole, PLAN, mesh_sizes(ctx), batch=2,
                            frames=8, patches=16, schedule=psched)
    # the trainer's all-reduces are not in a bare loss and its grads
    for part, seen in (("calls", got["zero"][2]), ("bytes", got["zero"][3])):
        want = {k: v for k, v in step[part].items() if k != "all-reduce"}
        assert seen == {k: v for k, v in want.items() if v}, part
    layout = TT.param_contract(CFG, whole, PLAN, mesh_sizes(ctx))
    # 14 split leaves a pair, gathered twice; embed, t_proj and head once
    assert layout["calls"]["all-gather"] == 2 * 2 * 14 + 3
    assert layout["calls"]["all-reduce"] == 2


def test_grid_refuses_param_specs(world_of_one):
    """``hybrid`` (``forward``) and ``forward2d`` run on the ("sp_out",
    "sp_in") grid, which has no ZeRO: with ``param_specs`` both raise
    ``NotImplementedError`` naming ROADMAP item 3.4."""
    from repro_torch.launch.mesh import make_sp2d_mesh
    mesh = make_sp2d_mesh(1, 1, device_type="cpu")
    x = torch.zeros(1, 2, 2, CFG.in_dim)
    with pytest.raises(NotImplementedError, match="item 3.4"):
        TT.forward({}, x, None, CFG, mesh=mesh, mode="hybrid",
                   param_specs={})
    with pytest.raises(NotImplementedError, match="item 3.4"):
        TT.forward2d({}, x, None, CFG, mesh=mesh, param_specs={})


def test_trainer_refuses_a_sharder_with_param_specs(world_of_one):
    """A loss runs under a sharder's layout or under ``param_specs``: the
    step refuses both, and ``param_specs`` without a mesh."""
    with pytest.raises(ValueError, match="not both"):
        make_train_step(lambda p, b: None, OptConfig(),
                        sharder=null_sharder(), param_specs={})
    with pytest.raises(ValueError, match="pass mesh="):
        make_train_step(lambda p, b: None, OptConfig(), param_specs={})
