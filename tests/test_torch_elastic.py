"""Checkpoints, compression and the elastic resize of the port across 4
gloo ranks on the CPU, beside the JAX package on 4 simulated devices.

4 processes (``tests/_torch_ckpt_worker.py``) on one ``FileStore`` and a
JAX subprocess (``tests/_torch_ckpt_jax.py``) start together from JAX's
init of one LM (``tests/md_scenarios.py``'s ``elastic_train_resize``
config):

1. the training state saved at (2, 2) under ZeRO-3 and the vocab ring
   (each rank writing its slices, async) restores bit for bit at (1, 4)
   and (4, 1) on the ranks, and whole here at world 1, through the port's
   manager and through JAX's;
2. ``compress_with_feedback`` on the ranks' slices equals the whole-leaf
   compression, bit for bit, over 3 steps, with one all-reduce (MAX) per
   set of split dims a step;
3. ``Trainer.replan`` from (2, 2) to 2 after a checkpoint and a resume
   (the resumed state bit-equal to the saved one): the losses of all 6
   steps within 1e-5 relative of JAX's ``Trainer.replan``, which
   ``elastic_train_resize`` holds bitwise in the reference and misses by
   an ulp;
4. the train CLI under ``torchrun`` with ``--ckpt-dir``, then
   ``--resume --replan 2``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.train.checkpoint as JC
from repro.models import lm as JL
from repro_torch.train.checkpoint import CheckpointManager

from _torch_ckpt_worker import (CFG_KW, COMPRESS_STEPS, ELASTIC_STEPS,
                                LAYOUT_STEP, LAYOUTS, RESIZE_AT, bit_equal,
                                layout_tree)
from _torch_ckpt_jax import WORLD  # noqa: E402
from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("ckpt"))
    params = jax.tree_util.tree_map(np.asarray, JL.init_lm(
        jax.random.PRNGKey(0), JL.LMConfig(**CFG_KW, dtype=jnp.float32)))
    np.savez(os.path.join(work, "params.npz"), **flatten(params))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(WORLD),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_ckpt_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_ckpt_worker.py"),
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


@pytest.mark.parametrize("shape", LAYOUTS)
def test_zero3_checkpoint_restores_on_other_meshes(runs, shape):
    """Saved at (2, 2), restored at ``shape``: every rank's slices of the
    whole state (bf16 params, f32 moments, master copy and residuals,
    the step) equal ``shard_params`` of the saved global tree."""
    for rank in runs["ranks"]:
        assert rank["layout/steps"].tolist() == [LAYOUT_STEP]
        assert rank[f"layout/{shape[0]}x{shape[1]}"].all()


def test_zero3_checkpoint_restores_whole_in_both_packages(runs):
    """The 4 ranks' checkpoint, restored whole at world 1 by the port's
    manager and by JAX's, bit for bit; each split leaf was written once
    per distinct slice, the vocab table in 2 (model) and a ZeRO leaf in 4
    (data x model) shards, a 1-D leaf in one."""
    want = layout_tree(unflatten(flatten(runs["params"])))
    d = os.path.join(runs["work"], "ck_layout")
    step, got = CheckpointManager(d).restore(want)
    assert step == LAYOUT_STEP and bit_equal(got, want)
    _, man = CheckpointManager(d).load_manifest()
    recs = {r["key"]: r for r in man["leaves"]}
    assert len(recs["params/embed/table"]["shards"]) == 2
    assert recs["params/embed/table"]["sharded_dims"] == [0]
    wq = "params/periods/0/attn/wq/w"
    assert len(recs[wq]["shards"]) == 4 and recs[wq]["sharded_dims"] == [1]
    assert len(recs["opt/m/final_norm/scale"]["shards"]) == 1
    assert {s["file"].split("/")[0] for s in recs[wq]["shards"]} == {
        f"shard_{r:05d}" for r in range(WORLD)}
    template = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct((), jnp.int32) if isinstance(t, int)
        else jax.ShapeDtypeStruct(tuple(t.shape), {
            torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[
                t.dtype]), want)
    _, jgot = JC.CheckpointManager(d).restore(template)
    for key, w in flatten(want).items():
        j = np.asarray(flatten(jgot)[key])
        if isinstance(w, int):
            assert int(j) == w, key
        else:
            raw = w.view(torch.int16) if w.dtype == torch.bfloat16 else w
            assert j.tobytes() == raw.numpy().tobytes(), key


def test_compression_under_a_layout_equals_whole_leaves(runs):
    for rank in runs["ranks"]:
        assert rank["compress/ok"].tolist() == [True] * COMPRESS_STEPS
        # one bucket over ("data", "model") (ZeRO leaves) and one over
        # "model" (the vocab tables) a step
        assert int(rank["compress/all_reduces"]) == 2 * COMPRESS_STEPS


def test_replan_matches_jax(runs):
    """Ranks 0 and 1 run all 6 steps (3 at (2, 2), 3 at (2, 1) after
    ``replan(2)``), ranks 2 and 3 the first 3 and then leave; the losses
    within 1e-5 relative of JAX's, whose resized mesh is also (2, 1)."""
    want = runs["jax"]["losses"]
    assert len(want) == ELASTIC_STEPS
    assert runs["jax"]["mesh"].tolist() == [2, 1]
    for r, rank in enumerate(runs["ranks"]):
        assert rank["elastic/resumed"].all(), r
        survivor = r < 2
        assert bool(rank["elastic/active"]) == survivor
        if survivor:
            assert rank["elastic/mesh"].tolist() == [2, 1]
            assert rank["elastic/steps"].tolist() == [RESIZE_AT,
                                                      ELASTIC_STEPS]
        got = rank["elastic/losses"]
        assert len(got) == (ELASTIC_STEPS if survivor else RESIZE_AT)
        np.testing.assert_allclose(got, want[:len(got)], rtol=1e-5, atol=0)


def test_replan_moves_the_state_bit_equal(runs):
    """``replan(2)`` moves the state from (2, 2) to (2, 1) one leaf at a
    time: on each survivor the moved state (bf16 params, AdamW's moments
    and master copy, the step), gathered, equals the state gathered
    before the move, bit for bit."""
    for r, rank in enumerate(runs["ranks"]):
        assert ("elastic/moved" in rank) == (r < 2), r
        if r < 2:
            assert bool(rank["elastic/moved"]), r


def test_train_cli_resumes_and_replans_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
    qwen3-14b --mesh 2,2 --ckpt-dir <d> --steps 2``, then ``--steps 4
    --resume --replan 2``: the second run resumes at step 2, ranks 0 and 1
    train steps 3 and 4 on (2, 1) and checkpoint them, ranks 2 and 3
    leave with no steps."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
            "--arch", "qwen3-14b", "--mesh", "2,2", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path)]
    outs = []
    for extra in (["--steps", "2"],
                  ["--steps", "4", "--resume", "--replan", "2"]):
        proc = subprocess.run(base + extra, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, (proc.stdout[-3000:]
                                      + proc.stderr[-3000:])
        outs.append(proc.stdout)
    # a checkpoint every step (--steps // 4), the last 3 kept
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3, 4]
    hist = [l for l in outs[1].splitlines() if l.startswith("history: ")]
    assert sorted(h.count("(") for h in hist) == [0, 0, 2, 2], outs[1]
