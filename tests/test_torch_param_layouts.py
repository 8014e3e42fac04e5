"""The port's parameter layouts (``parallel.partition.param_pspecs``, the
parameter store, ZeRO-3 over ``("data", "model")`` and ``sharded_embed``'s
vocab ring) against the JAX package's, on the CPU.

1. ``param_pspecs`` case by case: every config both packages have, at
   SMOKE size (each package's own init tree) and at full shapes (JAX's
   ``eval_shape`` tree, handed to the port as meta tensors: no
   allocation), under the spec's own plan, ``zero`` off, ``shard_vocab``
   off and ``tp`` with ``zero``, at (data, model) sizes (1, 4), (2, 2),
   (4, 1) and (16, 16): spec for spec equal.
2. 4 gloo processes (``tests/_torch_zero_worker.py``) on one
   ``FileStore`` beside JAX on 4 simulated devices
   (``tests/_torch_zero_jax.py``), each scenario of
   ``_torch_zero_jax.SCENARIOS`` (the f32 configs of
   ``_torch_lmdsp_jax.configs`` at (1, 4) and (2, 2) under zero and
   shard_vocab, shard_vocab alone and zero alone), JAX's parameters placed
   by its own ``param_pspecs``: the gathered forward within 2e-4 of the
   largest |value|, the loss within 1e-5 relative, every grad leaf
   (gathered from the shards) within 1e-4 of its max, the clip's norm
   within 1e-5 relative; per rank the calls and bytes exactly the
   contract (the hooks' and ``lm.param_contract``); JAX's compiled counts
   are read beside them (PERF.md records them: a finding, not a bar).
3. Three ``Trainer`` steps at (2, 2) under ZeRO-3 and the ring: the
   losses, grad norms and the parameters gathered after them equal one
   rank's plan-none Trainer's within 1e-5 relative.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCONF
from repro.models import lm as JL
from repro.models import ssm as JSSM
from repro.models import transformer2d as JT2D
from repro.parallel.partition import param_pspecs as jax_pspecs
from repro_torch import configs as TCONF
from repro_torch.core import dsp
from repro_torch.core.layout import from_mesh
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer2d as TT2D
from repro_torch.parallel.partition import (ParallelPlan, gather_params,
                                            make_sharder, mesh_sizes,
                                            param_copies, param_pspecs,
                                            reduce_axes, shard_params,
                                            unshard_params)
from repro_torch.train.trainer import Trainer, TrainerConfig

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_jax import BATCH, SEQ, VOCAB, configs  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_zero_jax import HLO_KINDS, SCENARIOS, WORLD  # noqa: E402
from _torch_zero_worker import (TRAIN, TRAIN_OPT, TRAIN_STEPS,  # noqa: E402
                                train_batch)
from _torch_world import world_of_one  # noqa: E402,F401
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

# ---------------------------------------------------------------------------
# 1. param_pspecs, case by case
# ---------------------------------------------------------------------------

ARCHS = ("qwen3-14b", "mamba2-370m", "transformer2d-720m",
         "transformer2d-3b", "pixtral-12b", "jamba-1.5-large-398b")
MESHES = ((1, 4), (2, 2), (4, 1), (16, 16))
PLAN_KINDS = ("spec", "zero_off", "vocab_off", "tp_zero")


def _plan(spec_plan, kind):
    return {"spec": spec_plan,
            "zero_off": dataclasses.replace(spec_plan, zero=False),
            "vocab_off": dataclasses.replace(spec_plan, shard_vocab=False),
            "tp_zero": dataclasses.replace(spec_plan, mode="tp",
                                           zero=True)}[kind]


@functools.lru_cache(maxsize=None)
def _trees(arch: str, scale: str):
    """(JAX's tree, the port's tree) of ``arch`` at ``scale``: each
    package's own init at SMOKE size; at full size JAX's ``eval_shape``
    and meta tensors of the same shapes."""
    jspec, tspec = JCONF.get(arch), TCONF.get(arch)
    jinit = JT2D.init_t2d if jspec.family == "t2d" else JL.init_lm
    tinit = TT2D.init_t2d if tspec.family == "t2d" else TL.init_lm
    if scale == "smoke":
        return (jinit(jax.random.PRNGKey(0), jspec.smoke),
                tinit(0, tspec.smoke, device="cpu"))
    jtree = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                         jspec.config))
    ttree = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), jtree)
    return jtree, ttree


@pytest.mark.parametrize("plan_kind", PLAN_KINDS)
@pytest.mark.parametrize("scale", ("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, scale, plan_kind):
    """The port's ``param_pspecs`` gives JAX's spec for every leaf, at
    each mesh size of ``MESHES``: the same entries (names, name tuples,
    None) dim for dim, the divisibility guard and the None of stacked
    leaves included.  At SMOKE size the two packages' own trees have the
    same paths and shapes."""
    jtree, ttree = _trees(arch, scale)
    jflat, tflat = flatten(jtree), flatten(ttree)
    assert {k: tuple(v.shape) for k, v in jflat.items()} == \
        {k: tuple(v.shape) for k, v in tflat.items()}
    jspec_plan = JCONF.get(arch).plan
    tspec_plan = TCONF.get(arch).plan
    assert dataclasses.asdict(jspec_plan) == dataclasses.asdict(tspec_plan)
    for data, model in MESHES:
        sizes = {"data": data, "model": model}
        want = {k: tuple(s) for k, s in flatten(jax_pspecs(
            jtree, _plan(jspec_plan, plan_kind), axis_sizes=sizes)).items()}
        got = flatten(param_pspecs(ttree, _plan(tspec_plan, plan_kind),
                                   axis_sizes=sizes))
        assert got == want, (sizes, {k: (got[k], want[k]) for k in got
                                     if got[k] != want[k]})


# ---------------------------------------------------------------------------
# 2. Against JAX, on 4 ranks
# ---------------------------------------------------------------------------

# the scenario whose loss and grads JAX also compiles for their
# collectives (``parse_collectives``): XLA gathers the ZeRO weights where
# it sees fit and sums the grads its own way, so its counts are recorded
# (PERF.md §6), not held to the contract
HLO_SCENARIO = "hybrid/2x2/zero_vocab"


def _inputs():
    rng = np.random.RandomState(3)
    return {k: rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("zero"))
    params = {name: jax.tree_util.tree_map(
        np.asarray, JL.init_lm(jax.random.PRNGKey(0), cfg))
        for name, cfg in configs(JL, JSSM, jnp.float32).items()}
    for name, tree in params.items():
        np.savez(os.path.join(work, f"params_{name}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), **_inputs())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(WORLD),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_zero_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_zero_worker.py"),
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
    return {"params": params,
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)],
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


def _counts(rank, key):
    return {k: n for k, n in zip(KINDS, rank[key].tolist()) if n}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_forward_matches_jax(runs, name):
    """Each rank's ``forward(sharder=)`` with its parameter slices, on its
    batch and sequence shard, gathered, matches JAX's forward with the
    parameters placed by JAX's ``param_pspecs`` within 2e-4 of the
    largest |value|."""
    dp, sp = SCENARIOS[name][1]
    rows = [[None] * sp for _ in range(dp)]
    for rank in runs["ranks"]:
        d, s = rank[f"{name}/coord"].tolist()
        rows[d][s] = rank[f"{name}/out"]
    got = np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)
    want = runs["jax"][f"{name}/out"]
    assert got.shape == want.shape == (BATCH, SEQ, want.shape[-1])
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-4, rel


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grads_match_jax(runs, name):
    """Each rank's ``lm_loss(sharder=)``, summed by ``allreduce_grads``
    (each grad over the dims its leaf is not split over), equals JAX's
    global-mean loss within 1e-5 relative; every grad leaf gathered from
    the ranks' slices equals ``jax.grad``'s within 1e-4 of its max; and
    the clip's norm over the slices (``trainer.slices_norm``) equals the
    norm of JAX's whole gradient within 1e-5 relative."""
    cname = SCENARIOS[name][0]
    jx = runs["jax"]
    paths = list(flatten(runs["params"][cname]))
    want_loss = float(jx[f"{name}/loss"])
    want_norm = float(np.sqrt(sum(np.sum(np.square(
        jx[f"{name}/grad/{p}"].astype(np.float64))) for p in paths)))
    for rank in runs["ranks"]:
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss,
                                                                 want_loss)
        norm = float(rank[f"{name}/norm"])
        assert abs(norm - want_norm) <= 1e-5 * want_norm, (norm, want_norm)
        for path in paths:
            g, w = rank[f"{name}/grad/{path}"], jx[f"{name}/grad/{path}"]
            assert g.shape == w.shape, path
            gap = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
            assert gap <= 1e-4, (path, gap)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, one step's loss, grads, grad sums and clip norm issue
    exactly the hooks' contract (``remat_step`` of
    ``collective_contract``) plus the layouts' (``param_contract``), in
    calls and in bytes: 2 all-gathers and a float32 reduce-scatter per
    split period leaf, the ring's n permutes forward and n - 1 backward,
    a gather and a reduce-scatter per other split read, one all-reduce
    per set of ``reduce_axes`` and one for the norm."""
    for rank in runs["ranks"]:
        assert _counts(rank, f"{name}/step/calls") == \
            _counts(rank, f"{name}/contract_calls")
        assert _counts(rank, f"{name}/step/bytes") == \
            _counts(rank, f"{name}/contract_bytes")


def test_jax_compiles_other_collectives_than_the_contract(runs):
    """JAX's compiled step at HLO_SCENARIO is read beside the contract:
    the reference ran and XLA's pass counted its collectives.  Their
    numbers depend on XLA's version and are recorded in PERF.md, not
    held here; the port is held to its contract
    (``test_calls_and_bytes_are_the_contract``)."""
    got = runs["jax"][f"{HLO_SCENARIO}/hlo"]
    assert got.shape == (len(HLO_KINDS),) and got.min() >= 0 and got.sum() > 0


def test_trainer_steps_match_world_one(runs):
    """``TRAIN_STEPS`` Trainer steps on the ranks' slices at TRAIN's mesh
    and plan (the AdamW state made from the slices) against one rank's
    plan-none Trainer on the whole parameters and the same global
    batches: each step's loss and grad norm, and every parameter leaf
    gathered whole after the steps, within 1e-5 relative."""
    cname = TRAIN[0]
    cfg = configs(TL, TSSM, torch.float32)[cname]
    params = {k: torch.from_numpy(v) for k, v in flatten(
        runs["params"][cname]).items()}
    trainer = Trainer(
        loss_fn=lambda p, b: TL.lm_loss(p, b, cfg), params=unflatten(params),
        opt_cfg=TRAIN_OPT,
        cfg=TrainerConfig(total_steps=TRAIN_STEPS, log_every=1),
        data_fn=train_batch, device="cpu")
    want = []
    inner = trainer.step_fn

    def step(*args):
        res = inner(*args)
        want.append([float(res[2]["loss"]), float(res[2]["grad_norm"])])
        return res
    trainer.step_fn = step
    trainer.run()
    want = np.array(want)
    final = flatten(trainer.params)
    for rank in runs["ranks"]:
        got = rank["train/metrics"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        for path, p in final.items():
            w = p.numpy()
            gap = (np.abs(rank[f"train/param/{path}"] - w).max()
                   / (np.abs(w).max() + 1e-30))
            assert gap <= 1e-5, (path, gap)


# ---------------------------------------------------------------------------
# The store, in a world of one
# ---------------------------------------------------------------------------

def test_store_at_one_rank_issues_every_gather(world_of_one):
    """At one rank every split leaf is its own slice (no copy), every
    gather is still issued (an all-gather of one rank, a float32
    reduce-scatter backward) and gives the leaf back bit for bit, with
    its gradient in the leaf's dtype; ``reduce_axes`` and
    ``param_copies`` name what the trainer still sums."""
    ctx = from_mesh(world_of_one)
    cfg = TCONF.get("qwen3-14b").smoke
    params = TL.init_lm(0, cfg, device="cpu")
    plan = TCONF.get("qwen3-14b").plan
    specs = param_pspecs(params, plan, axis_sizes=mesh_sizes(ctx))
    assert specs["periods"]["0"]["attn"]["wq"]["w"] == (
        None, ("data", "model"), None)
    assert specs["unembed"]["table"] == ("model", None)
    assert specs["final_norm"]["scale"] == (None,)
    local = shard_params(params, specs, ctx)
    assert all(a is b for a, b in zip(TL.tree_leaves(local),
                                      TL.tree_leaves(params)))
    leaf = params["periods"]["0"]["mlp"]["wi"]["w"][0].bfloat16()
    leaf.requires_grad_(True)
    dsp.reset_calls()
    whole = gather_params({"w": leaf}, {"w": (("data", "model"), None)},
                          ctx)["w"]
    (whole.float() * 3).sum().backward()
    assert torch.equal(whole, leaf) and leaf.grad.dtype == torch.bfloat16
    assert torch.equal(leaf.grad, torch.full_like(leaf, 3))
    n = leaf.numel()
    assert dsp.calls == {"all-gather": 1, "reduce-scatter": 1}
    assert dsp.volume == {"all-gather": 2 * n, "reduce-scatter": 4 * n}
    names = ctx.mesh.mesh_dim_names
    assert reduce_axes(specs["unembed"]["table"], names) == ("data",)
    assert reduce_axes(specs["final_norm"]["scale"], names) == ("data",
                                                                "model")
    copies = param_copies(specs, ctx)
    assert set(TL.tree_leaves(copies)) == {1}
    back = unshard_params(local, specs, ctx)
    assert all(torch.equal(a, b) for a, b in zip(TL.tree_leaves(back),
                                                 TL.tree_leaves(params)))


def test_trainer_takes_the_layout_from_its_sharder(world_of_one):
    """The ``Trainer`` reads the mesh and the parameters' layout from the
    sharder its loss runs under, so the two cannot disagree: given a
    mesh as well it raises, and at one rank its step under qwen3-14b's
    own plan (slices that are whole leaves, every gather a copy) gives
    plan ``none``'s loss and grad norm within 1e-6 relative, with one
    all-reduce more than the grads' buckets, the clip's norm
    (``slices_norm``)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import make_train_step
    ctx = from_mesh(world_of_one)
    spec = TCONF.get("qwen3-14b")
    cfg = spec.smoke
    specs = param_pspecs(TL.init_lm(0, cfg, device="cpu"), spec.plan,
                         axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(world_of_one, spec.plan, schedule=TL.dsp_schedule(
        cfg, 1, seq=SEQ, batch=BATCH, joint=True), param_specs=specs)
    with pytest.raises(ValueError, match="not both"):
        make_train_step(lambda p, b: None, OptConfig(), mesh=world_of_one,
                        sharder=sharder)
    dcfg = DataConfig(task="lm_shift", vocab=cfg.vocab, seq=SEQ, batch=BATCH)
    got = {}
    for name, sh in (("layout", sharder), ("none", None)):
        trainer = Trainer(
            loss_fn=lambda p, b, sh=sh: TL.lm_loss(p, b, cfg, sharder=sh),
            params=TL.init_lm(0, cfg, device="cpu"), opt_cfg=OptConfig(),
            cfg=TrainerConfig(total_steps=1), device="cpu", sharder=sh,
            data_fn=lambda s: make_batch(dcfg, s, device="cpu"))
        dsp.reset_calls()
        _, _, got[name] = trainer.step_fn(trainer.params, trainer.opt_state,
                                          trainer.data_fn(0))
        got[name]["all-reduce"] = dsp.calls.get("all-reduce", 0)
    buckets = {reduce_axes(s, ctx.mesh.mesh_dim_names)
               for s in TL.tree_leaves(specs)} | {("data", "model")}
    assert got["layout"]["all-reduce"] == len(buckets - {()}) + 1
    for key in ("loss", "grad_norm"):
        want = float(got["none"][key])
        assert abs(float(got["layout"][key]) - want) <= 1e-6 * abs(want)
