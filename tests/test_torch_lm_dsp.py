"""The port's LM family under DSP (``parallel.partition.Sharder`` on a
``("data", "model")`` mesh, ``models.lm.forward``/``lm_loss(sharder=)``)
against the JAX package's on the CPU: 8 gloo processes
(``tests/_torch_lmdsp_worker.py``) on one ``FileStore``, and the JAX side
on 8 simulated devices in a subprocess (``tests/_torch_lmdsp_jax.py``).

Configs (``_torch_lmdsp_jax.configs``, f32, weights from JAX's init):
``hybrid`` (attention and SSM layers, GQA 4/2: at n = 4 the K/V heads are
repeated up to 4, at n = 2 they switch on their own), ``mha`` (8/8
heads) and ``kvg`` (6 q, 2 K/V heads: q does not divide 4, K/V are
gathered).  JAX runs ``backend="ref"`` and ``remat=False``; the port its
plain versions with ``remat`` on.  Bars, those of
``tests/test_torch_dsp.py``: the gathered forward within 2e-4 of the
largest |value| of JAX's; the loss within 1e-5 relative and every
gradient leaf within 1e-4 of its max against ``jax.grad`` of JAX's
``lm_loss`` on the same mesh ((1, 4) for the (4, 2) and unfused
scenarios).  Per-rank calls and bytes are exact: the hooks' contract
(``lm.collective_contract``), counted by hand in ``FORWARD_CALLS``;
JAX's compiled counts at one scenario stand beside it in
``JAX_COMPILED``."""
import dataclasses
import math
import os
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import mamba2_370m as JMC
from repro.configs import qwen3_14b as JQC
from repro.models import lm as JL
from repro.models import ssm as JSSM
from repro_torch.configs import mamba2_370m as TMC
from repro_torch.configs import qwen3_14b as TQC
from repro_torch.core import dsp
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TSSM
from repro_torch.parallel.partition import (ParallelPlan, make_sharder,
                                            param_pspecs)

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_lmdsp_jax import (BATCH, GRAD_MESHES, HLO_KINDS,  # noqa: E402
                              SCENARIOS, SEQ, VOCAB, configs)
from _torch_lmdsp_worker import KINDS, PLAN  # noqa: E402

WORLD = 8
# per rank, one forward: the hooks' contract counted by hand.  hybrid has
# 6 SSM layers (1 permute, 2 all-gathers, 3 all-to-alls each) and 2
# attention layers: at n = 4 its 2 K/V heads repeat to 4 = q's, so q/k/v
# stack into 1 all-to-all in and 1 out; at n = 2 (4x2) K/V switch on their
# own, 2 in and 1 out; unfused 3 in and 1 out.  mha: 4 layers of 1 + 1.
# kvg: 2 layers of 1 all-gather of the stacked K/V.
FORWARD_CALLS = {
    "hybrid/1x4": {"all-to-all": 22, "all-gather": 12,
                   "collective-permute": 6},
    "hybrid/2x4": {"all-to-all": 22, "all-gather": 12,
                   "collective-permute": 6},
    "hybrid/4x2": {"all-to-all": 24, "all-gather": 12,
                   "collective-permute": 6},
    "hybrid/1x4/unfused": {"all-to-all": 26, "all-gather": 12,
                           "collective-permute": 6},
    "mha/1x4": {"all-to-all": 8},
    "mha/2x4": {"all-to-all": 8},
    "kvg/1x4": {"all-gather": 2},
    "kvg/2x4": {"all-gather": 2},
}
# JAX's compiled forward of the same hooks at HLO_SCENARIO
# (``parse_collectives`` of the jitted ``forward``, jax on the CPU), which
# departs from the contract by name: XLA keeps each attention output
# head-sharded through ``wo`` and all-reduces the partial products (an
# all-reduce where the hooks switch back), and it moves the conv's halo
# and reshards what it cannot tile ("involuntary full rematerialization")
# with dozens of collective-permutes.  PERF.md lists the other scenarios'
# (the JAX helper counts every scenario's).
HLO_SCENARIO = "hybrid/1x4"
JAX_COMPILED = {"all-to-all": 20, "all-gather": 12, "all-reduce": 2,
                "collective-permute": 66}


def _cfgs():
    return (configs(TL, TSSM, torch.float32),
            configs(JL, JSSM, jnp.float32))


def _inputs():
    rng = np.random.RandomState(3)
    return {k: rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 8 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("lmdsp"))
    params = {name: jax.tree_util.tree_map(
        np.asarray, JL.init_lm(jax.random.PRNGKey(0), cfg))
        for name, cfg in _cfgs()[1].items()}
    for name, tree in params.items():
        np.savez(os.path.join(work, f"params_{name}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), **_inputs())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_lmdsp_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_lmdsp_worker.py"),
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
    return {"params": params, "ranks": ranks,
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


def _ranks_of(runs, name):
    """The ranks that ran scenario ``name`` (its mesh's ranks)."""
    return [r for r in runs["ranks"] if f"{name}/coord" in r]


def _counts(rank, key):
    return {k: n for k, n in zip(KINDS, rank[key].tolist()) if n}


# ---------------------------------------------------------------------------
# Against JAX, on the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_forward_matches_jax(runs, name):
    """Each rank's ``forward(sharder=)`` on its shard (batch slice,
    sequence chunk), gathered, matches JAX's ``forward`` on the same mesh
    within 2e-4 of the largest |value|."""
    dp, sp = SCENARIOS[name][1]
    ranks = _ranks_of(runs, name)
    assert len(ranks) == dp * sp
    rows = [[None] * sp for _ in range(dp)]
    for rank in ranks:
        d, s = rank[f"{name}/coord"].tolist()
        rows[d][s] = rank[f"{name}/out"]
    got = np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)
    want = runs["jax"][f"{name}/out"]
    assert got.shape == want.shape == (BATCH, SEQ, want.shape[-1])
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-4, rel


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grads_match_jax(runs, name):
    """Each rank's ``lm_loss(sharder=)`` on its shard, divided by the
    global token count, with its grads, summed over the world in one
    all-reduce, equals JAX's global-mean loss within 1e-5 relative and its
    gradient within 1e-4 of each leaf's max."""
    cname, shape, _ = SCENARIOS[name]
    ref = f"{cname}/{shape[0]}x{shape[1]}" if shape in GRAD_MESHES \
        else f"{cname}/1x4"
    jx = runs["jax"]
    paths = list(flatten(runs["params"][cname]))
    want_loss = float(jx[f"{ref}/loss"])
    for rank in _ranks_of(runs, name):
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss,
                                                                 want_loss)
        for path in paths:
            g, w = rank[f"{name}/grad/{path}"], jx[f"{ref}/grad/{path}"]
            assert g.shape == w.shape, path
            gap = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
            assert gap <= 1e-4, (path, gap)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, one forward issues exactly the hooks' contract, in calls
    (``FORWARD_CALLS``, by hand) and bytes (``collective_contract``).  A
    training step with remat issues the forward's calls twice (forward,
    recompute) and their transposes once: all-to-alls and permutes three
    times, all-gathers twice and as many reduce-scatters, and one
    all-reduce of the grads."""
    want = FORWARD_CALLS[name]
    for rank in _ranks_of(runs, name):
        assert _counts(rank, f"{name}/contract") == want
        assert _counts(rank, f"{name}/fwd/calls") == want
        fwd_bytes = rank[f"{name}/fwd/bytes"]
        np.testing.assert_array_equal(fwd_bytes,
                                      rank[f"{name}/contract_bytes"])
        step = {k: 3 * n for k, n in want.items()}
        if "all-gather" in want:
            step["all-gather"] = 2 * want["all-gather"]
            step["reduce-scatter"] = want["all-gather"]
        step["all-reduce"] = 1
        assert _counts(rank, f"{name}/grad/calls") == step
        by = dict(zip(KINDS, fwd_bytes.tolist()))
        got = dict(zip(KINDS, rank[f"{name}/grad/bytes"].tolist()))
        for kind in ("all-to-all", "collective-permute"):
            assert got[kind] == 3 * by[kind], kind
        assert got["all-gather"] == 2 * by["all-gather"]
        assert got["reduce-scatter"] == by["all-gather"]


def test_jax_compiles_other_collectives_than_the_hooks_name(runs):
    """JAX's compiled forward of the same hooks at HLO_SCENARIO, recorded
    beside the contract: it is not the bar (see ``JAX_COMPILED``), and the
    port is not bent to it."""
    got = {k: n for k, n in zip(HLO_KINDS,
                                runs["jax"][f"{HLO_SCENARIO}/hlo"].tolist())
           if n}
    assert got == JAX_COMPILED
    assert got != FORWARD_CALLS[HLO_SCENARIO]


# ---------------------------------------------------------------------------
# The plans, in one process
# ---------------------------------------------------------------------------

def _full_cfgs():
    return {"qwen3-14b": (TQC.CONFIG, JQC.CONFIG),
            "mamba2-370m": (TMC.CONFIG, JMC.CONFIG)}


PLAN_CASES = {**{f"{c}/n4": (c, 4, SEQ, BATCH) for c in configs(
    TL, TSSM, torch.float32)},
    "qwen3-14b/n4": ("qwen3-14b", 4, 4096, 1),
    "mamba2-370m/n4": ("mamba2-370m", 4, 4096, 1),
    "mamba2-370m/n1": ("mamba2-370m", 1, 4096, 8)}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_stages_and_schedules_match_jax(case):
    """``stages``, ``stage_period`` and ``dsp_schedule`` (forward-only,
    joint, and with a forced backward) give JAX's stages, plans and
    planned bytes, for the test configs and the two full configs at
    ``chip_smoke.py``'s shapes."""
    cname, n, seq, batch = PLAN_CASES[case]
    if cname in _full_cfgs():
        tc, jc = _full_cfgs()[cname]
    else:
        tc, jc = (c[cname] for c in _cfgs())
    kw = dict(seq=seq, batch=batch)
    assert TL.stage_period(tc) == JL.stage_period(jc)
    assert [(s.name, s.compute_dims, s.shape, s.dtype_bytes)
            for s in TL.stages(tc, **kw)] == \
        [(s.name, s.compute_dims, s.shape, s.dtype_bytes)
         for s in JL.stages(jc, **kw)]
    period = TL.stage_period(tc)
    for extra in ({}, {"joint": True}, {"bwd_dims": (2,) * period}):
        t, j = (m.dsp_schedule(c, n, **kw, **extra)
                for m, c in ((TL, tc), (JL, jc)))
        assert (t.dims, t.bwd_dims, t.initial, t.final, t.mirrored) == \
            (j.dims, j.bwd_dims, j.initial, j.final, j.mirrored)
        assert t.per_device_bytes(n) == j.per_device_bytes(n)


def test_sharder_without_a_mesh_is_the_identity():
    """``make_sharder(None, ...)`` (any mode) leaves every hook the
    identity: ``lm_loss`` with it equals plan ``none``'s exactly, and
    ``seq_halo`` has nothing to send."""
    cfg = configs(TL, TSSM, torch.float32)["hybrid"]
    params = TL.init_lm(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _inputs().items()}
    want, _ = TL.lm_loss(params, batch, cfg, remat=False)
    sh = make_sharder(None, ParallelPlan(mode="dsp"),
                      schedule=TL.dsp_schedule(cfg, 4, seq=SEQ, batch=BATCH))
    assert (sh.resid_dim, sh.mixer_dim) == (1, 2)
    got, _ = TL.lm_loss(params, batch, cfg, sharder=sh, remat=False)
    assert torch.equal(got, want)
    assert sh.seq_halo(torch.zeros(1, 8, 4), 3) is None
    assert sh.mixer_slice(8) == (0, 8)


def test_local_groups_map_each_head_to_its_group():
    """K2 sees, for each of the rank's heads, its global head's group:
    whole groups sliced (G >= n), the one group (mamba2-370m: 32 heads, G
    1, 8 a rank), or a group per head where neither holds."""
    b = torch.arange(6.0).reshape(1, 1, 6, 1).expand(1, 2, 6, 1)
    for h, h0, hl, want in ((12, 4, 4, [2, 3]), (12, 2, 2, [1]),
                            (12, 3, 3, [1, 2, 2])):
        got, _ = TSSM._local_groups(b, b, h, h0, hl)
        assert got[0, 0, :, 0].tolist() == want, (h, h0, hl)
        rep = hl // got.shape[2]
        heads = [(h0 + j) // (h // 6) for j in range(hl)]
        assert [got[0, 0, j // rep, 0].item() for j in range(hl)] == heads


# ---------------------------------------------------------------------------
# A world of one, in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, on a FileStore."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            from repro_torch.launch.mesh import make_mesh
            yield make_mesh((1, 1), ("data", "model"), "cpu")
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-370m"])
def test_world_of_one_matches_plan_none(world_of_one, arch):
    """At one rank every switch is still issued (an all-to-all of one
    rank moves no value) and the halo is not (no neighbour): the SMOKE
    configs' loss and grads under the mesh equal plan ``none``'s, and the
    calls are the contract at n = 1 (forward, recompute, transposes), as
    ``chip_smoke.py`` phase 16 (a) holds the full ones on the card."""
    cfg = {"qwen3-14b": TQC.SMOKE, "mamba2-370m": TMC.SMOKE}[arch]
    params = TL.init_lm(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _inputs().items()}
    sh = make_sharder(world_of_one, PLAN, schedule=TL.dsp_schedule(
        cfg, 1, seq=SEQ, batch=BATCH, joint=True))
    flat = TL.tree_leaves(params)

    def loss_grads(sharder):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        it = iter(leaves)
        tree = TL.tree_map(lambda p: next(it), params)
        loss, _ = TL.lm_loss(tree, batch, cfg, sharder=sharder)
        return loss, torch.autograd.grad(loss, leaves)

    want_loss, want = loss_grads(None)
    dsp.reset_calls()
    got_loss, got = loss_grads(sh)
    calls = dict(dsp.calls)
    assert torch.allclose(got_loss, want_loss, rtol=1e-6, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)
    fwd = TL.collective_contract(cfg, 1, BATCH, SEQ)
    assert "collective-permute" not in fwd["calls"]
    assert calls == TL.remat_step(fwd)["calls"]


def _refusals():
    cfg = configs(TL, TSSM, torch.float32)["mha"]
    joint = TL.dsp_schedule(cfg, 1, seq=SEQ, batch=BATCH)
    ok = ParallelPlan(mode="dsp", zero=False, shard_vocab=False)
    return {
        "zero": (ParallelPlan(mode="dsp", shard_vocab=False), None,
                 ValueError),
        "shard_vocab": (ParallelPlan(mode="dsp", zero=False), None,
                        ValueError),
        "strategies": (ok, dataclasses.replace(
            joint, strategies=("dsp", "ulysses", "dsp") * cfg.n_layers),
            NotImplementedError),
        "non_mirrored": (ok, TL.dsp_schedule(
            cfg, 1, seq=SEQ, batch=BATCH, bwd_dims=(2, 2, 2)),
            NotImplementedError),
        "overlap": (ok, dataclasses.replace(joint, overlap="chunked"),
                    NotImplementedError),
        "none_on_a_mesh": (ParallelPlan(mode="none"), None, ValueError),
        "unknown_mode": (ParallelPlan(mode="fsdp"), None, ValueError),
        "entry_not_on_the_sequence": (ok, dataclasses.replace(
            joint, initial=2), ValueError),
        "2d_schedule": (ok, types.SimpleNamespace(layouts=()), TypeError),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_make_sharder_refuses(world_of_one, case):
    """On a mesh ``make_sharder`` runs plan ``dsp`` (``ep`` on or off)
    under a mirrored all-"dsp" schedule without overlap that enters and
    leaves on the sequence; everything else raises, what is not ported yet
    (embedded strategies, a planned backward, ``overlap``) as
    ``NotImplementedError`` naming its ROADMAP item (plan ``tp``'s
    refusals are ``tests/test_torch_tp.py``'s).  A plan with ``zero`` or
    ``shard_vocab`` splits the parameters: it is refused without their
    layout and runs with it (``param_specs``, ``param_pspecs`` of the
    global tree)."""
    plan, schedule, exc = _refusals()[case]
    with pytest.raises(exc) as info:
        make_sharder(world_of_one, plan, schedule=schedule)
    if exc is NotImplementedError:
        assert "ROADMAP" in str(info.value)
    if case in ("zero", "shard_vocab"):
        cfg = configs(TL, TSSM, torch.float32)["mha"]
        specs = param_pspecs(TL.init_lm(0, cfg, device="cpu"), plan,
                             axis_sizes={"data": 1, "model": 1})
        sharder = make_sharder(world_of_one, plan, schedule=schedule,
                               param_specs=specs)
        assert sharder.param_specs is specs and sharder.plan == plan


def test_partial_permutes():
    """``ppermute`` takes whole permutations only: a shift that leaves a
    rank out (r -> r + 1) is refused before any call, so the conv's halo
    travels as the cyclic shift and rank 0 zeroes the block it gets."""
    with pytest.raises(ValueError):
        dsp._peers([(0, 1), (1, 2)], 0)
    with pytest.raises(ValueError):
        dsp._peers([(0, 1), (0, 2)], 0)
    assert dsp._peers([(0, 1), (1, 2), (2, 0)], 0) == (1, 2)


# ---------------------------------------------------------------------------
# The train CLI under torchrun
# ---------------------------------------------------------------------------

# case -> (arch, --mesh)
CLI_CASES = {"qwen3-14b": ("qwen3-14b", "1,2"),
             "mamba2-370m": ("mamba2-370m", "1,2"),
             "qwen3-14b/2x2": ("qwen3-14b", "2,2"),
             "mamba2-370m/2x2": ("mamba2-370m", "2,2")}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_train_cli_with_mesh_under_torchrun(case):
    """``torchrun --nproc-per-node <dp * mp> -m repro_torch.launch.train
    --arch <lm> --mesh dp,mp --device cpu --steps 3`` at SMOKE size: every
    rank prints the plan it ran (the spec's own, ZeRO-3 and the vocab
    ring) and the same global loss, which falls and equals one rank's
    without a mesh to the 4 digits printed."""
    arch, mesh = CLI_CASES[case]
    world = math.prod(int(a) for a in mesh.split(","))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), "-m", "repro_torch.launch.train",
         "--arch", arch, "--mesh", mesh, "--device", "cpu", "--steps", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    plans = [l for l in proc.stdout.splitlines() if l.startswith("plan ")]
    assert len(plans) == world and len(set(plans)) == 1, proc.stdout
    assert plans[0] == (
        "plan ParallelPlan(mode='dsp', ep=False, zero=True, "
        "shard_vocab=True)"), plans[0]
    lines = [l for l in proc.stdout.splitlines() if l.startswith("loss ")]
    assert len(lines) == world and len(set(lines)) == 1, proc.stdout
    first, last = (float(v) for v in lines[0].split()[1::2])
    assert last < first, lines[0]
    from repro_torch.launch.train import main as train_main
    hist = train_main(["--arch", arch, "--device", "cpu", "--steps", "3"])
    assert lines[0] == (f"loss {hist['history'][0][1]:.4f} -> "
                        f"{hist['history'][-1][1]:.4f}"), lines[0]
