"""The port's LM family under DSP, the parts that need no JAX mesh
(split from ``tests/test_torch_lm_dsp.py``, whose JAX subprocess and 8
gloo ranks run on another worker): the planners and schedules against
JAX's in this process, the Sharder at a world of one (one gloo rank in
this process) against plan ``none``, ``make_sharder``'s refusals, and
the train CLI under ``torchrun`` on a ``("data", "model")`` mesh, whose
four launches start together."""
import dataclasses
import math
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import pytest
import torch

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

from _torch_lmdsp_jax import BATCH, SEQ, configs, inputs  # noqa: E402
from _torch_lmdsp_worker import PLAN  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_world import world_of_one  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")


def _cfgs():
    return (configs(TL, TSSM, torch.float32),
            configs(JL, JSSM, jnp.float32))


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
    batch = {k: torch.from_numpy(v).long() for k, v in inputs().items()}
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

@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-370m"])
def test_world_of_one_matches_plan_none(world_of_one, arch):
    """At one rank every switch is still issued (an all-to-all of one
    rank moves no value) and the halo is not (no neighbour): the SMOKE
    configs' loss and grads under the mesh equal plan ``none``'s, and the
    calls are the contract at n = 1 (forward, recompute, transposes), as
    ``chip_smoke.py`` phase 16 (a) holds the full ones on the card."""
    cfg = {"qwen3-14b": TQC.SMOKE, "mamba2-370m": TMC.SMOKE}[arch]
    params = TL.init_lm(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in inputs().items()}
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


@pytest.fixture(scope="module")
def launches():
    """Every case's ``torchrun`` launch, all started at once (each spends
    most of its time starting its ranks): {case: its finished process}."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = {}
    try:
        for case, (arch, mesh) in CLI_CASES.items():
            world = math.prod(int(a) for a in mesh.split(","))
            procs[case] = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(world), "-m",
                 "repro_torch.launch.train", "--arch", arch, "--mesh", mesh,
                 "--device", "cpu", "--steps", "3"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        done = {}
        for case, p in procs.items():
            out, err = p.communicate(timeout=300)
            done[case] = subprocess.CompletedProcess(p.args, p.returncode,
                                                     out, err)
        return done
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def one_rank():
    """{arch: the train CLI's loss line at one rank without a mesh}."""
    from repro_torch.launch.train import main as train_main
    out = {}
    for arch in sorted({a for a, _ in CLI_CASES.values()}):
        hist = train_main(["--arch", arch, "--device", "cpu", "--steps",
                           "3"])["history"]
        out[arch] = f"loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}"
    return out


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_train_cli_with_mesh_under_torchrun(launches, one_rank, case):
    """``torchrun --nproc-per-node <dp * mp> -m repro_torch.launch.train
    --arch <lm> --mesh dp,mp --device cpu --steps 3`` at SMOKE size: every
    rank prints the plan it ran (the spec's own, ZeRO-3 and the vocab
    ring) and the same global loss, which falls and equals one rank's
    without a mesh to the 4 digits printed."""
    arch, mesh = CLI_CASES[case]
    world = math.prod(int(a) for a in mesh.split(","))
    proc = launches[case]
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
    assert lines[0] == one_rank[arch], lines[0]
