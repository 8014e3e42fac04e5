"""jamba-1.5-large-398b on a ``("data", "model")`` mesh: 4 gloo ranks
(``tests/_torch_jamba_worker.py``) beside JAX on 4 simulated devices
(``tests/_torch_jamba_jax.py``, compiled with the cheaper passes of
``_torch_jax_flags.jax_xla_flags(4)``), on jamba's SMOKE config (two
periods of attention at 1 and SSD elsewhere, MoE on the odd layers with
4 experts top-2; float32) with JAX's init, at (1, 4) and (2, 2).

Training under the spec's plan (``dsp`` + ``ep`` + ZeRO-3): the forward
within 1e-5 of the largest |value| of JAX's under the same plan, the
loss within 1e-5 relative and each rank's grad slices within 1e-4 of the
leaf's largest |value| of ``jax.grad``'s; per rank the calls and bytes
exactly ``lm.remat_step(collective_contract(ep=True, moe_rows=))`` plus
``lm.param_contract``, the dispatch's rows from the run's routing
(``chip_smoke.route_rows``).  Serving under ``dsp`` + ``ep`` with ZeRO
off (JAX's serving rule): the prefill's and a decode step's logits
within 1e-5 of JAX's ``ServingEngine(mesh=, plan=)``, ``generate``'s
tokens JAX's on every rank, and per rank the prefill's and the decode
step's calls and bytes exactly ``lm.serve_contract``."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dsp_jax import flatten
from chip_smoke import lm_capacity, route_rows
from _torch_jamba_jax import (BATCH, MAX_LEN, MESHES, PROMPT, SEQ,
                              SERVE_PLAN, TRAIN_PLAN, WORLD, inputs)
from _torch_jax_flags import jax_xla_flags
from _torch_lmdsp_worker import KINDS
from repro.configs import jamba_1_5_large_398b as JJ
from repro.models import lm as JL
from repro_torch import bridge
from repro_torch.configs import jamba_1_5_large_398b as TJ
from repro_torch.models import lm as TL
from repro_torch.parallel.partition import ParallelPlan
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CFG = TJ.SMOKE
BAR = 1e-5


def _plan(mode_ep_zero) -> ParallelPlan:
    mode, ep, zero = mode_ep_zero
    return ParallelPlan(mode=mode, ep=ep, zero=zero)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("jamba"))
    tree = jax.tree_util.tree_map(np.asarray, JL.init_lm(
        jax.random.PRNGKey(0), JJ.SMOKE))
    np.savez(os.path.join(work, "params.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), **inputs(CFG.vocab))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(4), OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_jamba_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_jamba_worker.py"),
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
    return {"whole": bridge.params_from_numpy(tree, device="cpu"),
            "jax": dict(np.load(os.path.join(work, "jax.npz"))),
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)]}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assemble(runs, key, coord, shape, axes=(0, 1)):
    """The global tensor from each rank's block of ``key``: its data
    index's block on ``axes[0]``, its model index's on ``axes[1]``."""
    dp, n = shape
    parts = {tuple(r[coord]): r[key] for r in runs["ranks"]}
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(n)],
                                          axis=axes[1]) for i in range(dp)],
                          axis=axes[0])


def _routes(runs, prefix, coord, shape):
    """Per MoE call, the run's global (B, S, K) experts."""
    calls = sum(k.startswith(f"{prefix}/route") and k.endswith("/experts")
                for k in runs["ranks"][0])
    return [torch.from_numpy(_assemble(runs, f"{prefix}/route{i}/experts",
                                       coord, shape))
            for i in range(calls)]


# ---------------------------------------------------------------------------
# Training under the spec's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_forward_matches_jax(runs, name):
    """The ranks' ``forward(sharder=)`` shards, gathered, within 1e-5 of
    the largest |value| of JAX's forward under the same plan."""
    got = _assemble(runs, f"{name}/out", f"{name}/coord", MESHES[name])
    assert got.shape[:2] == (BATCH, SEQ)
    assert _rel(got, runs["jax"][f"{name}/out"]) < BAR


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_loss_and_grad_slices_match_jax(runs, name):
    """The loss summed over the world within 1e-5 relative of JAX's, and
    each rank's slice of each summed grad (the SSD projections', the
    experts' and the router's included) within 1e-4 of the leaf's largest
    |value| of the same slice of ``jax.grad``'s."""
    jx = runs["jax"]
    want = float(jx[f"{name}/loss"])
    keys = [k[len(f"{name}/grad/"):] for k in jx
            if k.startswith(f"{name}/grad/")]
    assert any("/ssm/" in k for k in keys) and any("/moe/" in k
                                                   for k in keys)
    for rank in runs["ranks"]:
        assert abs(float(rank[f"{name}/loss"]) - want) <= BAR * abs(want)
        for k in keys:
            whole = jx[f"{name}/grad/{k}"]
            index = rank[f"{name}/index/{k}"]
            cut = whole[tuple(slice(a, b) for a, b in index)]
            got = rank[f"{name}/grad/{k}"]
            gap = np.abs(got - cut).max() / max(np.abs(whole).max(), 1e-30)
            assert gap < 1e-4, (k, gap)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, the step's calls and bytes: the hooks' (the attention's
    and the SSD scan's switches, the conv halo, the MoE count exchange,
    dispatch and combine, with remat) plus the layouts' (ZeRO-3's gathers
    and reduce-scatters, an expert leaf gathered over ``data`` alone)."""
    dp, n = MESHES[name]
    plan = _plan(TRAIN_PLAN)
    routes = _routes(runs, name, f"{name}/coord", (dp, n))
    layout = TL.param_contract(CFG, runs["whole"], plan,
                               {"data": dp, "model": n})
    for rank in runs["ranks"]:
        i, j = rank[f"{name}/coord"]
        rows = route_rows(routes, TL.moe_meta(CFG).e_phys,
                          lm_capacity(CFG, SEQ), dp, n, i, j)
        hooks = TL.remat_step(TL.collective_contract(
            CFG, n, BATCH // dp, SEQ // n, dp=dp, ep=True, moe_rows=rows))
        want = [[hooks[p].get(k, 0) + layout[p].get(k, 0) for k in KINDS]
                for p in ("calls", "bytes")]
        assert rank[f"{name}/step"].tolist() == want, (i, j)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ranks_read_their_own_experts(runs, name):
    """``Sharder.whole`` reads a period's expert leaves whole over
    ``data`` and only the rank's E / n experts: the expert dim is never
    gathered over ``model``."""
    n = MESHES[name][1]
    e = TL.moe_meta(CFG).e_phys
    for rank in runs["ranks"]:
        assert rank[f"{name}/expert_shape"].tolist() == [
            e // n, CFG.d_model, CFG.d_ff]


# ---------------------------------------------------------------------------
# Serving under dsp + ep, ZeRO off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_served_logits_match_jax(runs, name, what):
    """The prefill's and a decode step's logits (each rank its rows and
    vocab chunk) within 1e-5 of the largest |value| of JAX's engine on
    the same mesh and plan."""
    key = f"{name}/serve"
    got = _assemble(runs, f"{key}/{what}", f"{key}/coord", MESHES[name],
                    axes=(0, -1))
    assert _rel(got, runs["jax"][f"{name}/{what}"]) < BAR


@pytest.mark.parametrize("name", sorted(MESHES))
def test_served_generate_matches_jax(runs, name):
    """``generate`` on every rank gives the tokens of JAX's engine on the
    same mesh and plan."""
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank[f"{name}/serve/generate"],
                                      runs["jax"][f"{name}/generate"])


@pytest.mark.parametrize("name", sorted(MESHES))
def test_served_calls_are_the_contract(runs, name):
    """Per rank, a prefill and its argmax, and a decode step and its
    argmax: exactly ``lm.serve_contract`` (the prefill's MoE dispatch with
    the rows ``route_rows`` finds in the run's routing; the decode step's
    one all-reduce a MoE layer, its SSM layers' gathers of y, its
    attention layer's softmax partials)."""
    dp, n = MESHES[name]
    plan = _plan(SERVE_PLAN)
    key = f"{name}/serve"
    routes = _routes(runs, key, f"{key}/coord", (dp, n))
    for rank in runs["ranks"]:
        i, j = rank[f"{key}/coord"]
        rows = route_rows(routes, TL.moe_meta(CFG).e_phys,
                          lm_capacity(CFG, PROMPT), dp, n, i, j)
        want = TL.serve_contract(CFG, n, runs["whole"], plan, dp=dp,
                                 prefill=(BATCH, PROMPT), max_len=MAX_LEN,
                                 moe_rows=rows)
        assert rank[f"{key}/prefill_counts"].tolist() == [
            [want[p].get(k, 0) for k in KINDS]
            for p in ("calls", "bytes")], (i, j)
        assert (rank[f"{key}/decode_counts"].tolist()
                == rank[f"{key}/decode_contract"].tolist()), (i, j)
