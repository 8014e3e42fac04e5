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
``JAX_COMPILED``.  The planners, a world of one and the train CLI under
``torchrun`` are ``tests/test_torch_lm_dsp_local.py``'s, so that the
suite's workers can run the two files side by side."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JL
from repro.models import ssm as JSSM
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TSSM

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_lmdsp_jax import (BATCH, GRAD_MESHES, HLO_KINDS,  # noqa: E402
                              SCENARIOS, SEQ, configs, inputs)
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 8 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("lmdsp"))
    params = {name: jax.tree_util.tree_map(
        np.asarray, JL.init_lm(jax.random.PRNGKey(0), cfg))
        for name, cfg in _cfgs()[1].items()}
    for name, tree in params.items():
        np.savez(os.path.join(work, f"params_{name}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), **inputs())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(8),
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
