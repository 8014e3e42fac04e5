"""MoE under plan ``tp`` on a ``("data", "model")`` mesh, with ``ep`` and
without, under ZeRO-3 over ``data``: 4 gloo ranks
(``tests/_torch_moe_tp_worker.py``) beside JAX on 4 simulated devices
(``tests/_torch_moe_tp_jax.py``), on arctic-480b's SMOKE config (3
layers of MoE with a dense residual MLP, 8 experts top-2, GQA 8/2) and
qwen2-moe-a2.7b's (2 layers, 6 experts padded to 8, top-2, a shared
expert), each with JAX's init.

Scenarios ``_torch_moe_tp_jax.SCENARIOS``: both configs at (1, 4) and
(2, 2), with ``ep`` (the experts split over ``model`` by expert, the
tokens on the rank's sequence shard as under DSP, the shared and dense
MLPs column- and row-parallel) and without (each expert's hidden columns
split over ``model``, the MoE on the block's gathered sequence).  Bars:
the forward within 1e-5 of the largest |value|, the loss within 1e-5
relative and each rank's grad slices within 1e-4 of the leaf's largest
|value|, against JAX's ``forward`` and ``chunked_xent`` under ``tp``
(one run a config: JAX's values are the same on every mesh and plan);
the load-balance and dropped shares summed over the world against the
port's plan-none ``lm_loss`` on one rank; per rank the calls and bytes
exactly ``lm.remat_step(collective_contract(tp=True))`` plus
``lm.param_contract``."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_dsp_jax import flatten
from chip_smoke import lm_capacity, route_rows
from _torch_lmdsp_worker import KINDS
from _torch_moe_tp_jax import (BATCH, JAX_RUNS, JAX_XLA_FLAGS, SCENARIOS,
                               SEQ, WORLD, configs)
from repro.models import lm as JL
from repro_torch import bridge
from repro_torch.models import lm as TL
from repro_torch.parallel.partition import (ParallelPlan, param_pspecs,
                                            read_specs, reduce_axes)
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CFGS = configs("repro_torch")


def _env(**kw):
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                **kw)


def _inputs():
    rng = np.random.RandomState(5)
    return {"tokens": rng.randint(0, 512, (BATCH, SEQ)),
            "labels": rng.randint(0, 512, (BATCH, SEQ))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("moe_tp"))
    trees = {c: jax.tree_util.tree_map(np.asarray, JL.init_lm(
        jax.random.PRNGKey(0), cfg)) for c, cfg in configs("repro").items()}
    for c, tree in trees.items():
        np.savez(os.path.join(work, f"params_{c}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), **_inputs())
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_moe_tp_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_moe_tp_worker.py"),
                            str(r), str(WORLD), work]
    env = _env(JAX_PLATFORMS="cpu", XLA_FLAGS=JAX_XLA_FLAGS)
    procs, logs = {}, {}
    try:
        for name, cmd in cmds.items():
            logs[name] = open(os.path.join(work, f"{name}.log"), "w+")
            procs[name] = subprocess.Popen(cmd, env=env, stdout=logs[name],
                                           stderr=subprocess.STDOUT)
        for p in procs.values():
            p.wait(timeout=240)
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
    return {"params": trees,
            "jax": dict(np.load(os.path.join(work, "jax.npz"))),
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)]}


@pytest.fixture(scope="module")
def one_rank(runs):
    """Per config, the port's plan-none ``lm_loss`` metrics on one rank:
    the load-balance aux and the dropped share."""
    out = {}
    batch = {k: torch.from_numpy(v).long() for k, v in _inputs().items()}
    for c, tree in runs["params"].items():
        params = bridge.params_from_numpy(tree, device="cpu")
        with torch.no_grad():
            _, metrics = TL.lm_loss(params, batch, CFGS[c], backend="ref")
        out[c] = {k: float(metrics[k]) for k in ("moe_load_balance",
                                                 "moe_dropped")}
    return out


def _jax_run(name):
    """The JAX run of the scenario's config."""
    return next(r for r in JAX_RUNS
                if SCENARIOS[r][0] == SCENARIOS[name][0])


def _assemble(runs, name, key):
    """The global (B, S, ...) tensor from each rank's (B/dp, S/n, ...)
    shard, placed by its coordinate."""
    _, (dp, n), _ = SCENARIOS[name]
    parts = {tuple(r[f"{name}/coord"]): r[f"{name}/{key}"]
             for r in runs["ranks"]}
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(n)],
                                          axis=1) for i in range(dp)], axis=0)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _grads(out, run):
    return {k[len(f"{run}/grad/"):]: v for k, v in out.items()
            if k.startswith(f"{run}/grad/")}


@pytest.mark.parametrize("cname", sorted(CFGS))
def test_configs_and_param_counts_match_jax(cname):
    """The port's configs, published and SMOKE, field for field and in
    ``param_counts``, and the spec's plan and source, against JAX's;
    arctic-480b's published config counts ~480B parameters."""
    import importlib
    mod = {"arctic": "arctic_480b", "qwen2moe": "qwen2_moe_a2_7b"}[cname]
    jconf = importlib.import_module(f"repro.configs.{mod}")
    tconf = importlib.import_module(f"repro_torch.configs.{mod}")
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "n_experts", "top_k", "n_shared",
                  "shared_ff", "dense_ff", "norm_topk", "ep_pad",
                  "attn_bias", "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert str(t.dtype).split(".")[-1] == jax.numpy.dtype(j.dtype).name
        assert TL.param_counts(t) == JL.param_counts(j)
    assert (str(tconf.CONFIG.cache_dtype).split(".")[-1]
            == jax.numpy.dtype(jconf.CONFIG.cache_dtype).name
            if jconf.CONFIG.cache_dtype is not None
            else tconf.CONFIG.cache_dtype is None)
    assert tconf.SPEC.plan == ParallelPlan(
        **{f: getattr(jconf.SPEC.plan, f)
           for f in ("mode", "ep", "zero", "shard_vocab")})
    assert tconf.SPEC.source == jconf.SPEC.source
    if cname == "arctic":
        total = TL.param_counts(tconf.CONFIG)["total"]
        assert abs(total / 1e9 - 480) < 0.05 * 480, total


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_forward_matches_jax(runs, name):
    """The ranks' ``forward(sharder=)`` shards, gathered, within 1e-5 of
    the largest |value| of JAX's forward under ``tp``."""
    want = runs["jax"][f"{_jax_run(name)}/out"]
    assert _rel(_assemble(runs, name, "out"), want) < 1e-5


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grads_match_jax(runs, name):
    """The cross-entropy summed over the world within 1e-5 of JAX's, and
    each rank's slice of each summed grad within 1e-4 of the leaf's
    largest |value| of the same slice of ``jax.grad``'s."""
    run = _jax_run(name)
    want_loss = float(runs["jax"][f"{run}/loss"])
    grads = _grads(runs["jax"], run)
    for rank in runs["ranks"]:
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), loss
        for path, want in grads.items():
            got = rank[f"{name}/grad/{path}"]
            index = rank[f"{name}/index/{path}"]
            cut = want[tuple(slice(a, b) for a, b in index)]
            gap = np.abs(got - cut).max() / max(np.abs(want).max(), 1e-30)
            assert gap < 1e-4, (path, gap)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_aux_shares_sum_to_one_rank(runs, one_rank, name):
    """The ranks' shares of the load-balance aux and of the dropped pairs
    sum over the world to one rank's: without ``ep`` every model rank
    routes the same whole sequence, and each reports a 1/n share."""
    want = one_rank[SCENARIOS[name][0]]
    lb = sum(float(r[f"{name}/lb"]) for r in runs["ranks"])
    dropped = sum(float(r[f"{name}/dropped"]) for r in runs["ranks"])
    assert abs(lb - want["moe_load_balance"]) <= 1e-5 * want[
        "moe_load_balance"], lb
    assert abs(dropped - want["moe_dropped"]) < 1e-6, dropped


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, the step's calls and bytes: per attention and MLP block
    and per MoE layer a gather of the whole sequence and a
    reduce-scatter (under ``ep`` around the shared or dense MLP, the
    experts' dispatch and combine with their bytes the rows
    ``route_rows`` finds in the run's routing), each MoE layer's count
    exchange, all three times over with their transposes
    (``remat_step``), plus the layouts' (an expert leaf, a column or a
    row leaf gathered over ``data`` only)."""
    cname, (dp, n), ep = SCENARIOS[name]
    cfg = CFGS[cname]
    plan = ParallelPlan(mode="tp", ep=ep, zero=True)
    whole = bridge.params_from_numpy(runs["params"][cname], device="cpu")
    layout = TL.param_contract(cfg, whole, plan, {"data": dp, "model": n})
    routes = None
    if ep:
        calls = sum(k.startswith(f"{name}/route") for k in runs["ranks"][0])
        routes = [torch.from_numpy(_assemble(runs, name,
                                             f"route{i}/experts"))
                  for i in range(calls)]
    for rank in runs["ranks"]:
        i, j = rank[f"{name}/coord"]
        rows = (route_rows(routes, TL.moe_meta(cfg).e_phys,
                           lm_capacity(cfg, SEQ), dp, n, i, j)
                if ep else None)
        hooks = TL.remat_step(TL.collective_contract(
            cfg, n, BATCH // dp, SEQ // n, dp=dp, ep=ep, moe_rows=rows,
            tp=True))
        for part in ("calls", "bytes"):
            want = [hooks[part].get(k, 0) + layout[part].get(k, 0)
                    for k in KINDS]
            assert rank[f"{name}/step/{part}"].tolist() == want, (part, i, j)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ranks_read_their_own_slices(runs, name):
    """``Sharder.whole`` gives a period's expert leaves whole over
    ``data`` and, over ``model``, the rank's E / n experts under ``ep``
    or its F / n hidden columns of every expert without; the shared or
    dense MLP's ``wi`` its F / n columns either way."""
    cname, (_, n), ep = SCENARIOS[name]
    cfg = CFGS[cname]
    e, d, f = TL.moe_meta(cfg).e_phys, cfg.d_model, cfg.d_ff
    ff = cfg.dense_ff or cfg.shared_ff
    for rank in runs["ranks"]:
        assert rank[f"{name}/expert_shape"].tolist() == (
            [e // n, d, f] if ep else [e, d, f // n])
        assert rank[f"{name}/mlp_shape"].tolist() == [d, ff // n]


@pytest.mark.parametrize("ep", [True, False])
def test_expert_leaves_layout_under_tp(ep):
    """Under ``tp`` + ZeRO-3 an expert leaf is split over ``model`` (by
    expert under ``ep``, by hidden column without) and ``data``; the
    model reads it gathered over ``data`` only, and its grad is summed
    over nothing more.  The router and the shared gate stay whole over
    ``model`` (gathered over ``data``), their grads summed over it."""
    cfg = CFGS["qwen2moe"]
    plan = ParallelPlan(mode="tp", ep=ep, zero=True)
    specs = param_pspecs(TL.init_lm(0, cfg, device="cpu"), plan,
                         axis_sizes={"data": 2, "model": 2})
    moe = specs["periods"]["0"]["moe"]
    read = read_specs(specs, plan)["periods"]["0"]["moe"]
    names = ("data", "model")
    want = ((None, "model", "data", None) if ep
            else (None, None, "data", "model"))
    assert moe["wi"] == want
    assert read["wi"] == tuple(None if a == "model" else a for a in want)
    assert reduce_axes(moe["wi"], names) == ()
    for gate in ("router", "shared_gate"):
        assert moe[gate]["w"] == (None, "data", None)
        assert reduce_axes(moe[gate]["w"], names) == ("model",)
    assert moe["shared"]["wi"]["w"] == (None, "data", "model")
    assert moe["shared"]["wo"]["w"] == (None, "model", "data")

