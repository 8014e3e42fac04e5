"""MoE under DSP on a ``("data", "model")`` mesh, with ``ep`` and
without, under ZeRO-3: 4 gloo ranks (``tests/_torch_moe_ep_worker.py``)
over ``_torch_moe_ep_jax.SCENARIOS`` at (1, 4) and (2, 2), against JAX's
forward (``_torch_moe_ep_jax.jax_forward``) and the port at one rank.

Bars: the forward within 2e-3 of the largest |value| of JAX's
(``tests/md_scenarios.py``'s ``lm_parallel_equivalence`` bar); the loss
within 1e-5 and each rank's grad slices within 1e-4 of the leaf's
largest |value| of the port's plan-none ``lm_loss`` on one rank; per
rank the calls and bytes exactly ``lm.remat_step`` of
``lm.collective_contract`` (with ``chip_smoke.route_rows`` of the run's
routing) plus ``lm.param_contract``; the dropped pairs of each MoE call
exactly JAX's, as the ranks count them and as the run's routing gives
them (``chip_smoke.kept_pairs``)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dsp_jax import flatten
from chip_smoke import kept_pairs, lm_capacity, route_rows
from _torch_lmdsp_worker import KINDS
from _torch_moe_ep_jax import (BATCH, SCENARIOS, SEQ, configs, jax_forward,
                               params_np, tokens)
from repro_torch import bridge
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TSSM
from repro_torch.parallel.partition import (ParallelPlan, param_pspecs,
                                            read_specs, reduce_axes)
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
CFGS = configs(TL, TSSM, torch.float32)


def _labels():
    return np.random.RandomState(6).randint(0, 128, (BATCH, SEQ))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks once over every scenario."""
    work = str(tmp_path_factory.mktemp("moe_ep"))
    trees = {name: params_np(name) for name in CFGS}
    for name, tree in trees.items():
        np.savez(os.path.join(work, f"params_{name}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"), tokens=tokens(),
             labels=_labels())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs, logs = [], []
    try:
        for r in range(WORLD):
            logs.append(open(os.path.join(work, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "_torch_moe_ep_worker.py"),
                 str(r), str(WORLD), work], env=env, stdout=logs[r],
                stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        logs[r].seek(0)
        text = logs[r].read()
        logs[r].close()
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return {"params": trees,
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)]}


@pytest.fixture(scope="module")
def refs(runs):
    """Per config: JAX's forward, load-balance aux and dropped shares, and
    the port's plan-none loss and grads at one rank (remat on)."""
    out = {}
    for name, tree in runs["params"].items():
        x, lb, dropped = jax_forward(name, tree, tokens())
        params = bridge.params_from_numpy(tree, device="cpu")
        leaves = TL.tree_map(lambda p: p.requires_grad_(True), params)
        batch = {"tokens": torch.from_numpy(tokens()).long(),
                 "labels": torch.from_numpy(_labels()).long()}
        loss, _ = TL.lm_loss(leaves, batch, CFGS[name], backend="ref")
        grads = torch.autograd.grad(loss, TL.tree_leaves(leaves))
        flat = flatten(params)
        out[name] = {"x": x, "lb": lb, "dropped": dropped,
                     "loss": float(loss.detach()),
                     "grads": dict(zip(flat, (g.numpy() for g in grads)))}
    return out


def _assemble(runs, name, key):
    """The global (B, S, ...) tensor from each rank's (B/dp, S/n, ...)
    shard of ``name/key``, placed by its coordinate."""
    _, (dp, n), _ = SCENARIOS[name]
    parts = {}
    for rank in runs["ranks"]:
        parts[tuple(rank[f"{name}/coord"])] = rank[f"{name}/{key}"]
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(n)],
                                          axis=1) for i in range(dp)],
                          axis=0)


def _routes(runs, name):
    """The run's global routing: per MoE call, the experts (B, S, K),
    assembled from the ranks' own records."""
    calls = sum(k.startswith(f"{name}/route") and k.endswith("/experts")
                for k in runs["ranks"][0])
    return [torch.from_numpy(_assemble(runs, name, f"route{i}/experts"))
            for i in range(calls)]


def _kept(runs, name):
    """Per MoE call, the (B, S, K) pairs the run's routing keeps."""
    cfg = CFGS[SCENARIOS[name][0]]
    cap = lm_capacity(cfg, SEQ)
    return [kept_pairs(e, TL.moe_meta(cfg).e_phys, cap)
            for e in _routes(runs, name)]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_forward_matches_jax(runs, refs, name):
    """The ranks' ``forward(sharder=)`` shards, gathered, within 2e-3 of
    the largest |value| of JAX's forward (1e-6 or so in practice)."""
    got = _assemble(runs, name, "out")
    want = refs[SCENARIOS[name][0]]["x"]
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-3, rel


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grad_slices_match_one_rank(runs, refs, name):
    """The loss summed over the world within 1e-5 of one rank's, and each
    rank's slice of each summed grad within 1e-4 of the leaf's largest
    |value| of the same slice of one rank's grad."""
    ref = refs[SCENARIOS[name][0]]
    for rank in runs["ranks"]:
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"]), loss
        for path, want in ref["grads"].items():
            got = rank[f"{name}/grad/{path}"]
            index = rank[f"{name}/index/{path}"]
            cut = want[tuple(slice(a, b) for a, b in index)]
            gap = np.abs(got - cut).max() / max(np.abs(want).max(), 1e-30)
            assert gap < 1e-4, (path, gap)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, the step's calls and bytes: the hooks' (the count
    exchange once a MoE call forward and once more in the recompute, the
    dispatch and combine three times over under ``ep``, their bytes the
    rows ``route_rows`` finds in the run's routing) plus the layouts'
    (an expert leaf gathered only over ``data`` under ``ep``)."""
    cname, (dp, n), (ep, zero) = SCENARIOS[name]
    cfg = CFGS[cname]
    plan = ParallelPlan(mode="dsp", ep=ep, zero=zero)
    routes = _routes(runs, name)
    whole = bridge.params_from_numpy(runs["params"][cname], device="cpu")
    layout = TL.param_contract(cfg, whole, plan, {"data": dp, "model": n})
    for rank in runs["ranks"]:
        i, j = rank[f"{name}/coord"]
        rows = (route_rows(routes, TL.moe_meta(cfg).e_phys,
                           lm_capacity(cfg, SEQ), dp, n, i, j)
                if ep else None)
        hooks = TL.remat_step(TL.collective_contract(
            cfg, n, BATCH // dp, SEQ // n, dp=dp, ep=ep, moe_rows=rows))
        for part, key in (("calls", "calls"), ("bytes", "bytes")):
            want = [hooks[part].get(k, 0) + layout[part].get(k, 0)
                    for k in KINDS]
            assert rank[f"{name}/step/{key}"].tolist() == want, (part, i, j)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_drops_match_jax(runs, refs, name):
    """Each MoE call drops exactly JAX's pairs (the capacity and the slot
    order are the whole row's): the pairs the run's routing leaves past
    the capacity, and each rank's own count of the call, those of its
    block of the batch; and the ranks' dropped shares of the loss step
    sum to JAX's mean over the calls."""
    cname, (dp, n), _ = SCENARIOS[name]
    want = refs[cname]["dropped"]
    kept = _kept(runs, name)
    assert len(kept) == len(want)
    bl, sl = BATCH // dp, SEQ // n
    for i, (k, share) in enumerate(zip(kept, want)):
        pairs = k.numel()
        assert int((~k).sum()) == round(share * pairs), i
        for r in runs["ranks"]:                 # each rank its own block's
            a, b = r[f"{name}/coord"]
            block = k[a * bl:(a + 1) * bl, b * sl:(b + 1) * sl]
            got = float(r[f"{name}/route{i}/dropped"]) * pairs
            assert round(got) == int((~block).sum()), (i, a, b, got)
    got = sum(float(r[f"{name}/dropped"]) for r in runs["ranks"])
    assert abs(got - np.mean(want)) < 1e-6, (got, np.mean(want))


def test_biased_drops_cross_a_rank_boundary(runs, refs):
    """In the biased config the capacity ends inside a rank's sequence
    chunk: that rank keeps some of an expert's pairs and drops the rest,
    and the ranks after it drop all of theirs."""
    assert min(refs["biased"]["dropped"]) > 0
    experts = _routes(runs, "biased/1x4/ep_zero")[0]
    kept = _kept(runs, "biased/1x4/ep_zero")[0]
    crossed = False
    for b in range(BATCH):
        for j in range(WORLD):
            chunk = slice(j * SEQ // WORLD, (j + 1) * SEQ // WORLD)
            mask = experts[b, chunk] == 0
            k = kept[b, chunk][mask]
            crossed |= bool(k.any()) and not bool(k.all())
    assert crossed


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ranks_read_their_own_experts(runs, name):
    """``Sharder.whole`` gives a period's expert leaves whole over
    ``data`` and, under ``ep``, only the rank's E / n experts: the expert
    dim is never gathered over ``model``."""
    cname, (dp, n), (ep, _) = SCENARIOS[name]
    cfg = CFGS[cname]
    e = TL.moe_meta(cfg).e_phys
    for rank in runs["ranks"]:
        assert rank[f"{name}/expert_shape"].tolist() == [
            e // n if ep else e, cfg.d_model, cfg.d_ff]


@pytest.mark.parametrize("ep,zero", [(True, True), (True, False),
                                     (False, True)])
def test_expert_leaves_layout(ep, zero):
    """An expert leaf's spec, what the model reads of it, and the dims
    its grad is still summed over: under ``ep`` none (the dispatch brings
    every token of the ``model`` group to its experts, and the ``data``
    gather's reduce-scatter sums the rest) or ``data`` without ZeRO."""
    cfg = CFGS["biased"]
    plan = ParallelPlan(mode="dsp", ep=ep, zero=zero)
    params = TL.init_lm(0, cfg, device="cpu")
    specs = param_pspecs(params, plan, axis_sizes={"data": 2, "model": 2})
    spec = specs["periods"]["0"]["moe"]["wi"]
    read = read_specs(specs, plan)["periods"]["0"]["moe"]["wi"]
    names = ("data", "model")
    want = {(True, True): ((None, "model", "data", None),
                           (None, None, "data", None), ()),
            (True, False): ((None, "model", None, None),
                            (None, None, None, None), ("data",)),
            (False, True): ((None, None, ("data", "model"), None),
                            (None, None, ("data", "model"), None), ())}
    assert (spec, read, reduce_axes(spec, names)) == want[(ep, zero)]
    router = specs["periods"]["0"]["moe"]["router"]["w"]
    assert read_specs(specs, plan)["periods"]["0"]["moe"]["router"][
        "w"] == router


def _train_cli(mesh, *args):
    """stdout of ``torchrun --nproc-per-node 4 -m repro_torch.launch.train
    --arch qwen2-moe-a2.7b --mesh <mesh> --device cpu`` at SMOKE size,
    with every rank's plan the spec's own (``ep`` and ZeRO-3) and the
    same summary line on every rank."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
         "--arch", "qwen2-moe-a2.7b", "--mesh", mesh, "--device", "cpu",
         *args], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    plans = {l for l in proc.stdout.splitlines() if l.startswith("plan ")}
    assert plans == {"plan ParallelPlan(mode='dsp', ep=True, zero=True, "
                     "shard_vocab=True)"}, proc.stdout
    lines = [l for l in proc.stdout.splitlines() if l.startswith("loss ")]
    assert len(lines) == WORLD and len(set(lines)) == 1, proc.stdout
    return proc.stdout


def test_train_cli_trains_qwen2_moe_under_torchrun():
    """The train CLI at (1, 4): the global loss equals one rank's without
    a mesh to the 4 digits printed, and every rank leaves the group after
    a barrier (``launch.mesh.close_world``)."""
    out = _train_cli("1,4", "--steps", "3")
    line = next(l for l in out.splitlines() if l.startswith("loss "))
    from repro_torch.launch.train import main as train_main
    hist = train_main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu",
                       "--steps", "3"])
    assert line == (f"loss {hist['history'][0][1]:.4f} -> "
                    f"{hist['history'][-1][1]:.4f}"), line


def test_train_cli_resumes_moe_on_another_mesh(tmp_path):
    """``--mesh 2,2 --ckpt-dir <d> --steps 4`` (the experts split 2 ways
    over ``model`` and their rows 2 over ``data``), the checkpoints past
    step 2 removed, then ``--mesh 1,4 --resume``: each rank restores its
    (1, 4) slices, a quarter of the experts, through the existing
    plan-aware checkpoint, and steps 3 and 4 give the uninterrupted run's
    losses within 1e-5 relative."""
    import ast
    import shutil
    from repro_torch.train.checkpoint import CheckpointManager
    ck = str(tmp_path)
    base = ["--steps", "4", "--ckpt-dir", ck]

    def history(out):
        line = next(l for l in out.splitlines() if l.startswith("history: "))
        return ast.literal_eval(line[len("history: "):])
    whole = history(_train_cli("2,2", *base))
    assert [s for s, _ in whole] == [1, 2, 3, 4]
    assert CheckpointManager(ck).all_steps() == [2, 3, 4]
    for step in (3, 4):
        shutil.rmtree(os.path.join(ck, f"step_{step:08d}"))
    resumed = history(_train_cli("1,4", *base, "--resume"))
    assert [s for s, _ in resumed] == [3, 4]
    np.testing.assert_allclose([l for _, l in resumed],
                               [l for _, l in whole[2:]], rtol=1e-5, atol=0)
