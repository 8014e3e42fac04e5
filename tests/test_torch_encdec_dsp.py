"""The port's enc-dec model under seamless-m4t-large-v2's own plan
(``ParallelPlan(mode="dsp", zero=True)``) on a ``("data", "model")``
mesh, against the JAX package, on the CPU.

4 gloo processes (``tests/_torch_encdec_worker.py``) on one
``FileStore`` beside JAX on 4 simulated devices
(``tests/_torch_encdec_jax.py``), from JAX's init (seed 0, f32) of the
configs of ``_torch_encdec_jax.SCENARIOS`` (a SMOKE-shaped model with a
vocab that 2 divides and 4 does not, at (1, 4) and (2, 2); GQA 4/2 at
(1, 4)), batch 2 x 32 frames x 16 tokens, each rank its shard of both
sequences.  The bars, each stated where it is checked:

1. the loss summed over the ranks within 1e-5 relative of JAX's
   ``encdec_loss`` under ``make_sharder(mesh, plan)``, each rank's slice
   of every gradient within 1e-4 of the leaf's max of ``jax.grad``'s,
   the clip's norm within 1e-5 relative;
2. per rank the calls and bytes exactly ``lm.remat_step`` of
   ``encdec.collective_contract`` (the
   forward's switches three times over: 2 a layer of the encoder, 5 a
   layer of the decoder) plus ``encdec.param_contract`` (ZeRO-3's gather
   per checkpointed layer, twice, and its reduce-scatter); XLA's
   compiled counts are read beside them, a finding;
3. ``param_pspecs`` leaf by leaf equal to JAX's with its enc-dec
   ``stacked_prefixes``, at SMOKE size and at the full config's shapes, at (1, 4),
   (2, 2) and the default pod sizes, and the layouts' counting with the
   new prefixes;
4. the train CLI under ``torchrun --nproc-per-node 4`` at (1, 4): the
   spec's plan, the loss one rank's.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_large_v2 as JSC
from repro.models import encdec as JE
from repro.parallel.partition import ParallelPlan as JPlan
from repro.parallel.partition import param_pspecs as j_pspecs
from repro_torch import bridge
from repro_torch.configs import seamless_m4t_large_v2 as TSC
from repro_torch.models import encdec as ED
from repro_torch.models.lm import remat_step
from repro_torch.parallel.partition import (STACKED, ParallelPlan,
                                            param_pspecs, tree_map_with_path)

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_encdec_jax import (BATCH, CONFIG_KW, HLO_KINDS,  # noqa: E402
                               S_DEC, S_ENC, SCENARIOS, WORLD, config,
                               inputs, params_np)
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
PLAN = ParallelPlan(mode="dsp", zero=True)
CONFIGS = sorted({c for c, _ in SCENARIOS.values()})
# the one leaf whose gradient is zero in exact arithmetic
ZERO_GRAD = "dec_periods/cross_attn/wk/b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("encdec_dsp"))
    trees = {c: params_np(c) for c in CONFIGS}
    for c, tree in trees.items():
        np.savez(os.path.join(work, f"params_{c}.npz"), **flatten(tree))
    np.savez(os.path.join(work, "inputs.npz"),
             **{f"{c}/{k}": v for c in CONFIGS
                for k, v in inputs(CONFIG_KW[c]).items()})
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(WORLD),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_encdec_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_encdec_worker.py"),
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
    return {"params": trees,
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)],
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


# ---------------------------------------------------------------------------
# 1. Against JAX, on 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_loss_and_grad_slices_match_jax(runs, name):
    """Each rank's ``encdec_loss(sharder=)`` on its slices and its shard
    of both sequences, summed by ``allreduce_grads``, equals JAX's loss
    under its sharder within 1e-5 relative; each rank's slice of every
    gradient equals the same slice of ``jax.grad``'s within 1e-4 of the
    leaf's max; the clip's norm from the slices equals the norm of JAX's
    whole gradient within 1e-5 relative.  Some leaf is split on every
    rank (ZeRO-3 is in force).  The cross-attention's K bias has a zero
    gradient in exact arithmetic (no rope, and the softmax is invariant
    to a shift along the keys), so its rounding noise (~1e-9) is held to
    1e-4 of the largest |value| of the whole gradient instead."""
    jx = runs["jax"]
    cname = SCENARIOS[name][0]
    paths = list(flatten(runs["params"][cname]))
    top = max(np.abs(jx[f"{name}/grad/{p}"]).max() for p in paths)
    want_loss = float(jx[f"{name}/loss"])
    want_norm = float(np.sqrt(sum(np.sum(np.square(
        jx[f"{name}/grad/{p}"].astype(np.float64))) for p in paths)))
    for rank in runs["ranks"]:
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (loss,
                                                                want_loss)
        norm = float(rank[f"{name}/norm"])
        assert abs(norm - want_norm) <= 1e-5 * want_norm, (norm, want_norm)
        split = 0
        for path in paths:
            want = jx[f"{name}/grad/{path}"]
            got = rank[f"{name}/grad/{path}"]
            index = rank[f"{name}/index/{path}"]
            cut = want[tuple(slice(a, b) for a, b in index)]
            assert got.shape == cut.shape, (path, got.shape, cut.shape)
            split += got.size < want.size
            scale = (top if path == ZERO_GRAD
                     else max(np.abs(want).max(), 1e-30))
            gap = np.abs(got - cut).max() / scale
            assert gap < 1e-4, (path, gap)
        assert split > 0


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ranks_hold_their_shards_of_both_sequences(runs, name):
    """Each rank's batch shard holds S_enc / n frames and S_dec / n
    tokens, and the ranks' coordinates tile the mesh."""
    _, (dp, n) = SCENARIOS[name]
    coords = set()
    for rank in runs["ranks"]:
        assert rank[f"{name}/local_shapes"].tolist() == [S_ENC // n,
                                                         S_DEC // n]
        coords.add(tuple(rank[f"{name}/coord"].tolist()))
    assert coords == {(i, j) for i in range(dp) for j in range(n)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, the step's calls and bytes: the hooks' (``remat_step``:
    each encoder layer's stacked q/k/v switch and its switch back, each
    decoder layer's self-attention pair, its cross-attention's q switch,
    the encoder K/V's stacked switch and the switch back, all three times
    over with remat) plus the layouts' (``param_contract``: each layer's
    split leaves gathered twice and reduce-scattered once, the table,
    the frontend, and the trainer's all-reduces)."""
    cname, (dp, n) = SCENARIOS[name]
    cfg = config(ED, cname, torch.float32)
    whole = bridge.params_from_numpy(runs["params"][cname], device="cpu")
    hooks = remat_step(ED.collective_contract(cfg, n, BATCH // dp,
                                              S_ENC // n, S_DEC // n))
    layout = ED.param_contract(cfg, whole, PLAN, {"data": dp, "model": n})
    fwd = ED.collective_contract(cfg, n, BATCH // dp, S_ENC // n, S_DEC // n)
    assert fwd["calls"] == {"all-to-all": 2 * cfg.n_enc_layers
                            + 5 * cfg.n_dec_layers}
    for rank in runs["ranks"]:
        for part in ("calls", "bytes"):
            want = [hooks[part].get(k, 0) + layout[part].get(k, 0)
                    for k in KINDS]
            assert rank[f"{name}/step/{part}"].tolist() == want, part


# XLA's compiled collectives of JAX's step (jax on the CPU), by
# scenario, read beside the port's contract: XLA places the switches and
# the ZeRO gathers its own way (it gathers each weight, all-reduces
# where the port reduce-scatters), so they are a finding, not the bar
JAX_COMPILED = {
    "mesh/1x4": {"all-to-all": 38, "all-gather": 70, "all-reduce": 17},
    "mesh/2x2": {"all-to-all": 12, "all-gather": 118, "all-reduce": 43,
                 "collective-permute": 15},
    "gqa/1x4": {"all-to-all": 28, "all-gather": 68, "all-reduce": 36,
                "collective-permute": 10},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_xla_counts_read_beside_the_contract(runs, name):
    """XLA's compiled counts of JAX's step, by kind, are the ones pinned
    in ``JAX_COMPILED``, and the port's all-to-alls are the planned ones
    (``remat_step``: 3 x (2 an encoder layer + 5 a decoder layer)),
    not XLA's."""
    cname, (dp, n) = SCENARIOS[name]
    got = {k: c for k, c in zip(HLO_KINDS,
                                runs["jax"][f"{name}/hlo"].tolist()) if c}
    assert got == JAX_COMPILED[name]
    cfg = config(ED, cname, torch.float32)
    hooks = remat_step(ED.collective_contract(cfg, n, BATCH // dp,
                                              S_ENC // n, S_DEC // n))
    assert hooks["calls"]["all-to-all"] == 3 * (
        2 * cfg.n_enc_layers + 5 * cfg.n_dec_layers)


# ---------------------------------------------------------------------------
# 3. The layouts, in one process
# ---------------------------------------------------------------------------

def _meta(tree):
    """Meta tensors of a JAX tree's shapes and dtypes (bf16 as the port's)."""
    return jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, device="meta",
                              dtype=torch.bfloat16 if a.dtype == jnp.bfloat16
                              else torch.float32), tree)


def _jax_specs(tree, sizes, prefixes=("enc_periods", "dec_periods")):
    specs = j_pspecs(tree, JPlan(mode="dsp", zero=True), axis_sizes=sizes,
                     stacked_prefixes=prefixes)
    return {k: tuple(v) for k, v in flatten(specs).items()}


def _port_specs(tree, sizes):
    specs = param_pspecs(tree, PLAN, axis_sizes=sizes)
    flat = {}
    tree_map_with_path(lambda p, s: flat.__setitem__("/".join(p), s), specs)
    return flat


def _trim(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("sizes", [{"data": 1, "model": 4},
                                   {"data": 2, "model": 2}, None],
                         ids=["1x4", "2x2", "pod"])
def test_param_pspecs_match_jax(full, sizes):
    """Every leaf's spec equals JAX's with ``stacked_prefixes=
    ("enc_periods", "dec_periods")``, as its enc-dec callers pass it: the
    layers' leading dim whole, ZeRO-3 over ``("data", "model")`` on the
    first dim that divides, the table over ``model`` where the ranks
    divide 256206 (2, not 4 or 16)."""
    if full:
        tree = jax.eval_shape(lambda: JE.init_encdec(jax.random.PRNGKey(0),
                                                     JSC.CONFIG))
    else:
        tree = JE.init_encdec(jax.random.PRNGKey(0), JSC.SMOKE)
    want = _jax_specs(tree, sizes)
    got = _port_specs(_meta(tree), sizes)
    shapes = {k: v.shape for k, v in flatten(tree).items()}
    assert set(got) == set(want)
    for path in want:
        nd = len(shapes[path])
        assert _trim(got[path], nd) == _trim(want[path], nd), path
    table = got["embed/table"]
    n = (sizes or {"model": 16})["model"]
    vocab = (JSC.CONFIG if full else JSC.SMOKE).vocab
    assert table[0] == ("model" if vocab % n == 0 else None)


def test_default_prefixes_leave_encdec_leaves_unstacked():
    """JAX's default prefixes rule the enc-dec layer leaves unstacked
    (their specs prepend nothing), which is why its enc-dec callers pass
    ``stacked_prefixes``; the port's one ``STACKED`` holds JAX's default
    and the enc-dec prefixes (no tree holds keys of both), so its specs
    are the ones JAX's callers get."""
    tree = JE.init_encdec(jax.random.PRNGKey(0), JSC.SMOKE)
    sizes = {"data": 2, "model": 2}
    leaf = "enc_periods/mlp/wi/w"
    unstacked = _jax_specs(tree, sizes, prefixes=("layers", "periods"))
    assert unstacked[leaf] == (None, None, None)
    assert STACKED == ("layers", "periods", "enc_periods", "dec_periods")
    assert (_port_specs(_meta(tree), sizes)[leaf]
            == _jax_specs(tree, sizes)[leaf]
            == (None, ("data", "model"), None))


def test_param_contract_counts_each_layer():
    """``param_contract`` counts a layer leaf's gathers per layer (2 each,
    the forward's and the recompute's) and its reduce-scatters once,
    the table's once, from the specs of the stacked layers: at (2,
    2) on seamless's full shapes every weight is split, the table over
    ``model``."""
    tree = _meta(jax.eval_shape(lambda: JE.init_encdec(
        jax.random.PRNGKey(0), JSC.CONFIG)))
    cfg = TSC.CONFIG
    got = ED.param_contract(cfg, tree, PLAN, {"data": 2, "model": 2})
    specs = param_pspecs(tree, PLAN, axis_sizes={"data": 2, "model": 2})
    layer_leaves = sum(
        n * sum(1 for e in s if e is not None)
        for key, n in (("enc_periods", cfg.n_enc_layers),
                       ("dec_periods", cfg.n_dec_layers))
        for s in _flat_specs(specs[key]))
    other = sum(1 for key in ("embed", "frontend", "enc_norm", "dec_norm")
                for s in _flat_specs(specs[key]) for e in s if e is not None)
    assert got["calls"]["all-gather"] == 2 * layer_leaves + other
    assert got["calls"]["reduce-scatter"] == layer_leaves + other
    assert specs["embed"]["table"] == ("model", None)


def _flat_specs(tree):
    out = []
    tree_map_with_path(lambda _, s: out.append(s), tree)
    return out


# ---------------------------------------------------------------------------
# 4. The train CLI under torchrun
# ---------------------------------------------------------------------------

def test_train_cli_trains_seamless_under_torchrun():
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch
    seamless-m4t-large-v2 --mesh 1,4 --device cpu`` at SMOKE size: every
    rank prints the spec's plan and the same loss line, equal to one
    rank's without a mesh to the 4 digits printed."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    args = ["--arch", "seamless-m4t-large-v2", "--device", "cpu", "--steps",
            "3", "--seq", "32", "--batch", "4"]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.train",
         "--mesh", "1,4", *args], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    plans = {l for l in proc.stdout.splitlines() if l.startswith("plan ")}
    assert plans == {"plan ParallelPlan(mode='dsp', ep=False, zero=True, "
                     "shard_vocab=True)"}, proc.stdout
    lines = [l for l in proc.stdout.splitlines() if l.startswith("loss ")]
    assert len(lines) == WORLD and len(set(lines)) == 1, proc.stdout
    from repro_torch.launch.train import main as train_main
    hist = train_main(args)
    assert lines[0] == (f"loss {hist['history'][0][1]:.4f} -> "
                        f"{hist['history'][-1][1]:.4f}"), lines[0]
