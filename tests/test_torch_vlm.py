"""pixtral-12b and the VLM stub frontend in the port
(``configs/pixtral_12b.py``, ``models.lm.with_patches``) against the JAX
package, on the CPU.

In this process, at SMOKE width (2 layers, d 64, 4/2 heads of 16, 8
patch rows of 48 features), from JAX's init (seed 0, f32) and the same
seeded numpy inputs: the config and ``param_counts``, ``init_lm``'s tree,
``forward(extra=)``, ``lm_loss`` with every grad (the frontend's too),
``forward_prefill(extra=)`` and ``batch_for_arch`` against JAX's; a world
of one under ``dsp`` + ZeRO-3 and under ``tp`` against one device.  On
4 gloo ranks (``tests/_torch_vlm_worker.py``) beside JAX on 4 simulated
devices (``tests/_torch_vlm_jax.py``, compiled with the cheaper passes of
``_torch_jax_flags.jax_xla_flags(4)``), under pixtral's plan at (1, 4)
and (2, 2), the 8 patch rows in 24 positions cross two ranks' chunks at
(1, 4).  The bars, those of ``tests/test_torch_param_layouts.py``: the
forward within 2e-4 of the largest |value|, the loss within 1e-5
relative, every grad leaf within 1e-4 of its max; on one device 1e-5 of
the largest |value| for the forward and the prefill's logits."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import pixtral_12b as JP
from repro.data import pipeline as JD
from repro.models import lm as JL
from repro_torch import bridge
from repro_torch.configs import get
from repro_torch.configs import pixtral_12b as TP
from repro_torch.data import pipeline as TD
from repro_torch.models import lm as TL
from repro_torch.parallel.partition import (ParallelPlan, make_sharder,
                                            param_pspecs, shard_params)

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_vlm_jax import BATCH, MESHES, SEQ, WORLD, inputs  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401
from _torch_world import world_of_one  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
CFG, JCFG = TP.SMOKE, JP.SMOKE


@pytest.fixture(scope="module")
def smoke():
    """JAX's SMOKE init as numpy, the port's copy of it, and the inputs."""
    jp = JL.init_lm(jax.random.PRNGKey(0), JCFG)
    raw = inputs(CFG.vocab, CFG.frontend_tokens, CFG.frontend_dim)
    return {"jax": jp, "np": jax.tree_util.tree_map(np.asarray, jp),
            "torch": bridge.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jp), device="cpu"),
            "raw": raw}


def _jax_batch(raw):
    return {"tokens": jnp.asarray(raw["tokens"]),
            "labels": jnp.asarray(raw["labels"]),
            "extra": {"patch_embeds": jnp.asarray(raw["patch_embeds"])}}


def _port_batch(raw):
    return {"tokens": torch.from_numpy(raw["tokens"]).long(),
            "labels": torch.from_numpy(raw["labels"]).long(),
            "extra": {"patch_embeds": torch.from_numpy(raw["patch_embeds"])}}


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


# ---------------------------------------------------------------------------
# The config, the tree, the batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_and_param_counts_match_jax(which):
    """Every field of pixtral's config equals JAX's (the dtypes by name),
    so do ``param_counts`` (about 12.2B for the full config: the frontend
    is not counted, as in JAX), and the spec is registered with JAX's
    plan, ``dsp`` + ZeRO-3."""
    t, j = getattr(TP, which), getattr(JP, which)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name, None)
        if f.name in ("dtype", "cache_dtype"):
            assert (a is None) == (b is None)
            if a is not None:
                assert str(a).split(".")[-1] == jnp.dtype(b).name
        else:
            assert a == b, f.name
    assert TL.param_counts(t) == JL.param_counts(j)
    spec = get("pixtral-12b")
    assert spec.plan == ParallelPlan(mode="dsp", zero=True)
    assert (spec.family, spec.source) == (JP.SPEC.family, JP.SPEC.source)


def test_init_tree_matches_jax(smoke):
    """``init_lm`` draws the frontend's projection under ``frontend``, at
    JAX's place in the tree (last), every leaf at JAX's shape."""
    got = TL.init_lm(0, CFG, device="cpu")
    assert list(got) == list(smoke["jax"]) == ["embed", "periods",
                                              "final_norm", "unembed",
                                              "frontend"]
    want = {k: v.shape for k, v in flatten(smoke["np"]).items()}
    assert {k: tuple(v.shape) for k, v in flatten(got).items()} == want


@pytest.mark.parametrize("arch", ["pixtral-12b", "qwen3-14b"])
def test_batch_for_arch_matches_jax(arch):
    """``batch_for_arch`` gives JAX's keys, shapes and dtypes (the values
    cannot match: ``jax.random`` is not replayed): pixtral's carries
    ``extra["patch_embeds"]`` (B, frontend_tokens, frontend_dim) in
    float32, a text model's none."""
    from repro.configs import get as jget
    got = TD.batch_for_arch(get(arch), "train_4k", batch_override=2,
                            seq_override=1024, device="cpu")
    want = JD.batch_for_arch(jget(arch), "train_4k", batch_override=2,
                             seq_override=1024)
    g, w = flatten(got), flatten(want)
    assert set(g) == set(w)
    for k in w:
        assert tuple(g[k].shape) == tuple(w[k].shape), k
        assert (g[k].dtype.is_floating_point
                == jnp.issubdtype(w[k].dtype, jnp.floating)), k


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_device(smoke):
    """JAX's forward, loss and grads, and prefill on one device."""
    jb = _jax_batch(smoke["raw"])
    x, _ = JL.forward(smoke["jax"], jb["tokens"], JCFG, backend="ref",
                      remat=False, extra=jb["extra"])
    loss, grads = jax.value_and_grad(lambda p: JL.lm_loss(
        p, jb, JCFG, backend="ref", remat=False)[0])(smoke["jax"])
    logits, caches = JL.forward_prefill(smoke["jax"], jb["tokens"], JCFG,
                                        backend="ref", extra=jb["extra"])
    return {"out": np.asarray(x), "loss": float(loss),
            "grads": flatten(jax.tree_util.tree_map(np.asarray, grads)),
            "logits": np.asarray(logits),
            "caches": flatten(jax.tree_util.tree_map(np.asarray, caches))}


def test_forward_matches_jax(smoke, one_device):
    """``forward(extra=)``: the patch rows through the frontend replace
    the first 8 positions, within 1e-5 of the largest |value| of JAX's
    output; without ``extra`` the output departs (the rows matter)."""
    b = _port_batch(smoke["raw"])
    with torch.no_grad():
        got, _ = TL.forward(smoke["torch"], b["tokens"], CFG, backend="ref",
                            remat=False, extra=b["extra"])
        text, _ = TL.forward(smoke["torch"], b["tokens"], CFG, backend="ref",
                             remat=False)
    assert _rel(got, one_device["out"]) <= 1e-5
    assert _rel(text, one_device["out"]) > 1e-2


def test_loss_and_grads_match_jax(smoke, one_device):
    """``lm_loss`` on the batch with ``extra``: the loss within 1e-5
    relative of JAX's and every grad leaf, the frontend's projection
    included, within 1e-4 of its max."""
    leaves = [p.detach().requires_grad_(True)
              for p in TL.tree_leaves(smoke["torch"])]
    it = iter(leaves)
    tree = TL.tree_map(lambda p: next(it), smoke["torch"])
    loss, _ = TL.lm_loss(tree, _port_batch(smoke["raw"]), CFG,
                         backend="ref")
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss) - one_device["loss"]) <= \
        1e-5 * abs(one_device["loss"])
    it = iter(grads)
    got = flatten(TL.tree_map(lambda p: next(it), smoke["torch"]))
    assert set(got) == set(one_device["grads"])
    assert "frontend/proj/w" in got
    for k, w in one_device["grads"].items():
        assert _rel(got[k], w) <= 1e-4, k


def test_prefill_matches_jax(smoke, one_device):
    """``forward_prefill(extra=)``: the last position's logits within 1e-5
    of the largest |logit| of JAX's, every cache leaf within 1e-5 of its
    largest |value|, ``pos`` the prompt's length."""
    b = _port_batch(smoke["raw"])
    with torch.no_grad():
        logits, caches = TL.forward_prefill(smoke["torch"], b["tokens"], CFG,
                                            backend="ref", extra=b["extra"])
    assert _rel(logits, one_device["logits"]) <= 1e-5
    got = flatten(caches)
    for k, w in one_device["caches"].items():
        if k == "pos":
            assert int(got[k]) == int(w) == SEQ
        else:
            assert _rel(got[k], w) <= 1e-5, k


def test_prompt_shorter_than_the_frontend_raises(smoke):
    """A prompt shorter than ``frontend_tokens`` raises in the port: JAX's
    concatenation lengthens the sequence to ``frontend_tokens`` instead,
    its caches then 8 positions long while ``pos`` says 5 (recorded here,
    a fault of the reference)."""
    raw = smoke["raw"]
    jb = _jax_batch(raw)
    _, caches = JL.forward_prefill(smoke["jax"], jb["tokens"][:, :5], JCFG,
                                   backend="ref", extra=jb["extra"])
    assert int(caches["pos"]) == 5
    assert caches["periods"]["0"]["kv"]["k"].shape[3] == CFG.frontend_tokens
    b = _port_batch(raw)
    with pytest.raises(ValueError, match="first 8 positions"):
        TL.forward_prefill(smoke["torch"], b["tokens"][:, :5], CFG,
                           backend="ref", extra=b["extra"])
    with pytest.raises(ValueError, match="first 8 positions"):
        TL.forward(smoke["torch"], b["tokens"], CFG, backend="ref",
                   extra={"patch_embeds": b["extra"]["patch_embeds"][:, :4]})


@pytest.mark.parametrize("mode", ["dsp", "tp"])
def test_world_of_one_matches_one_device(smoke, world_of_one, mode):
    """At a world of one, under pixtral's plan (``dsp`` + ZeRO-3) and under
    ``tp`` + ZeRO-3 (JAX's rules give the frontend ``(data, None)`` under
    both), the loss with the patch rows equals one device's within 1e-6
    relative and the frontend's grad within 1e-5 of its max; the step
    issues the frontend's gather and reduce-scatter
    (``param_contract(patches=True)``: one of each, for the weight) beside
    the hooks'."""
    from repro_torch.core import dsp
    from repro_torch.parallel.partition import mesh_sizes
    from repro_torch.core.layout import from_mesh
    plan = ParallelPlan(mode=mode, zero=True)
    whole = smoke["torch"]
    sizes = mesh_sizes(from_mesh(world_of_one))
    specs = param_pspecs(whole, plan, axis_sizes=sizes)
    assert specs["frontend"]["proj"]["w"] == (
        ("data", None) if mode == "tp" else (("data", "model"), None))
    schedule = TL.dsp_schedule(CFG, 1, seq=SEQ, batch=BATCH, joint=True) \
        if mode == "dsp" else None
    sh = make_sharder(world_of_one, plan, schedule=schedule,
                      param_specs=specs)
    params = shard_params(whole, specs, sh.ctx)

    def loss_grads(tree, sharder):
        leaves = [p.detach().requires_grad_(True)
                  for p in TL.tree_leaves(tree)]
        it = iter(leaves)
        t = TL.tree_map(lambda p: next(it), tree)
        batch = _port_batch(smoke["raw"])
        if sharder is not None:
            batch = TL.shard_lm_batch(batch, sharder)
        loss, _ = TL.lm_loss(t, batch, CFG, sharder=sharder, backend="ref")
        g = torch.autograd.grad(loss, leaves)
        it = iter(g)
        return float(loss), TL.tree_map(lambda p: next(it), tree)

    want, wg = loss_grads(whole, None)
    dsp.reset_calls()
    got, gg = loss_grads(params, sh)
    calls = dict(dsp.calls)
    assert abs(got - want) <= 1e-6 * abs(want)
    assert _rel(gg["frontend"]["proj"]["w"],
                wg["frontend"]["proj"]["w"]) <= 1e-5
    text = TL.param_contract(CFG, whole, plan, sizes)
    both = TL.param_contract(CFG, whole, plan, sizes, patches=True)
    # the projection's weight is split, its bias whole
    assert both["calls"]["all-gather"] == text["calls"]["all-gather"] + 1
    assert both["calls"]["reduce-scatter"] == \
        text["calls"]["reduce-scatter"] + 1
    hooks = TL.remat_step(TL.collective_contract(
        CFG, 1, BATCH, SEQ, tp=mode == "tp"))
    for kind in ("all-gather", "reduce-scatter"):
        assert calls.get(kind, 0) == hooks["calls"].get(kind, 0) + \
            both["calls"][kind], kind


def test_clis_take_pixtral_text_only(capsys):
    """``launch.serve`` and ``launch.train`` take ``--arch pixtral-12b``
    at SMOKE size on the CPU, text alone, as JAX's CLIs do: every request
    finishes, the loss is finite."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    out = serve_main(["--arch", "pixtral-12b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16",
                      "--new-tokens", "4"])
    assert tuple(out.shape) == (2, 4)
    out = train_main(["--arch", "pixtral-12b", "--device", "cpu",
                      "--steps", "2", "--seq", "32", "--batch", "2"])
    assert all(np.isfinite(l) for _, l in out["history"])


# ---------------------------------------------------------------------------
# 4 ranks against JAX's mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory, smoke):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("vlm"))
    np.savez(os.path.join(work, "params.npz"), **flatten(smoke["np"]))
    np.savez(os.path.join(work, "inputs.npz"), **smoke["raw"])
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(4), OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_vlm_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_vlm_worker.py"),
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
    return {"ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)],
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_forward_matches_jax(runs, name):
    """Each rank's ``forward(sharder=, extra=)`` shard (its batch slice,
    its sequence chunk with the patch rows that fall in it), gathered,
    matches JAX's ``forward(extra=)`` on the same mesh within 2e-4 of the
    largest |value|; at (1, 4) the patch rows fill rank 0's chunk and
    part of rank 1's."""
    dp, sp = MESHES[name]
    rows = [[None] * sp for _ in range(dp)]
    for rank in runs["ranks"]:
        d, s = rank[f"{name}/coord"].tolist()
        rows[d][s] = rank[f"{name}/out"]
    got = np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)
    assert got.shape[:2] == (BATCH, SEQ)
    assert _rel(got, runs["jax"][f"{name}/out"]) < 2e-4


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_loss_and_grads_match_jax(runs, name):
    """Each rank's ``lm_loss(sharder=)`` with the patch rows, summed over
    the world, equals JAX's within 1e-5 relative, and every grad leaf
    gathered whole (the frontend's, which only the ranks holding patch
    rows feed, included) within 1e-4 of its max of ``jax.grad``'s."""
    jx = runs["jax"]
    want = float(jx[f"{name}/loss"])
    keys = [k[len(f"{name}/grad/"):] for k in jx
            if k.startswith(f"{name}/grad/")]
    assert "frontend/proj/w" in keys
    for rank in runs["ranks"]:
        assert abs(float(rank[f"{name}/loss"]) - want) <= 1e-5 * abs(want)
        for k in keys:
            assert _rel(rank[f"{name}/grad/{k}"],
                        jx[f"{name}/grad/{k}"]) <= 1e-4, k


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_calls_and_bytes_are_the_contract(runs, name):
    """Per rank, the step issues exactly the hooks' contract with remat
    plus ``param_contract(patches=True)``: the frontend gathered where
    it is read and its grad reduce-scattered on every rank, also on the
    ranks whose chunk holds no patch row."""
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank[f"{name}/calls"],
                                      rank[f"{name}/contract_calls"])
        np.testing.assert_array_equal(rank[f"{name}/bytes"],
                                      rank[f"{name}/contract_bytes"])
        assert dict(zip(KINDS, rank[f"{name}/calls"].tolist()))[
            "reduce-scatter"] > 0
