"""Plan ``tp`` (column- and row-parallel attention and MLP, Megatron-SP)
on a ``("data", "model")`` mesh, trained and served, against the JAX
package: 4 gloo ranks (``tests/_torch_tp_worker.py``) beside JAX on 4
simulated devices (``tests/_torch_tp_jax.py``), both on
mistral-large-123b's SMOKE config (4 layers, d 96, 8/2 heads of 16, F
224, vocab 512) with JAX's init.

Meshes (1, 4), where the 2 K/V heads do not divide the ranks (``wk`` and
``wv`` read whole, ``lm.kv_whole``), and (2, 2), where they do; each
with ZeRO-3 over ``data`` and without.  Bars: the forward within 2e-3 of
the largest |value| of JAX's ``forward`` under ``tp`` (the md scenarios'
bar); the loss within 1e-5 and each rank's grad slices within 1e-4 of
the leaf's largest |value|, against JAX's ``jax.grad`` under ``tp`` and
against the port's plan-none ``lm_loss`` on one rank; per rank the calls
and bytes exactly ``lm.remat_step(collective_contract(tp=True))`` plus
``lm.param_contract``.  Serving at (1, 4) with the KV cache in
float8_e4m3fn: logits within 2e-3, tokens equal JAX's
``ServingEngine(mesh=, plan=ParallelPlan(mode="tp"))`` (static) and
JAX's one-device engine (the slot and block pools, whose fp8 rounding
the static path, holding the prefill's K/V in the activation dtype as
JAX's does, never sees); calls exactly ``lm.serve_contract``."""
import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dsp_jax import flatten
from _torch_lmdsp_worker import KINDS
from _torch_tp_jax import (BATCH, MESHES, PROMPT, SEQ, SERVE_BATCH,
                           configs, label)
from repro.models import lm as JL
from repro_torch import bridge
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TSSM
from repro_torch.parallel.partition import (ParallelPlan, make_sharder,
                                            param_pspecs, read_specs,
                                            reduce_axes)
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
CFG = configs("repro_torch")["plain"]
SCENARIOS = [f"{label(s)}/zero{z}" for s in MESHES for z in (1, 0)]
LOGIT_BAR = 2e-3


def _env(**kw):
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
                **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("tp"))
    params = jax.tree_util.tree_map(np.asarray, JL.init_lm(
        jax.random.PRNGKey(0), configs("repro")["plain"]))
    np.savez(os.path.join(work, "params.npz"), **flatten(params))
    rng = np.random.RandomState(5)
    np.savez(os.path.join(work, "inputs.npz"),
             tokens=rng.randint(0, CFG.vocab, (BATCH, SEQ)),
             labels=rng.randint(0, CFG.vocab, (BATCH, SEQ)),
             prompts=rng.randint(0, CFG.vocab, (SERVE_BATCH, PROMPT + 1))
             .astype(np.int32))
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_tp_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_tp_worker.py"),
                            str(r), str(WORLD), work]
    env = _env(JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(4))
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
    return {"params": params,
            "jax": dict(np.load(os.path.join(work, "jax.npz"))),
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)]}


@pytest.fixture(scope="module")
def one_rank(runs):
    """The port's plan-none loss and grads on one rank (remat on)."""
    params = bridge.params_from_numpy(runs["params"], device="cpu")
    leaves = TL.tree_map(lambda p: p.requires_grad_(True), params)
    raw = np.random.RandomState(5)
    batch = {"tokens": torch.from_numpy(raw.randint(0, CFG.vocab,
                                                    (BATCH, SEQ))),
             "labels": torch.from_numpy(raw.randint(0, CFG.vocab,
                                                    (BATCH, SEQ)))}
    loss, _ = TL.lm_loss(leaves, batch, CFG, backend="ref")
    grads = torch.autograd.grad(loss, TL.tree_leaves(leaves))
    return {"loss": float(loss.detach()),
            "grads": dict(zip(flatten(params), (g.numpy() for g in grads)))}


def _assemble(runs, key):
    """The global (B, S, C) forward from each rank's (B/dp, S/n, C)
    shard, placed by its coordinate."""
    dp, n = (int(v) for v in key.split("/")[0].split("x"))
    parts = {tuple(r[f"train/{key}/coord"]): r[f"train/{key}/out"]
             for r in runs["ranks"]}
    return np.concatenate([np.concatenate([parts[(i, j)] for j in range(n)],
                                          axis=1) for i in range(dp)], axis=0)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("key", SCENARIOS)
def test_forward_matches_jax_tp(runs, key):
    """The ranks' ``forward(sharder=)`` shards, gathered, within 2e-3 of
    the largest |value| of JAX's forward under ``tp`` on the same mesh
    (~1e-6 in practice)."""
    want = runs["jax"][f"{key.split('/')[0]}/out"]
    assert _rel(_assemble(runs, key), want) < 2e-3


def _grad_gaps(rank, key, grads):
    for path, want in grads.items():
        got = rank[f"train/{key}/grad/{path}"]
        index = rank[f"train/{key}/index/{path}"]
        cut = want[tuple(slice(a, b) for a, b in index)]
        yield path, np.abs(got - cut).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("key", SCENARIOS)
def test_loss_and_grads_match_jax_tp(runs, key):
    """The loss summed over the world within 1e-5 of JAX's under ``tp``,
    and each rank's slice of each summed grad within 1e-4 of the leaf's
    largest |value| of the same slice of ``jax.grad``'s."""
    mesh = key.split("/")[0]
    want_loss = float(runs["jax"][f"{mesh}/loss"])
    grads = {k[len(f"{mesh}/grad/"):]: v for k, v in runs["jax"].items()
             if k.startswith(f"{mesh}/grad/")}
    for rank in runs["ranks"]:
        loss = float(rank[f"train/{key}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), loss
        for path, gap in _grad_gaps(rank, key, grads):
            assert gap < 1e-4, (path, gap)


@pytest.mark.parametrize("key", SCENARIOS)
def test_loss_and_grads_match_one_rank(runs, one_rank, key):
    """The same against the port's plan-none ``lm_loss`` on one rank."""
    for rank in runs["ranks"]:
        loss = float(rank[f"train/{key}/loss"])
        assert abs(loss - one_rank["loss"]) <= 1e-5 * abs(one_rank["loss"])
        for path, gap in _grad_gaps(rank, key, one_rank["grads"]):
            assert gap < 1e-4, (path, gap)


@pytest.mark.parametrize("key", SCENARIOS)
def test_calls_and_bytes_are_the_contract(runs, key):
    """Per rank, a training step's calls and bytes: per attention and MLP
    block an all-gather of the whole sequence and a reduce-scatter, three
    times over with their transposes (``remat_step``), plus the layouts'
    (a column or row leaf gathered over ``data`` only; ``wk``/``wv`` over
    ``model`` too at (1, 4)), the trainer's buckets and the clip."""
    for rank in runs["ranks"]:
        assert (rank[f"train/{key}/step"].tolist()
                == rank[f"train/{key}/contract"].tolist()), (key, KINDS)


@pytest.mark.parametrize("key", SCENARIOS)
def test_whole_keeps_the_model_split(runs, key):
    """``Sharder.whole`` gives the rank its columns of ``wq``, ``wi`` and
    ``wg`` and its rows of ``wo``, never gathered over ``model``;
    ``wk``/``wv`` whole where the K/V heads do not divide the ranks,
    else the rank's columns."""
    n = int(key.split("/")[0].split("x")[1])
    d, dh, f = CFG.d_model, CFG.head_dim, CFG.d_ff
    kv = CFG.n_kv_heads * dh // (1 if CFG.n_kv_heads % n else n)
    want = {"attn/wq": [d, CFG.n_heads * dh // n], "attn/wk": [d, kv],
            "attn/wv": [d, kv], "attn/wo": [CFG.n_heads * dh // n, d],
            "mlp/wi": [d, f // n], "mlp/wg": [d, f // n],
            "mlp/wo": [f // n, d]}
    for rank in runs["ranks"]:
        for name, shape in want.items():
            assert rank[f"train/{key}/read/{name}"].tolist() == shape, name


@pytest.mark.parametrize("zero", [True, False])
def test_grad_sums_by_layout(zero):
    """What the trainer still sums each grad over under ``tp``: a norm
    scale (whole on every rank, each rank's tokens) over ``data`` and
    ``model``; a column leaf (its grad, over the gathered sequence,
    whole on its rank) over nothing with ZeRO, over ``data`` without."""
    plan = ParallelPlan(mode="tp", zero=zero)
    params = TL.init_lm(0, CFG, device="cpu")
    specs = param_pspecs(params, plan, axis_sizes={"data": 2, "model": 2})
    layer = specs["periods"]["0"]
    names = ("data", "model")
    assert reduce_axes(layer["ln1"]["scale"], names) == names
    assert reduce_axes(layer["attn"]["wq"]["w"], names) == (
        () if zero else ("data",))
    read = read_specs(specs, plan)["periods"]["0"]
    assert read["attn"]["wq"]["w"] == (None, "data" if zero else None, None)
    assert read["attn"]["wo"]["w"] == (None, None, "data" if zero else None)
    whole_kv = read_specs(specs, plan, kv_whole=True)["periods"]["0"]
    assert whole_kv["attn"]["wk"]["w"] == layer["attn"]["wk"]["w"]


def test_checkpoint_restores_on_another_mesh(runs):
    """A ``tp`` layout saved at (2, 2) restores at (1, 4) bit for bit."""
    for rank in runs["ranks"]:
        assert int(rank["ckpt/step"]) == 1
        assert rank["ckpt/equal"].all()


def _vocab(runs, what):
    """(B, 1, V) logits from the ranks' vocab chunks at (1, 4)."""
    parts = {int(r["serve/coord"][1]): r[f"serve/{what}"]
             for r in runs["ranks"]}
    return np.concatenate([parts[j] for j in range(WORLD)], axis=-1)


@pytest.mark.parametrize("what", ["prefill", "decode"])
def test_serving_logits_match_jax_tp(runs, what):
    """The prefill's and a decode step's logits within 2e-3 of JAX's
    ``ServingEngine(mesh=(1, 4), plan=ParallelPlan(mode="tp"))``."""
    assert _rel(_vocab(runs, what), runs["jax"][f"serve/{what}"]) < LOGIT_BAR


def test_generate_matches_jax_tp(runs):
    """``generate`` at (1, 4): the tokens of JAX's engine under ``tp``,
    on every rank, with the K/V heads read whole (2 heads, 4 ranks)."""
    for rank in runs["ranks"]:
        assert bool(rank["serve/kv_whole"])
        np.testing.assert_array_equal(rank["serve/generate"],
                                      runs["jax"]["serve/generate"])


@pytest.mark.parametrize("what", ["prefill", "decode", "migrate"])
def test_serving_calls_are_the_contract(runs, what):
    """Per rank, a prefill with its argmax, a decode step with its, and
    ``replan(2)``'s moves: exactly ``lm.serve_contract``'s calls and
    bytes."""
    for rank in runs["ranks"]:
        assert (rank[f"serve/{what}_counts"].tolist()
                == rank[f"serve/{what}_contract"].tolist()), what


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_pools_match_jax(runs, kind):
    """The continuous scheduler (2 fp8 slots, ``replan(2)`` at decode
    step 3 onto ranks 0-1, whose heads then divide: the K/V re-cut is one
    all-to-all) and the paged one (fp8 blocks, 8-token chunks) give the
    tokens of JAX's engine with the same pools on one device; the moved
    pool is bit-equal."""
    jax_out = runs["jax"]
    for rank in runs["ranks"][:2 if kind == "continuous" else WORLD]:
        for i in range(4):
            np.testing.assert_array_equal(rank[f"serve/{kind}/{i}"],
                                          jax_out[f"serve/{kind}/{i}"])
        if kind == "continuous":
            assert int(rank["serve/sp_after"]) == 2
            assert rank["serve/moved_equal"].all()


# ---------------------------------------------------------------------------
# What plan tp refuses
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


def _refused_configs():
    sc = TSSM.SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=32,
                        n_groups=4, chunk=16)
    base = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                head_dim=8, d_ff=96, vocab=128, dtype=torch.float32)
    return {
        "ssm": (TL.LMConfig(name="ssm", ssm_every=2, ssm_attn_offset=1,
                            ssm_cfg=sc, **base), NotImplementedError, "7.9"),
        "moe": (TL.LMConfig(name="moe", n_experts=4, top_k=2, **base),
                None, "7.8"),
    }


@pytest.mark.parametrize("case", ["ssm", "moe"])
def test_tp_refuses_what_is_not_ported(world_of_one, case):
    """``tp`` with SSM layers raises ``NotImplementedError`` naming its
    ROADMAP item, from the forward and from the engine.  ``tp`` with MoE
    layers, refused until ROADMAP item 7.8, now runs: at a world of one
    its forward and loss are one device's, and its engine serves one
    device's tokens."""
    from repro_torch.serving.engine import ServingEngine
    cfg, exc, item = _refused_configs()[case]
    plan = ParallelPlan(mode="tp", zero=False, shard_vocab=False)
    params = TL.init_lm(0, cfg, device="cpu")
    sharder = make_sharder(world_of_one, plan, param_specs=param_pspecs(
        params, plan, axis_sizes={"data": 1, "model": 1}))
    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (1, 8)))
    if case == "ssm":
        with pytest.raises(exc, match=f"ROADMAP queue 1 item {item}"):
            TL.forward(params, tokens, cfg, sharder=sharder)
        with pytest.raises(exc, match=f"item {item}"):
            ServingEngine(params, cfg, max_len=16, mesh=world_of_one,
                          plan=plan, device="cpu")
        return
    batch = {"tokens": tokens, "labels": tokens.roll(1, 1)}
    want, _ = TL.lm_loss(params, batch, cfg, backend="ref")
    got, _ = TL.lm_loss(params, batch, cfg, sharder=sharder, backend="ref")
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(
        TL.forward(params, tokens, cfg, sharder=sharder)[0].detach(),
        TL.forward(params, tokens, cfg)[0].detach(), rtol=0, atol=1e-5)
    one = ServingEngine(params, cfg, max_len=16, device="cpu")
    eng = ServingEngine(params, cfg, max_len=16, mesh=world_of_one,
                        plan=plan, device="cpu")
    assert torch.equal(eng.generate(tokens, 4), one.generate(tokens, 4))


def test_tp_refuses_heads_the_ranks_do_not_divide():
    """``tp`` splits the q heads over the model ranks: 8 heads on 3 ranks
    raise a ``ValueError`` naming ``n_heads``, as does their contract."""
    with pytest.raises(ValueError, match="n_heads"):
        TL.check_tp(CFG, 3)
    with pytest.raises(ValueError, match="n_heads"):
        TL.collective_contract(CFG, 3, 1, 8, tp=True)
    TL.check_tp(CFG, 4)


def test_tp_takes_no_schedule(world_of_one):
    """``make_sharder`` runs ``tp`` on a mesh with the parameters' layout
    (its columns and rows split over ``model`` whatever ``zero`` says),
    and refuses a switching schedule for it, or no layout."""
    plan = ParallelPlan(mode="tp", zero=False, shard_vocab=False)
    specs = param_pspecs(TL.init_lm(0, CFG, device="cpu"), plan,
                         axis_sizes={"data": 1, "model": 1})
    assert make_sharder(world_of_one, plan, param_specs=specs).tp
    with pytest.raises(ValueError, match="no switching schedule"):
        make_sharder(world_of_one, plan, param_specs=specs,
                     schedule=TL.dsp_schedule(CFG, 1, seq=SEQ, batch=BATCH))
    with pytest.raises(ValueError, match="param_specs"):
        make_sharder(world_of_one, plan)


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------

def _torchrun(module, *args):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", module,
         "--arch", "mistral-large-123b", "--device", "cpu", *args],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_train_cli_trains_mistral_under_tp():
    """The train CLI at ``--mesh 1,4`` takes the spec's plan (``tp``,
    ZeRO-3 over ``data``, the vocab ring), and its loss equals one rank's
    without a mesh to the 4 digits printed on every rank."""
    out = _torchrun("repro_torch.launch.train", "--mesh", "1,4",
                    "--steps", "3")
    plans = {l for l in out.splitlines() if l.startswith("plan ")}
    assert plans == {"plan ParallelPlan(mode='tp', ep=False, zero=True, "
                     "shard_vocab=True)"}, out
    lines = [l for l in out.splitlines() if l.startswith("loss ")]
    from repro_torch.launch.train import main as train_main
    hist = train_main(["--arch", "mistral-large-123b", "--device", "cpu",
                       "--steps", "3"])["history"]
    assert lines == [f"loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}"] * WORLD


def test_serve_cli_serves_mistral_under_tp(capsys):
    """``--mode tp --continuous`` on 4 ranks: the pool asserted on the
    mesh, the tokens of one rank's engine."""
    import json
    import re
    from repro_torch.launch.serve import main
    want = [r.generated for r in main(["--arch", "mistral-large-123b",
                                       "--device", "cpu", "--continuous"])]
    capsys.readouterr()
    text = _torchrun("repro_torch.launch.serve", "--mode", "tp",
                     "--continuous")
    assert "plan ParallelPlan(mode='tp'" in text
    assert "KV pool sequence-sharded over 4-way model dim: OK" in text
    got = [json.loads(m) for m in re.findall(r"s: (\[[^\]]*\])", text)]
    assert got == want
