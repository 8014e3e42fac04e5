"""The port's sharded LM serving (``ServingEngine(mesh=, plan=)``, the
sequence-sharded KV pool, ``ContinuousScheduler`` on a mesh, ``replan``)
against the JAX package's on the CPU: 4 gloo processes
(``tests/_torch_serve_worker.py``) on one ``FileStore``, and the JAX side
on 8 simulated devices in a subprocess (``tests/_torch_serve_jax.py``).

Configs (``_torch_serve_jax.configs``, f32, weights from JAX's init):
``attn`` (GQA 8/2: fewer K/V heads than ranks) and ``hybrid`` (attention
and SSM layers).  Both sides run plan ``ParallelPlan(mode="dsp")`` (ZeRO
and the vocab split on) on meshes (1, 4) and (2, 2); JAX's engine is
priced on ``Topology.uniform``.  Bars: logits within 2e-3 of the largest
|value| (``md_scenarios.decode_sharded``'s), tokens equal; per rank the
calls and bytes of ``lm.serve_contract`` exactly.  The serve CLI runs
under ``torchrun --nproc-per-node 4`` on gloo."""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as JL
from repro.models import ssm as JSSM
from repro_torch import bridge
from repro_torch.core.topology import Topology
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TSSM
from repro_torch.serving.engine import ServingEngine

HERE = os.path.dirname(__file__)
ROOT = os.path.join(HERE, "..")
SRC = os.path.join(ROOT, "src")

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_serve_jax import (BATCH, BUDGETS, CONT_BUDGETS,  # noqa: E402
                              MAX_LEN, MESHES, SEQ, SHORT, configs, label)
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

WORLD = 4
CONFIGS = ("attn", "hybrid")
LOGIT_BAR = 2e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("servedsp"))
    jcfgs = configs(JL, JSSM, jax.numpy.float32)
    tcfgs = configs(TL, TSSM, torch.float32)
    prompts = np.random.RandomState(5).randint(
        0, min(c.vocab for c in tcfgs.values()), (BATCH, SEQ + 1))
    inputs = {"prompts": prompts.astype(np.int32)}
    params = {}
    for name, cfg in jcfgs.items():
        params[name] = jax.tree_util.tree_map(
            np.asarray, JL.init_lm(jax.random.PRNGKey(0), cfg))
        np.savez(os.path.join(work, f"params_{name}.npz"),
                 **flatten(params[name]))
        # an EOS the ragged static runs meet: the port's own token at row
        # 1, step 2 of the unsharded engine
        eng = ServingEngine(bridge.params_from_numpy(params[name],
                                                     device="cpu"),
                            tcfgs[name], max_len=MAX_LEN, device="cpu")
        ref = eng.generate(torch.from_numpy(prompts[:, :SEQ]), max(BUDGETS))
        inputs[f"{name}/eos"] = np.array(int(ref[1, 2]))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(8),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_serve_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_serve_worker.py"),
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
    return {"ranks": ranks, "inputs": inputs, "params": params,
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


def _global(runs, key, what):
    """A (B, 1, V) logits array from the ranks' pieces: rows by their data
    coordinate, vocab chunks by their model coordinate."""
    rows = {}
    for rank in runs["ranks"]:
        d, s = rank[f"{key}/coord"].tolist()
        rows.setdefault(d, {})[s] = rank[f"{key}/{what}"]
    return np.concatenate([np.concatenate([rows[d][s] for s in sorted(
        rows[d])], axis=-1) for d in sorted(rows)], axis=0)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", MESHES, ids=label)
@pytest.mark.parametrize("cname", CONFIGS)
def test_decode_sharded_matches_jax(runs, cname, shape):
    """``md_scenarios.decode_sharded``'s analog: one prefill of 12 tokens
    and one decode step on the mesh, the logits gathered from the ranks'
    rows and vocab chunks, within 2e-3 of JAX's engine on the same mesh
    and of the unsharded one."""
    key = f"{cname}/{label(shape)}"
    for what in ("prefill", "decode"):
        got = _global(runs, key, what)
        for ref in (key, f"{cname}/none"):
            want = runs["jax"][f"{ref}/{what}"]
            assert got.shape == want.shape
            assert _rel(got, want) < LOGIT_BAR, (what, ref)


@pytest.mark.parametrize("zero", [1, 0])
@pytest.mark.parametrize("shape", MESHES, ids=label)
@pytest.mark.parametrize("cname", CONFIGS)
def test_generate_matches_jax(runs, cname, shape, zero):
    """Static ``generate`` with ragged budgets and an EOS, ZeRO and the
    vocab split on and off: every rank's tokens equal JAX's engine's on
    the same mesh, which equal the unsharded engine's."""
    key = f"{cname}/{label(shape)}"
    want = runs["jax"][f"{key}/generate"]
    assert np.array_equal(want, runs["jax"][f"{cname}/none/generate"])
    assert (want == int(runs["inputs"][f"{cname}/eos"])).any()
    for rank in runs["ranks"]:
        assert np.array_equal(rank[f"{key}/generate/zero{zero}"], want)


@pytest.mark.parametrize("cname", CONFIGS)
def test_continuous_replan_matches_static(runs, cname):
    """``md_scenarios.continuous_serving_sharded``'s analog on 4 ranks
    with 2 slots: the pool asserted on the mesh after every step (the
    worker), ``replan(2)`` at decode step 3 with slots live, the moved KV
    and SSM state bit-equal, the tokens equal to the unsharded static
    reference; then ``replan(1)`` drops the mesh and growing back
    raises."""
    key = f"{cname}/replan"
    ref = runs["jax"][f"{cname}/none/static"]
    survivors = [r for r in runs["ranks"] if f"{key}/sp_after" in r]
    assert len(survivors) == 2
    for rank in survivors:
        assert int(rank[f"{key}/sp_after"]) == 2
        assert rank[f"{key}/moved_equal"].all()
        assert int(rank[f"{key}/slots_allocated"]) == BATCH
        for i, m in enumerate(CONT_BUDGETS):
            assert rank[f"{key}/{i}"].tolist() == ref[i, :m].tolist(), i
        assert rank[f"{key}/replan1_mesh_none"]
    assert all(r[f"{key}/regrow_raised"] for r in runs["ranks"])


@pytest.mark.parametrize("n", SHORT)
@pytest.mark.parametrize("cname", CONFIGS)
def test_prompts_the_ranks_do_not_divide(runs, cname, n):
    """Prompts of 13 and 2 tokens on 4 ranks (padded on the right): the
    tokens equal the port's unsharded engine's, and JAX's where it serves
    the prompt.  JAX's engine fails on 2 tokens through an SSM layer's
    conv of 4 taps (a fault of the reference, ROADMAP §3): its conv cache
    keeps 2 rows of 3,
    and the first decode step raises."""
    jax_key = f"{cname}/none/short{n}"
    for rank in runs["ranks"]:
        want = rank[f"{cname}/short{n}/alone"]
        assert np.array_equal(rank[f"{cname}/short{n}"], want)
        if jax_key in runs["jax"]:
            assert np.array_equal(want, runs["jax"][jax_key])
    jax_fails = cname == "hybrid" and n == 2
    assert (jax_key in runs["jax"]) != jax_fails
    assert (f"{jax_key}/raised" in runs["jax"]) == jax_fails


@pytest.mark.parametrize("cname", CONFIGS)
def test_poisson_trace_agrees_on_every_rank(runs, cname):
    """A Poisson trace on the wall clock through the continuous scheduler
    on 4 ranks: each rank admits by rank 0's broadcast clock, the run
    finishes, and every rank holds the same tokens, the unsharded static
    reference's."""
    ref = runs["jax"][f"{cname}/none/static"]
    ticks = {int(r[f"{cname}/poisson/ticks"]) for r in runs["ranks"]}
    assert len(ticks) == 1
    for rank in runs["ranks"]:
        for i, m in enumerate(CONT_BUDGETS):
            assert rank[f"{cname}/poisson/{i}"].tolist() == ref[i, :m].tolist()


SEGMENTS = [f"{label(s)}/{w}" for s in MESHES for w in ("prefill", "decode")
            ] + ["poisson", "replan/before", "replan/migrate",
                 "replan/after"]


@pytest.mark.parametrize("segment", SEGMENTS)
@pytest.mark.parametrize("cname", CONFIGS)
def test_calls_match_serve_contract(runs, cname, segment):
    """Per rank, the ``torch.distributed`` calls and bytes of each segment
    (a prefill and its argmax, a decode step and its argmax, the Poisson
    run, the replan run before, during and after the move) equal
    ``lm.serve_contract``'s exactly."""
    sep = "_" if segment.split("/")[-1] in ("prefill", "decode") else "/"
    key = f"{cname}/{segment}"
    ranks = [r for r in runs["ranks"] if f"{key}{sep}counts" in r]
    assert len(ranks) == (2 if segment == "replan/after" else WORLD)
    for rank in ranks:
        got, want = rank[f"{key}{sep}counts"], rank[f"{key}{sep}contract"]
        assert np.array_equal(got, want), (got.tolist(), want.tolist())
        assert got[0].sum() > 0


@pytest.mark.parametrize("shape", MESHES, ids=label)
@pytest.mark.parametrize("cname", CONFIGS)
def test_cache_specs_and_schedule_match_jax(runs, cname, shape):
    """``cache_pspecs`` of the cache, leaf by leaf, and the engine's
    schedule (``lm.dsp_schedule`` on ``Topology.uniform``) equal JAX's
    engine's on the same mesh; ``shard_caches`` cuts by those specs."""
    key = f"{cname}/{label(shape)}"
    jx = runs["jax"]
    want = {k: v for k, v in jx.items() if k.startswith(f"{key}/cache_spec")}
    assert want
    for rank in runs["ranks"]:
        got = {k: v for k, v in rank.items()
               if k.startswith(f"{key}/cache_spec")}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tolist() == want[k].tolist(), k
        assert rank[f"{key}/schedule"].tolist() == \
            jx[f"{key}/schedule"].tolist()
    cfg = configs(TL, TSSM, torch.float32)[cname]
    sched = TL.dsp_schedule(cfg, shape[1],
                            topology=Topology.uniform(shape[1]))
    assert list(sched.dims) == jx[f"{key}/schedule"].tolist()
    # ``shard_caches`` cuts a whole cache to each rank's slices of it
    for rank in runs["ranks"]:
        assert rank[f"{key}/shard_caches"].all()


# ---------------------------------------------------------------------------
# The serve CLI under torchrun
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen3-14b", "--device", "cpu", "--batch", "3",
       "--prompt-len", "6", "--new-tokens", "4"]


def _torchrun(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "repro_torch.launch.serve",
         *args], cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _generated(text):
    return [json.loads(m) for m in
            re.findall(r"generated=(\[[^\]]*\])", text)]


def test_serve_cli_static_under_torchrun(tmp_path, capsys):
    """``--mode dsp`` on 4 gloo ranks, static, priced on a measured
    fabric (``--topology profile:``): rank 0 alone prints, the KV caches
    sequence-sharded, the tokens world 1's; ``--replan 2`` serves again on
    2 ranks with the same output."""
    from repro_torch.launch.serve import main
    want = main(CLI).tolist()
    capsys.readouterr()
    prof = tmp_path / "fabric.json"
    prof.write_text(json.dumps([[1e6, 1e-4], [1e8, 5e-3], [1e9, 4.5e-2]]))
    text = _torchrun(CLI + ["--mode", "dsp", "--topology", f"profile:{prof}",
                            "--replan", "2"], tmp_path)
    assert text.count("sequence-sharded over 4-way model dim: OK") == 1
    assert "sequence-sharded over 2-way model dim: OK" in text
    assert "replan output identical: True" in text
    got = _generated(text)
    assert got[:3] == want and got[3:] == want


def test_serve_cli_continuous_under_torchrun(tmp_path, capsys):
    """``--continuous`` on 4 gloo ranks over a Poisson trace (``--arrival
    0.01``, ``--topology uniform``): the pool asserted on the mesh, the
    tokens world 1's, the metrics JSON's fabric facts from the plan."""
    from repro_torch.launch.serve import main
    want = [r.generated for r in main(CLI + ["--continuous", "--arrival",
                                             "0.01"])]
    capsys.readouterr()
    text = _torchrun(CLI + ["--continuous", "--arrival", "0.01",
                            "--topology", "uniform", "--metrics",
                            str(tmp_path / "m.json")], tmp_path)
    assert "KV pool sequence-sharded over 4-way model dim: OK" in text
    got = [json.loads(m) for m in re.findall(r"s: (\[[^\]]*\])", text)]
    assert got == want
    facts = json.loads((tmp_path / "m.json").read_text())
    assert facts["n_devices"] == WORLD and facts["mode"] == "dsp"
    assert facts["planned_switches"] > 0
    assert facts["planned_seconds_per_step"] > 0


@pytest.mark.parametrize("flags, message", [
    (["--topology", "ici"], "TPU link preset"),
    (["--devices", "4"], "torchrun --nproc-per-node"),
    (["--hosts", "2"], "standing notes"),
])
def test_serve_cli_exits_for_what_is_not_ported(flags, message, tmp_path):
    """The JAX CLI's flags the port does not run exit with a message
    naming what brings them; ``--topology`` is read only on a mesh, so
    it runs under torchrun."""
    from repro_torch.launch.serve import main
    if flags[0] == "--topology":
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
             *CLI, *flags], cwd=str(tmp_path), env=env,
            capture_output=True, text=True, timeout=240)
        assert out.returncode != 0 and message in out.stderr + out.stdout
        return
    with pytest.raises(SystemExit, match=message):
        main(CLI + flags)
