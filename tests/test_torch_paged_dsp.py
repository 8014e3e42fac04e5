"""The port's paged serving sequence-sharded within blocks on a (1, 4)
mesh against the JAX package's on the CPU: 4 gloo processes
(``tests/_torch_paged_worker.py``) on one ``FileStore``, and the JAX side
on 8 simulated devices in a subprocess (``tests/_torch_paged_jax.py``),
config ``attn`` (GQA 8/2: fewer K/V heads than ranks), f32, plan
``ParallelPlan(mode="dsp")`` (ZeRO and the vocab split on).

The analog of ``md_scenarios.paged_serving_sharded``: the paged trace with
chunked prefill and prefix hits, the pool asserted on the mesh after every
step and ``replan(2)`` mid-prefill, tokens equal to the unsharded static
reference; the chunks' and a decode step's logits within 2e-3 (of the
largest |value|) of JAX's sharded paged engine; ``cache_pspecs(paged=True)``
equal to JAX's; per rank the calls and bytes of every segment exactly
``lm.serve_contract``'s, a paged decode step's equal to a slot decode
step's (JAX pins the same of its compiled HLO); and the serve CLI
``--paged`` under ``torchrun``."""
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.models import lm as JL

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_paged_jax import (BUDGETS, POOL_CHUNKS, POOL_PROMPTS,  # noqa: E402
                              SHARED, SP, SUFFIXES, config)
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

LOGIT_BAR = 2e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("pageddsp"))
    cfg = config(JL, jax.numpy.float32)
    rng = np.random.RandomState(11)
    inputs = {"pool_prompts": rng.randint(0, cfg.vocab, (2, max(
                  POOL_PROMPTS))).astype(np.int32),
              "pool_next": rng.randint(0, cfg.vocab, 2).astype(np.int32),
              "shared": rng.randint(0, cfg.vocab, SHARED)}
    for i, n in enumerate(SUFFIXES):
        inputs[f"suffix{i}"] = rng.randint(0, cfg.vocab, n)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    params = jax.tree_util.tree_map(
        np.asarray, JL.init_lm(jax.random.PRNGKey(0), cfg))
    np.savez(os.path.join(work, "params.npz"), **flatten(params))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(8),
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_paged_jax.py"),
                    work]}
    for r in range(SP):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_paged_worker.py"),
                            str(r), str(SP), work]
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
                      for r in range(SP)],
            "jax": dict(np.load(os.path.join(work, "jax.npz")))}


def _global(runs, key):
    """(rows, S, V) logits from the ranks' vocab chunks, in rank order."""
    by = {int(r["coord"][1]): r[key] for r in runs["ranks"]}
    return np.concatenate([by[s] for s in sorted(by)], axis=-1)


STEPS = [f"chunk{i}.{j}" for i, w in enumerate(POOL_CHUNKS)
         for j in range(len(w))] + ["decode"]


@pytest.mark.parametrize("step", STEPS)
def test_paged_logits_match_jax(runs, step):
    """Each chunk's logits (every position) and the decode step's,
    gathered from the ranks' vocab chunks, within 2e-3 of JAX's sharded
    paged engine and of its unsharded one."""
    got = _global(runs, step)
    for ref in ("1x4", "none"):
        want = runs["jax"][f"{ref}/{step}"]
        assert got.shape == want.shape
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < LOGIT_BAR, (ref, rel)


def test_paged_cache_specs_match_jax(runs):
    """``cache_pspecs(pool, plan, paged=True)`` leaf by leaf equal to
    JAX's: the KV within-block dim over ``model``, the block dim, the table
    and ``pos`` whole."""
    want = {k: v for k, v in runs["jax"].items() if k.startswith("spec/")}
    assert want
    for rank in runs["ranks"]:
        got = {k: v for k, v in rank.items() if k.startswith("spec/")}
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tolist() == want[k].tolist(), k
    assert want["spec/periods/0/kv/k"].tolist() == \
        ["None", "None", "None", "model", "None"]


def test_paged_trace_replan_matches_static(runs):
    """The trace with chunked prefill and prefix hits on 4 ranks, the pool
    asserted after every step (the worker), ``replan(2)`` at a decode step
    with a prefill mid-prompt: the moved blocks bit-equal, the tables and
    ref counts untouched, the survivors' tokens the unsharded static
    reference's; the two later requests hit the shared prefix."""
    survivors = [r for r in runs["ranks"] if "trace/0" in r]
    assert len(survivors) == 2
    for rank in runs["ranks"]:
        k, done, plen = rank["replan/at"].tolist()
        assert 0 < done < plen
    for rank in survivors:
        assert int(rank["replan/sp_after"]) == 2
        assert rank["replan/moved_equal"].all()
        assert rank["replan/host_state_equal"]
        hits, _, admitted = rank["trace/metrics"].tolist()
        assert hits == 2 * SHARED and admitted == len(BUDGETS)
        for i, m in enumerate(BUDGETS):
            want = runs["jax"][f"static{i}"]
            assert rank[f"trace/{i}"].tolist() == want[:m].tolist(), i


SEGMENTS = [*STEPS, "replan/before", "replan/migrate", "replan/after"]


@pytest.mark.parametrize("segment", SEGMENTS)
def test_paged_calls_match_serve_contract(runs, segment):
    """Per rank, the calls and bytes of each segment (a chunk and its
    argmax, a decode step and its argmax, the trace before, during and
    after the replan) equal ``lm.serve_contract``'s exactly."""
    ranks = [r for r in runs["ranks"] if f"{segment}/counts" in r]
    assert len(ranks) == (2 if segment == "replan/after" else SP)
    for rank in ranks:
        got, want = rank[f"{segment}/counts"], rank[f"{segment}/contract"]
        assert np.array_equal(got, want), (got.tolist(), want.tolist())
        assert got[0].sum() > 0


def test_paged_decode_issues_the_slot_decode_calls(runs):
    """A paged decode step's calls and bytes per rank equal a slot decode
    step's at the same batch (``md_scenarios.paged_serving_sharded`` pins
    the same of JAX's compiled HLO): block alloc, free and share are host
    bookkeeping."""
    for rank in runs["ranks"]:
        assert np.array_equal(rank["decode/counts"],
                              rank["slot_decode/counts"])


def test_serve_cli_paged_under_torchrun(tmp_path, capsys):
    """``--paged --prefill-chunk 4`` on 4 gloo ranks: the pool asserted on
    the mesh, the summary line printed, the tokens world 1's paged ones,
    which are world 1's static ones."""
    from repro_torch.launch.serve import main
    cli = ["--arch", "qwen3-14b", "--device", "cpu", "--batch", "3",
           "--prompt-len", "6", "--new-tokens", "4"]
    static = main(cli).tolist()
    paged = [r.generated for r in main(cli + ["--paged", "--prefill-chunk",
                                              "4"])]
    capsys.readouterr()
    assert paged == static
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(SP), "-m", "repro_torch.launch.serve",
         *cli, "--paged", "--prefill-chunk", "4", "--metrics",
         str(tmp_path / "m.json")], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    text = out.stdout
    assert text.count("KV pool sequence-sharded over 4-way model dim: OK") \
        == 1
    assert "prefill chunks" in text and "paged: " in text
    got = [json.loads(m) for m in re.findall(r"s: (\[[^\]]*\])", text)]
    assert got == static
    facts = json.loads((tmp_path / "m.json").read_text())
    assert facts["n_devices"] == SP and facts["prefill_chunk_steps"] == 6
