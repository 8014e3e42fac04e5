"""MoE served on a ``("data", "model")`` mesh under ``dsp`` and ``tp``,
with ``ep`` and without: 4 gloo ranks (``tests/_torch_moe_serve_worker.py``)
beside JAX on 4 simulated devices (``tests/_torch_moe_serve_jax.py``), on
arctic-480b's and qwen2-moe-a2.7b's SMOKE configs with JAX's init.

A serving step holds its tokens whole on every model rank, so each rank
routes the whole step (capacity from the step's own token count); under
``ep`` each rank runs its block of experts and one all-reduce adds the
blocks, under ``tp`` the experts' partials go through the block's one
sum.  The prefill routes as the training forward does, its padding
taking no expert slot.  Bars: at (1, 4) the prefill's and a decode
step's logits within 1e-5 of the largest |value| of JAX's
``ServingEngine(mesh=, plan=)`` and ``generate``'s tokens equal to its,
under each of ``dsp``, ``dsp`` + ``ep``, ``tp`` and ``tp`` + ``ep``; per
rank the calls and bytes exactly ``lm.serve_contract``; the continuous
scheduler through ``replan(2)`` and the paged one, arctic at (2, 2)
under ``tp`` + ``ep`` without ZeRO, and a 13-token prompt the ranks do
not divide (with the router biased so that its capacity binds) against
the port's engine on one device, which ``tests/test_torch_moe.py`` holds
against JAX's."""
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
from _torch_moe_serve_jax import (BATCH, BLOCK, CHUNK, CONT_BUDGETS,
                                  MAX_LEN, MESH, NEW, PLANS, PROMPT, SHORT,
                                  biased)
from _torch_moe_serve_worker import POOLS
from _torch_moe_tp_jax import JAX_XLA_FLAGS, WORLD, configs
from repro.models import lm as JL
from repro_torch import bridge
from repro_torch.models import lm as TL
from repro_torch.models import moe as TM
from repro_torch.parallel.partition import ParallelPlan
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import ContinuousScheduler, PagedScheduler
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CFGS = configs("repro_torch")
CASES = [f"{c}/{p}" for c in sorted(CFGS) for p in PLANS]
BAR = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("moe_serve"))
    trees = {c: jax.tree_util.tree_map(np.asarray, JL.init_lm(
        jax.random.PRNGKey(0), cfg)) for c, cfg in configs("repro").items()}
    for c, tree in trees.items():
        np.savez(os.path.join(work, f"params_{c}.npz"), **flatten(tree))
    prompts = np.random.RandomState(7).randint(0, 512, (BATCH, SHORT + 1))
    np.savez(os.path.join(work, "inputs.npz"),
             prompts=prompts.astype(np.int32))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=JAX_XLA_FLAGS, OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable,
                    os.path.join(HERE, "_torch_moe_serve_jax.py"), work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_moe_serve_worker.py"),
                            str(r), str(WORLD), work]
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
    return {"params": trees, "prompts": torch.from_numpy(prompts).long(),
            "jax": dict(np.load(os.path.join(work, "jax.npz"))),
            "ranks": [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                      for r in range(WORLD)]}


@pytest.fixture(scope="module")
def alone(runs):
    """The port's engine on one device, per config: ``generate`` at the
    12-token prompts, the continuous and paged schedulers' tokens, and
    with the router biased the 13-token prompts' prefill logits and
    ``generate``."""
    out = {}
    prompts = runs["prompts"]
    for c, tree in runs["params"].items():
        cfg = CFGS[c]
        eng = ServingEngine(bridge.params_from_numpy(tree, device="cpu"),
                            cfg, max_len=MAX_LEN, device="cpu")
        got = {"generate": eng.generate(prompts[:, :PROMPT], NEW).numpy()}
        for kind, sched in (
                ("continuous", ContinuousScheduler(eng, max_batch=2)),
                ("paged", PagedScheduler(eng, max_batch=2, block_size=BLOCK,
                                         prefill_chunk=CHUNK))):
            reqs = _requests(prompts)
            sched.run(reqs)
            got[kind] = [r.generated for r in reqs]
        skewed = ServingEngine(bridge.params_from_numpy(biased(tree),
                                                        device="cpu"),
                               cfg, max_len=MAX_LEN, device="cpu")
        got["short_prefill"] = skewed._prefill(prompts[:, :SHORT])[0].numpy()
        got["short_generate"] = skewed.generate(prompts[:, :SHORT],
                                                NEW).numpy()
        out[c] = got
    return out


def _requests(prompts):
    return [Request(prompt=prompts[i % BATCH, :PROMPT], max_new_tokens=m,
                    request_id=i) for i, m in enumerate(CONT_BUDGETS)]


def _vocab(runs, key, what):
    """(B, 1, V) logits from the ranks' vocab chunks at (1, 4)."""
    parts = {int(r[f"{key}/coord"][1]): r[f"{key}/{what}"]
             for r in runs["ranks"]}
    return np.concatenate([parts[j] for j in range(MESH[1])], axis=-1)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _plan(key) -> ParallelPlan:
    mode, ep = PLANS[key.split("/")[1]]
    return ParallelPlan(mode=mode, ep=ep)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("key", CASES)
def test_logits_match_jax(runs, key, what):
    """The prefill's and a decode step's logits within 1e-5 of the
    largest |value| of JAX's engine on the same mesh and plan."""
    assert _rel(_vocab(runs, key, what), runs["jax"][f"{key}/{what}"]) < BAR


@pytest.mark.parametrize("key", CASES)
def test_generate_matches_jax(runs, key):
    """``generate`` on every rank gives the tokens of JAX's engine on the
    same mesh and plan, which are one device's."""
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank[f"{key}/generate"],
                                      runs["jax"][f"{key}/generate"])


@pytest.mark.parametrize("key", CASES)
def test_prefill_calls_are_the_contract(runs, key):
    """Per rank, a prefill and its argmax: exactly ``lm.serve_contract``,
    the MoE layers' count exchanges and (under ``ep``) dispatches as the
    training forward issues them, with the rows ``route_rows`` finds in
    the run's routing."""
    cname = key.split("/")[0]
    cfg, plan = CFGS[cname], _plan(key)
    whole = bridge.params_from_numpy(runs["params"][cname], device="cpu")
    routes = None
    if plan.ep:
        calls = sum(k.startswith(f"{key}/route") for k in runs["ranks"][0])
        routes = [torch.from_numpy(np.concatenate(
            [r[f"{key}/route{i}/experts"] for r in sorted(
                runs["ranks"], key=lambda r: int(r[f"{key}/coord"][1]))],
            axis=1)) for i in range(calls)]
    for rank in runs["ranks"]:
        j = int(rank[f"{key}/coord"][1])
        rows = (route_rows(routes, TL.moe_meta(cfg).e_phys,
                           lm_capacity(cfg, PROMPT), 1, MESH[1], 0, j)
                if plan.ep else None)
        want = TL.serve_contract(cfg, MESH[1], whole, plan,
                                 prefill=(BATCH, PROMPT), max_len=MAX_LEN,
                                 moe_rows=rows)
        got = rank[f"{key}/prefill_counts"]
        assert got.tolist() == [[want[p].get(k, 0) for k in KINDS]
                                for p in ("calls", "bytes")], j


@pytest.mark.parametrize("key", CASES)
def test_decode_calls_are_the_contract(runs, key):
    """Per rank, a decode step and its argmax: exactly
    ``lm.serve_contract``, per MoE layer one all-reduce under ``ep`` or
    ``tp`` (the blocks' or the partials' sum) and none under ``dsp``
    alone."""
    for rank in runs["ranks"]:
        assert (rank[f"{key}/decode_counts"].tolist()
                == rank[f"{key}/decode_contract"].tolist())
    # the all-reduces: the embedding's, under tp each attention output's,
    # and each MoE layer's under ep or tp (every layer is one of each)
    mode, ep = PLANS[key.split("/")[1]]
    layers = CFGS[key.split("/")[0]].n_layers
    sums = runs["ranks"][0][f"{key}/decode_counts"][0][KINDS.index(
        "all-reduce")]
    assert sums == 1 + layers * (mode == "tp") + layers * (mode == "tp"
                                                           or ep)


@pytest.mark.parametrize("key", CASES)
def test_short_prompt_prefill_matches_one_device(runs, alone, key):
    """A 13-token prompt, padded to 16 over 4 ranks, with the router
    biased so that expert 0's capacity binds: the prefill's logits within
    1e-5 of one device's unpadded prefill (the padding takes no slot and
    the capacity is the 13 tokens')."""
    want = alone[key.split("/")[0]]["short_prefill"]
    assert _rel(_vocab(runs, key, "short_prefill"), want) < BAR


@pytest.mark.parametrize("cname", sorted(CFGS))
def test_short_prompt_generate_matches_one_device(runs, alone, cname):
    """``generate`` at the 13-token prompts (router biased) under the
    config's continuous plan: one device's tokens on every rank."""
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank[f"{cname}/short_generate"],
                                      alone[cname]["short_generate"])


@pytest.mark.parametrize("kind", ["continuous", "paged"])
@pytest.mark.parametrize("cname", sorted(CFGS))
def test_pools_match_one_device(runs, alone, cname, kind):
    """The continuous scheduler (2 slots, ``replan(2)`` at decode step 3
    onto ranks 0-1) and the paged one (8-token blocks and chunks, a
    chunk's tokens whole on every rank) give one device's tokens, under
    ``POOLS``' plans."""
    ranks = runs["ranks"][:2] if kind == "continuous" else runs["ranks"]
    for rank in ranks:
        got = [rank[f"{cname}/{kind}/{i}"].tolist()
               for i in range(len(CONT_BUDGETS))]
        assert got == alone[cname][kind], POOLS[cname]


@pytest.mark.parametrize("cname", sorted(CFGS))
def test_replan_moves_the_experts(runs, cname):
    """``replan(2)`` mid-trace: the pool gathered whole before and after
    is bit-equal, the engine runs on 2 model ranks (the expert blocks
    re-placed onto them), and every rank's calls and bytes are
    ``lm.serve_contract(migrate=)``'s."""
    for rank in runs["ranks"]:
        assert (rank[f"{cname}/migrate_counts"].tolist()
                == rank[f"{cname}/migrate_contract"].tolist())
    for rank in runs["ranks"][:2]:
        assert int(rank[f"{cname}/sp_after"]) == 2
        assert rank[f"{cname}/moved_equal"].all()


def test_tp_ep_on_a_data_mesh(runs, alone):
    """arctic at (2, 2) under ``tp`` + ``ep`` without ZeRO: each rank
    holds 4 of the 8 experts with half of each one's hidden columns
    (``param_pspecs``' serving rule), reads its block's experts whole over
    ``data``, gives one device's tokens, and a decode step issues exactly
    ``lm.serve_contract``'s calls and bytes."""
    cfg = CFGS["arctic"]
    for rank in runs["ranks"]:
        assert rank["2x2/expert_shape"].tolist() == [
            cfg.n_periods, cfg.n_experts // 2, cfg.d_model, cfg.d_ff // 2]
        np.testing.assert_array_equal(rank["2x2/generate"],
                                      alone["arctic"]["generate"])
        assert (rank["2x2/decode_counts"].tolist()
                == rank["2x2/decode_contract"].tolist())


def test_padding_takes_no_expert_slot():
    """``moe_gather(length=)`` on a row padded from 13 to 16 tokens gives
    the unpadded row's outputs and drops bit for bit, where the capacity
    binds (router biased); without ``length`` the padded row's capacity
    keeps more pairs and the outputs move."""
    cfg = CFGS["arctic"]
    meta = TL.moe_meta(cfg)
    params = TL.init_lm(0, cfg, device="cpu")
    p = TL.unstack(params["periods"], cfg.n_periods)[0]["0"]["moe"]
    p = {**p, "router": {**p["router"], "b": torch.tensor(
        [1.2] + [0.0] * (meta.e_phys - 1))}}
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    want, aux = TM.moe(p, x[:, :SHORT], meta)
    got, gaux = TM.moe(p, x, meta, length=SHORT)
    assert aux["dropped"] > 0
    assert torch.equal(got[:, :SHORT], want)
    assert float(gaux["dropped"]) == float(aux["dropped"])
    unmasked, _ = TM.moe(p, x, meta)
    assert not torch.allclose(unmasked[:, :SHORT], want, atol=1e-6)
