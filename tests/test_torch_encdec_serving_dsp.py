"""The port's enc-dec model served on a ``("data", "model")`` mesh
(``encdec.prefill``/``decode_step(sharder=)``) against the JAX package's,
on the CPU.

4 gloo processes (``tests/_torch_encdec_serve_worker.py``) on one
``FileStore`` beside JAX on 4 simulated devices
(``tests/_torch_encdec_serve_jax.py``, compiled with the cheaper passes
of ``_torch_jax_flags.jax_xla_flags(4)``), from JAX's init (seed 0, f32) of
a SMOKE-shaped model whose vocab 2 divides and 4 does not (the table
whole at (1, 4), the logits vocab-sharded at (2, 2)), 2 requests of 32
frames and 16-token prompts, then 3 decode steps on forced tokens, at (1,
4) and (2, 2), under seamless's plan (``dsp`` + ZeRO-3) and with ``zero``
off.  JAX's caches are padded with numpy to the port's ``MAX_LEN``
before its first decode step (its prefill leaves no room: ROADMAP §3).
The bars, each stated where it is checked: the logits within 1e-5 of the
largest |logit| of JAX's; each rank's cache blocks within 1e-5 of the
largest |value| of the same block of JAX's caches; per rank the calls
and bytes exactly ``encdec.serve_contract``."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.models import encdec as ED
from repro_torch.parallel.partition import ParallelPlan

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_encdec_jax import CONFIG_KW, params_np  # noqa: E402
from _torch_encdec_serve_jax import (BATCH, CONFIG, MAX_LEN,  # noqa: E402
                                     S_ENC, SCENARIOS, STEPS, WORLD, inputs)
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
BAR = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("encdec_serve"))
    np.savez(os.path.join(work, "params.npz"), **flatten(params_np(CONFIG)))
    np.savez(os.path.join(work, "inputs.npz"), **inputs())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS=jax_xla_flags(4), OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable,
                    os.path.join(HERE, "_torch_encdec_serve_jax.py"), work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [
            sys.executable,
            os.path.join(HERE, "_torch_encdec_serve_worker.py"), str(r),
            str(WORLD), work]
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


def _rank_view(rank, name, want):
    """JAX's whole logits (B, 1, V) cut to what ``rank`` holds: its batch
    slice, and its vocab chunk where its logits are vocab-sharded."""
    (dp, n), _ = SCENARIOS[name]
    d, s = rank[f"{name}/coord"].tolist()
    rows = BATCH // dp
    want = want[d * rows:(d + 1) * rows]
    got = rank[f"{name}/prefill/logits"]
    if got.shape[-1] != want.shape[-1]:
        chunk = got.shape[-1]
        assert chunk * n == want.shape[-1]
        want = want[..., s * chunk:(s + 1) * chunk]
    return want


def _gap(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_prefill_logits_match_jax(runs, name):
    """Each rank's prefill logits at the prompt's last position (its
    batch slice; its vocab chunk where the ranks divide the vocab, at (2,
    2)) match JAX's ``prefill(sharder=)`` on the same mesh within BAR of
    the largest |logit|."""
    jx = runs["jax"][f"{name.split('/')[0]}/prefill/logits"]
    for rank in runs["ranks"]:
        got = rank[f"{name}/prefill/logits"]
        assert _gap(got, _rank_view(rank, name, jx)) <= BAR, name


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decode_logits_match_jax(runs, name, step):
    """Each decode step on the forced token, every rank's cache blocks
    written and read in place, gives JAX's ``decode_step(sharder=)``'s
    logits on its test-padded caches within BAR of the largest |logit|."""
    jx = runs["jax"][f"{name.split('/')[0]}/step{step}/logits"]
    for rank in runs["ranks"]:
        got = rank[f"{name}/step{step}/logits"]
        assert _gap(got, _rank_view(rank, name, jx)) <= BAR, (name, step)


@pytest.mark.parametrize("when", ["prefill", "last"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_cache_blocks_match_jax(runs, name, when):
    """After the prefill and after the last step, each rank holds its
    batch slice and its block (``kv_block``) of JAX's caches, as
    ``cache_pspecs`` lays them out: the self-attention K/V of MAX_LEN
    positions (the prompt's, then each step's row, zeros past ``pos``)
    and the cross K/V of S_ENC frames, each within BAR of the block's
    largest |value|; the blocks tile both sequences."""
    (dp, n), _ = SCENARIOS[name]
    jx = runs["jax"]
    mesh = name.split("/")[0]
    seen = {"kv": set(), "cross": set()}
    for rank in runs["ranks"]:
        d, s = rank[f"{name}/coord"].tolist()
        rows = slice(d * BATCH // dp, (d + 1) * BATCH // dp)
        for part, length in (("kv", MAX_LEN), ("cross", S_ENC)):
            lo, hi = rank[f"{name}/{part}_block" if part == "cross"
                          else f"{name}/kv_block"].tolist()
            assert hi - lo == length // n and lo == s * (length // n)
            seen[part].add((d, lo))
            for kv in ("k", "v"):
                got = rank[f"{name}/{when}/{part}/{kv}"]
                want = jx[f"{mesh}/{when}/{part}/{kv}"][:, rows, :, lo:hi]
                assert _gap(got, want) <= BAR, (name, when, part, kv)
    assert all(len(v) == dp * n for v in seen.values())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_calls_and_bytes_are_the_serve_contract(runs, name):
    """Per rank the prefill (with its argmax) and each decode step (with
    its argmax) issue exactly ``encdec.serve_contract``'s calls and
    bytes: at 4 heads the hooks' 2 all-to-alls an encoder layer and 5 a
    decoder layer, the stacked self K/V's one all-gather onto the cache's
    blocks, the last position's all-reduce; a step's two partials'
    all-gathers a decoder layer; ZeRO's reads where ``zero`` splits the
    leaves; the vocab-sharded embedding's all-reduce and argmax's
    all-gather at (2, 2)."""
    (dp, n), zero = SCENARIOS[name]
    cfg = ED.EncDecConfig(**CONFIG_KW[CONFIG], dtype=torch.float32)
    for rank in runs["ranks"]:
        for key, want in [("prefill", "prefill")] + [
                (f"step{i}", "step") for i in range(STEPS)]:
            np.testing.assert_array_equal(
                rank[f"{name}/{key}/calls"],
                rank[f"{name}/{want}/contract_calls"], err_msg=key)
            np.testing.assert_array_equal(
                rank[f"{name}/{key}/bytes"],
                rank[f"{name}/{want}/contract_bytes"], err_msg=key)
        calls = dict(zip(KINDS, rank[f"{name}/prefill/calls"].tolist()))
        assert calls["all-to-all"] == 2 * cfg.n_enc_layers \
            + 5 * cfg.n_dec_layers
        step = dict(zip(KINDS, rank[f"{name}/step0/calls"].tolist()))
        split = cfg.vocab % n == 0
        assert step["all-reduce"] == int(split)
        # the partials, the argmax's pairs, and ZeRO's reads (the table is
        # split by vocab or whole: the step reads it where it lies)
        assert step["all-gather"] >= 2 * cfg.n_dec_layers + int(split)
        assert (step["all-gather"] > 2 * cfg.n_dec_layers + int(split)) \
            == zero


def test_lengths_the_ranks_do_not_divide_are_refused(runs):
    """A frame count the model ranks do not divide (30 over 4) is refused
    by the port (``shard_lm_batch``, ``ValueError``) as JAX refuses to
    place it (``device_put``); so is a cache length they do not divide
    (``init_dec_caches(sharder=)``, through ``kv_block``)."""
    assert int(runs["jax"]["uneven/raises"]) == 1
    for rank in runs["ranks"]:
        for name, ((_, n), _) in SCENARIOS.items():
            refused = set(rank[f"{name}/refused"].tolist())
            assert ("frames" in refused) == (30 % n != 0), name
            assert "max_len" in refused, name


def test_serve_contract_counts_by_hand():
    """``encdec.serve_contract`` at seamless's full shapes, counted by
    hand: at (1, 4) under its plan a prefill issues 24 x 2 + 24 x 5 = 168
    all-to-alls, one all-reduce, and 1 + the ZeRO reads' all-gathers (one
    per split leaf a layer, the table's two splits over ``data`` and
    ``model`` flattened into one entry); a decode step 2 x 24 partials'
    all-gathers, each n x rows x heads x (D + 2) float32, beside its
    reads, and no argmax all-gather (4 does not divide 256206)."""
    import jax
    from repro.configs import seamless_m4t_large_v2 as JSC
    from repro.models import encdec as JE
    from repro_torch.configs import seamless_m4t_large_v2 as TSC
    cfg = TSC.CONFIG
    meta = jax.tree_util.tree_map(
        lambda a: torch.empty(a.shape, dtype=torch.bfloat16, device="meta"),
        jax.eval_shape(lambda: JE.init_encdec(jax.random.PRNGKey(0),
                                              JSC.CONFIG)))
    plan = TSC.SPEC.plan
    pre = ED.serve_contract(cfg, 4, meta, plan, prefill=(4, 4096, 16))
    assert pre["calls"]["all-to-all"] == 168
    assert pre["calls"]["all-reduce"] == 1
    assert pre["bytes"]["all-reduce"] == 2 * 4 * cfg.d_model * 2
    step = ED.serve_contract(cfg, 4, meta, plan, decode=4)
    none = ED.serve_contract(cfg, 4, meta, ParallelPlan(
        mode="dsp", zero=False, shard_vocab=False), decode=4)
    assert none["calls"] == {"all-gather": 48}
    assert none["bytes"]["all-gather"] == 48 * 4 * 4 * 16 * (64 + 2) * 4
    assert step["calls"]["all-gather"] > 48 and "all-reduce" not in \
        step["calls"]
