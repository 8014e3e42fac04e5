"""The port's ServingEngine against the JAX engine on the same requests, at
qwen3-14b's SMOKE size on the CPU: static ``generate`` and continuous
``serve`` give the JAX engine's tokens, and within the port continuous
serving is token-identical to static (the oracle of tests/test_serving.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_14b as jconf
from repro.models.lm import init_lm
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import qwen3_14b as tconf
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import ContinuousScheduler, replay_static
from _torch_threads import one_thread  # noqa: E402,F401

MAX_LEN = 24


@pytest.fixture(scope="module")
def engines():
    jp = init_lm(jax.random.PRNGKey(0), jconf.SMOKE)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return (JEngine(jp, jconf.SMOKE, max_len=MAX_LEN),
            ServingEngine(tp, tconf.SMOKE, max_len=MAX_LEN, device="cpu"))


@pytest.fixture(scope="module")
def prompts():
    return np.random.RandomState(1).randint(0, jconf.SMOKE.vocab, (3, 8))


def _reqs(cls, prompts, budgets, lens=None):
    return [cls(prompt=p[:n] if lens else p, max_new_tokens=m, request_id=i)
            for i, (p, m, n) in enumerate(
                zip(prompts, budgets, lens or budgets))]


@pytest.mark.parametrize("budget", [6, [6, 3, 1]])
def test_generate_matches_jax(engines, prompts, budget):
    jeng, teng = engines
    want = np.asarray(jeng.generate(jnp.asarray(prompts), budget, pad_id=-1))
    got = teng.generate(torch.from_numpy(prompts), budget, pad_id=-1)
    assert np.array_equal(got.cpu().numpy(), want)


def test_generate_eos_matches_jax(engines, prompts):
    jeng, teng = engines
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), 6))
    eos = int(ref[1, 2])
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 6, eos_id=eos,
                                    pad_id=-1))
    got = teng.generate(torch.from_numpy(prompts), 6, eos_id=eos, pad_id=-1)
    assert np.array_equal(got.numpy(), want)


def test_continuous_matches_jax_and_static(engines, prompts):
    """Ragged prompts and budgets through 2 recycled slots: the port's
    tokens equal the JAX scheduler's, and each request equals the port's
    static generate of that request alone."""
    jeng, teng = engines
    budgets, lens = [6, 4, 5], [8, 5, 7]
    jreqs = _reqs(JRequest, [jnp.asarray(p) for p in prompts], budgets, lens)
    jeng.serve(jreqs, continuous=True, max_batch=2)
    treqs = _reqs(Request, [torch.from_numpy(p) for p in prompts], budgets,
                  lens)
    sched = ContinuousScheduler(teng, max_batch=2)
    teng.serve(treqs, continuous=True, scheduler=sched)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, t.request_id
        alone = teng.generate(torch.as_tensor(t.prompt)[None],
                              t.max_new_tokens)
        assert t.generated == alone[0].tolist()
    assert sched.metrics.slots_allocated == 3 > sched.max_batch
    assert sched.pool.n_free == 2 and sched.pool.committed_tokens == 0
    s = sched.metrics.summary()
    assert s["tokens_generated"] == sum(budgets)
    assert s["ttft_p50_s"] is not None and s["tpot_p50_s"] is not None


def test_static_serve_equals_continuous(engines, prompts):
    _, teng = engines
    static = teng.serve(_reqs(Request, torch.from_numpy(prompts), [5, 5, 5]))
    cont = teng.serve(_reqs(Request, torch.from_numpy(prompts), [5, 5, 5]),
                      continuous=True, max_batch=3)
    assert [r.generated for r in static] == [r.generated for r in cont]
    assert all(r.result.finish_reason == "budget" for r in cont)


def test_replay_static_equal_lengths_is_exact(engines, prompts):
    _, teng = engines
    reqs, metrics = replay_static(
        teng, _reqs(Request, torch.from_numpy(prompts), [4, 4, 4]),
        max_batch=2)
    want = teng.generate(torch.from_numpy(prompts), 4)
    assert [r.generated for r in reqs] == want.tolist()
    assert metrics.prefills == 2 and metrics.summary()["padded_rows"] == 0


def test_compact_keeps_decoding_right(engines, prompts):
    """Compacting mid-run moves live slots without changing any token."""
    _, teng = engines
    want = teng.generate(torch.from_numpy(prompts), 6).tolist()
    reqs = _reqs(Request, torch.from_numpy(prompts), [2, 6, 6])
    ContinuousScheduler(teng, max_batch=3).run(
        reqs, on_step=lambda s, i: s.compact() if i == 2 else None)
    assert reqs[0].generated == want[0][:2]
    assert [r.generated for r in reqs[1:]] == want[1:]


def test_serve_cli_continuous_equals_static(capsys, tmp_path):
    from repro_torch.launch.serve import main
    args = ["--arch", "qwen3-14b", "--device", "cpu", "--batch", "3",
            "--prompt-len", "6", "--new-tokens", "4"]
    static = main(args)
    reqs = main(args + ["--continuous", "--max-batch", "2"])
    assert [r.generated for r in reqs] == static.tolist()
    assert '"tokens_generated": 12' in capsys.readouterr().out
    # --paged is ported: the paged scheduler's tokens are the static path's
    paged = main(args + ["--paged", "--max-batch", "2"])
    assert [r.generated for r in paged] == static.tolist()
    assert "prefill chunks" in capsys.readouterr().out
    # --ckpt-dir is ported: a directory with no checkpoint raises
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        main(args + ["--ckpt-dir", str(tmp_path)])
