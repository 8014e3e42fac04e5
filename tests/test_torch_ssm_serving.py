"""The port's mamba2 serving path against the JAX package at mamba2-370m's
SMOKE size (float32, 4 layers, d_model 64): the closed-form final SSD state,
the prefill block's cache, the O(1) decode step, the stacked caches,
prefill + decode logits, and the engine's greedy tokens.  JAX weights
cross over through ``bridge.params_from_numpy``; inputs cross as numpy.
Bars: the state 1e-5 relative (one contraction against the sequential
scan, f32); blocks, logits and caches 1e-4 relative (the port's prefill
takes y from the chunked scan where JAX's takes the sequential one)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_370m as jconf
from repro.kernels import ref as jref
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import mamba2_370m as tconf
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as TLM
from repro_torch.models import ssm as TS
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.scheduler import ContinuousScheduler
from _torch_threads import one_thread  # noqa: E402,F401

JCFG, TCFG = jconf.SMOKE, tconf.SMOKE
SCFG_J, SCFG_T = JCFG.ssm_cfg, TCFG.ssm_cfg
K = SCFG_T.d_conv - 1
MAX_LEN = 48


def _cross(jtree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                    device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _pairs(ttree, jtree, path=""):
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(ttree[k], jtree[k], f"{path}/{k}")
    else:
        yield path, ttree, jtree


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_lm(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def block_params():
    jp = JS.init_ssm(jax.random.PRNGKey(3), SCFG_J)
    return jp, _cross(jp)


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, JCFG.vocab, shape)


# ---------------------------------------------------------------------------
# kernels/ref.py: the closed-form final state
# ---------------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, g, s, seed):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, l, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    a = -np.exp(0.5 * rng.standard_normal(h))
    bm = rng.standard_normal((b, l, g, s))
    cm = rng.standard_normal((b, l, g, s))
    st = rng.standard_normal((b, h, p, s))
    return [t.astype(np.float32) for t in (x, dt, a, bm, cm, st)]


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_final_state_matches_jax_ssd_ref(g, with_init):
    x, dt, a, bm, cm, st = _ssd_inputs(2, 150, 4, 16, g, 32, seed=g)
    init = st if with_init else None
    _, want = jref.ssd_ref(*map(jnp.asarray, (x, dt, a, bm, cm)),
                           init_state=None if init is None
                           else jnp.asarray(init), return_state=True)
    got = tref.ssd_final_state(
        *map(torch.from_numpy, (x, dt, a, bm, cm)),
        init_state=None if init is None else torch.from_numpy(init))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-5


def test_ssd_final_state_is_the_port_ssd_ref_state():
    """bf16 inputs as the model gives them, and a long run of strong decay:
    the same state as the port's sequential oracle."""
    x, dt, a, bm, cm, _ = _ssd_inputs(1, 700, 4, 16, 1, 32, seed=5)
    tin = [torch.from_numpy(t) for t in (x, dt, a, bm, cm)]
    for i in (0, 1, 3, 4):
        tin[i] = tin[i].bfloat16()
    tin[2] = tin[2] * 8
    _, want = tref.ssd_ref(*tin, return_state=True)
    assert _rel(tref.ssd_final_state(*tin), want) < 1e-5


# ---------------------------------------------------------------------------
# models/ssm.py: prefill cache and the decode step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l", [2, 37])
def test_ssm_block_cache_matches_jax(block_params, l):
    """Output and state as JAX's ``ssm_block(return_cache=True)``; ``conv``
    too, where JAX's slice of a prompt shorter than ``d_conv - 1`` is
    short and the port's has zeros on the left."""
    jp, tp = block_params
    x = np.random.RandomState(9).standard_normal(
        (2, l, SCFG_J.d_model)).astype(np.float32)
    want, jc = JS.ssm_block(jp, jnp.asarray(x), SCFG_J, backend="ref",
                            return_cache=True)
    got, tc = TS.ssm_block(tp, torch.from_numpy(x), SCFG_T,
                           return_cache=True)
    assert _rel(got, want) < 1e-4
    assert _rel(tc["state"], jc["state"]) < 1e-4
    assert tc["state"].dtype == torch.float32
    assert tuple(tc["conv"].shape) == (2, K, jc["conv"].shape[-1])
    jconv = np.asarray(jc["conv"])
    pad = K - jconv.shape[1]
    assert np.array_equal(_np(tc["conv"])[:, :pad], np.zeros_like(
        _np(tc["conv"])[:, :pad]))
    np.testing.assert_allclose(_np(tc["conv"])[:, pad:], jconv, rtol=1e-5,
                               atol=1e-6)


def test_ssm_block_without_cache_is_unchanged(block_params):
    _, tp = block_params
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (1, 20, SCFG_T.d_model)).astype(np.float32))
    out, _ = TS.ssm_block(tp, x, SCFG_T, return_cache=True)
    assert torch.equal(out, TS.ssm_block(tp, x, SCFG_T))


def test_init_ssm_cache_and_decode_steps_match_jax(block_params):
    jp, tp = block_params
    jc = JS.init_ssm_cache(2, SCFG_J)
    tc = TS.init_ssm_cache(2, SCFG_T, device="cpu")
    for k in ("conv", "state"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype)[6:] == jc[k].dtype.name
        assert not tc[k].any()
    xs = np.random.RandomState(6).standard_normal(
        (8, 2, 1, SCFG_J.d_model)).astype(np.float32)
    for t in range(8):
        jy, jc = JS.ssm_decode_step(jp, jnp.asarray(xs[t]), SCFG_J, jc)
        ty, new = TS.ssm_decode_step(tp, torch.from_numpy(xs[t]), SCFG_T, tc)
        assert new["conv"].data_ptr() != tc["conv"].data_ptr()
        tc = new
        assert _rel(ty, jy) < 1e-5, t
        for k in ("conv", "state"):
            assert _rel(tc[k], jc[k]) < 1e-5, (t, k)


def test_init_ssm_cache_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.init_ssm_cache(1, SCFG_T)


# ---------------------------------------------------------------------------
# models/lm.py: caches, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_slot", [False, True])
def test_init_caches_match_jax(per_slot):
    want = JLM.init_caches(JCFG, 3, 20, per_slot_pos=per_slot)
    got = TLM.init_caches(TCFG, 3, 20, per_slot_pos=per_slot, device="cpu")
    assert TLM.tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                        got["periods"]) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), a.dtype.name), want["periods"])
    assert tuple(got["pos"].shape) == want["pos"].shape
    assert not any(a.any() for a in TLM.tree_leaves(got))
    bf16 = TLM.init_caches(dataclasses.replace(TCFG, dtype=torch.bfloat16),
                           1, 8, device="cpu")["periods"]["0"]["ssm"]
    assert bf16["conv"].dtype == torch.bfloat16
    assert bf16["state"].dtype == torch.float32


def test_prefill_and_decode_match_jax(jparams):
    """A 13-token prefill, then 8 decode steps on the JAX engine's own
    tokens: logits and every cache leaf as JAX's at each step."""
    tok = _tokens(1, (2, 13))
    nxt = _tokens(2, (8, 2, 1))
    jl, jc = JLM.forward_prefill(jparams, jnp.asarray(tok), JCFG,
                                 backend="ref")
    tp = _cross(jparams)
    with torch.no_grad():
        tl, tc = TLM.forward_prefill(tp, torch.from_numpy(tok), TCFG)
        assert _rel(tl, jl) < 1e-4
        assert int(tc["pos"]) == int(jc["pos"]) == 13
        for path, t, j in _pairs(tc["periods"], jc["periods"]):
            assert _rel(t, j) < 1e-4, path
        for step in range(8):
            jl, jc = JLM.forward_decode(jparams, jnp.asarray(nxt[step]), jc,
                                        JCFG)
            tl, tc = TLM.forward_decode(tp, torch.from_numpy(nxt[step]), tc,
                                        TCFG)
            assert _rel(tl, jl) < 1e-4, step
            for path, t, j in _pairs(tc["periods"], jc["periods"]):
                assert _rel(t, j) < 1e-4, (step, path)
    assert int(tc["pos"]) == 21


@pytest.mark.parametrize("l", [1, 2, 37])
def test_prefill_equals_token_by_token_decode(jparams, l):
    """Prefill of L tokens leaves the caches and last logits that decoding
    the same tokens one by one from zero caches leaves, also for prompts
    shorter than ``d_conv - 1`` (conv: zeros on the left)."""
    tp = _cross(jparams)
    tok = torch.from_numpy(_tokens(3, (2, l)))
    with torch.no_grad():
        pl, pc = TLM.forward_prefill(tp, tok, TCFG)
        caches = TLM.init_caches(TCFG, 2, MAX_LEN, device="cpu")
        for t in range(l):
            dl, caches = TLM.forward_decode(tp, tok[:, t:t + 1], caches,
                                            TCFG)
    assert _rel(pl, dl) < 1e-4
    for path, p, d in _pairs(pc["periods"], caches["periods"]):
        assert p.shape == d.shape, path
        assert _rel(p, d) < 1e-4, path
    if l < K:
        assert not pc["periods"]["0"]["ssm"]["conv"][:, :, :K - l].any()


# ---------------------------------------------------------------------------
# serving: engine, scheduler, pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(jparams):
    return (JEngine(jparams, JCFG, max_len=MAX_LEN),
            ServingEngine(_cross(jparams), TCFG, max_len=MAX_LEN,
                          device="cpu"))


def test_engine_prefill_widens_only_kv_leaves(engines):
    _, teng = engines
    _, caches = teng._prefill(torch.from_numpy(_tokens(4, (1, 9))))
    ssm = caches["periods"]["0"]["ssm"]
    assert tuple(ssm["conv"].shape[2:]) == (K, SCFG_T.d_inner +
                                            2 * SCFG_T.d_state)
    assert tuple(ssm["state"].shape[2:]) == (SCFG_T.n_heads,
                                             SCFG_T.head_dim,
                                             SCFG_T.d_state)


def test_generate_matches_jax(engines):
    jeng, teng = engines
    prompts = _tokens(5, (3, 8))
    want = np.asarray(jeng.generate(jnp.asarray(prompts), [6, 3, 5],
                                    pad_id=-1))
    got = teng.generate(torch.from_numpy(prompts), [6, 3, 5], pad_id=-1)
    assert np.array_equal(got.numpy(), want)


def test_continuous_matches_jax_and_static(engines):
    """Ragged prompts (all at least ``d_conv - 1`` long, which the JAX pool
    needs) through 2 recycled slots: the JAX scheduler's tokens, and each
    request's static generate alone."""
    jeng, teng = engines
    prompts = _tokens(6, (3, 8))
    budgets, lens = [6, 4, 5], [8, 3, 7]
    jreqs = [JRequest(prompt=jnp.asarray(p[:n]), max_new_tokens=m,
                      request_id=i)
             for i, (p, m, n) in enumerate(zip(prompts, budgets, lens))]
    jeng.serve(jreqs, continuous=True, max_batch=2)
    treqs = [Request(prompt=torch.from_numpy(p[:n]), max_new_tokens=m,
                     request_id=i)
             for i, (p, m, n) in enumerate(zip(prompts, budgets, lens))]
    sched = ContinuousScheduler(teng, max_batch=2)
    teng.serve(treqs, continuous=True, scheduler=sched)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, t.request_id
        alone = teng.generate(torch.as_tensor(t.prompt)[None],
                              t.max_new_tokens)
        assert t.generated == alone[0].tolist()
    assert sched.metrics.slots_allocated == 3 > sched.max_batch


def test_short_prompt_reuses_a_slot_cleanly(engines):
    """A 1-token prompt served in the slot a longer request just left: its
    tokens are those of its static generate alone (the JAX pool would keep
    the old request's conv rows there)."""
    _, teng = engines
    prompts = _tokens(7, (2, 9))
    reqs = [Request(prompt=torch.from_numpy(prompts[0]), max_new_tokens=3,
                    request_id=0),
            Request(prompt=torch.from_numpy(prompts[1, :1]), max_new_tokens=4,
                    request_id=1)]
    teng.serve(reqs, continuous=True, max_batch=1)
    alone = teng.generate(torch.from_numpy(prompts[1, :1])[None], 4)
    assert reqs[1].generated == alone[0].tolist()


def test_kv_pool_insert_and_compact_on_ssm_leaves(engines):
    _, teng = engines
    pool = KVPool(TCFG, 3, MAX_LEN, device="cpu")
    rows = {}
    for n, seed in ((5, 8), (11, 9)):
        slot = pool.alloc(n + 2)
        _, rows[slot] = teng._prefill(torch.from_numpy(_tokens(seed, (1, n))))
        pool.insert(slot, rows[slot], n)
    ssm = pool.caches["periods"]["0"]["ssm"]
    for slot, row in rows.items():
        for k in ("conv", "state"):
            assert torch.equal(ssm[k][:, slot], row["periods"]["0"]["ssm"][k]
                               [:, 0])
    assert pool.active_slots() == [0, 1]
    pool.free(0)
    mapping = pool.compact()
    assert mapping == {1: 0}
    ssm = pool.caches["periods"]["0"]["ssm"]
    for k in ("conv", "state"):
        assert torch.equal(ssm[k][:, 0], rows[1]["periods"]["0"]["ssm"][k]
                           [:, 0])
    assert int(pool.caches["pos"][0]) == 11


def test_serve_cli_serves_mamba2(capsys):
    from repro_torch.launch.serve import main
    args = ["--arch", "mamba2-370m", "--device", "cpu", "--batch", "3",
            "--prompt-len", "6", "--new-tokens", "4"]
    static = main(args)
    reqs = main(args + ["--continuous", "--max-batch", "2"])
    assert [r.generated for r in reqs] == static.tolist()
    assert '"tokens_generated": 12' in capsys.readouterr().out
