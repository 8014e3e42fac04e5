"""The port's LM serving path against the JAX package at qwen3-14b's SMOKE
size (float32, 2 layers, d_model 64): ``forward_prefill`` logits and caches
(JAX through the Pallas kernel, interpret mode) and ``forward_decode``
logits over 4 steps with scalar and per-slot positions.  JAX weights cross
over through ``bridge.params_from_numpy``.  Tolerance 1e-4: sums over two
layers in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_14b as jconf
from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.configs import qwen3_14b as tconf
from repro_torch.models import lm as TLM

TOL = dict(atol=1e-4, rtol=1e-4)
JCFG, TCFG = jconf.SMOKE, tconf.SMOKE


@pytest.fixture(scope="module")
def params():
    jp = JLM.init_lm(jax.random.PRNGKey(0), JCFG)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jp, tp


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, JCFG.vocab, shape)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL)


def _close_tree(got, want):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        _close(g, w)


def test_configs_match_jax():
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "qk_norm", "rope_theta", "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert jnp.dtype(j.dtype).name == str(t.dtype).split(".")[-1]
    assert TLM.param_counts(tconf.CONFIG) == JLM.param_counts(jconf.CONFIG)


def test_init_tree_matches_jax(params):
    """Same keys and shapes, so weights cross over with no transpose."""
    jp, _ = params
    tp = TLM.init_lm(0, TCFG, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = TLM.tree_map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    w = tp["periods"]["0"]["mlp"]["wi"]["w"]
    assert abs(float(w.std()) * np.sqrt(TCFG.d_model) - 1) < 0.05


def test_prefill_matches_jax(params):
    jp, tp = params
    tok = _tokens((2, 24), 1)
    jl, jc = JLM.forward_prefill(jp, jnp.asarray(tok), JCFG, backend="pallas")
    tl, tc = TLM.forward_prefill(tp, torch.from_numpy(tok), TCFG)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 24
    _close_tree(tc["periods"], jc["periods"])


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_matches_jax(params, per_slot):
    jp, tp = params
    b, max_len = 2, 20
    rng = np.random.RandomState(2)
    shape = (JCFG.n_periods, b, JCFG.n_kv_heads, max_len, JCFG.head_dim)
    kv = {"0": {"kv": {"k": rng.standard_normal(shape).astype(np.float32),
                       "v": rng.standard_normal(shape).astype(np.float32)}}}
    pos = np.array([5, 11]) if per_slot else np.array(7)
    jc = {"pos": jnp.asarray(pos, jnp.int32),
          "periods": jax.tree_util.tree_map(jnp.asarray, kv)}
    tc = {"pos": torch.from_numpy(pos),
          "periods": bridge.params_from_numpy(kv, device="cpu")}
    tok = _tokens((b, 1), 3)
    for _ in range(4):
        jl, jc = JLM.forward_decode(jp, jnp.asarray(tok), jc, JCFG)
        tl, tc = TLM.forward_decode(tp, torch.from_numpy(tok), tc, TCFG)
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close_tree(tc["periods"], jc["periods"])


def test_unported_layer_kinds_raise():
    import dataclasses
    moe = dataclasses.replace(TCFG, n_experts=4, top_k=2)
    with pytest.raises(NotImplementedError):
        TLM.init_lm(0, moe, device="cpu")
