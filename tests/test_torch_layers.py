"""Each ported layer function against its JAX counterpart: JAX parameters
cross over through ``repro_torch.bridge.params_from_numpy``, inputs are
made with numpy from a seed, float32 throughout (1e-5: the two frameworks
sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.parallel.partition import ParallelPlan, make_sharder
from repro_torch import bridge
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)


def _rand(shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _cross(jtree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                    device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("bias", [False, True])
def test_linear(bias):
    jp = JL.init_linear(KEY, 24, 40, bias=bias)
    if bias:
        jp["b"] = jnp.asarray(_rand((40,), 5))
    x = _rand((2, 3, 24))
    _close(TL.linear(_cross(jp), torch.from_numpy(x)),
           JL.linear(jp, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [{}, {"scale_plus_one": True},
                                {"upcast": False}])
def test_rms_norm(kw):
    jp = {"scale": jnp.asarray(_rand((32,), 1)),
          "bias": jnp.asarray(_rand((32,), 2))}
    x = _rand((2, 5, 32), 3)
    _close(TL.rms_norm(_cross(jp), torch.from_numpy(x), **kw),
           JL.rms_norm(jp, jnp.asarray(x), **kw))


def test_layer_norm():
    jp = {"scale": jnp.asarray(_rand((32,), 1)),
          "bias": jnp.asarray(_rand((32,), 2))}
    x = _rand((2, 5, 32), 3)
    _close(TL.layer_norm(_cross(jp), torch.from_numpy(x)),
           JL.layer_norm(jp, jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["silu_glu", "gelu_glu", "relu", "gelu"])
def test_mlp(kind):
    jp = JL.init_mlp(KEY, 32, 48, kind=kind)
    x = _rand((2, 5, 32), 4)
    _close(TL.mlp(_cross(jp), torch.from_numpy(x), kind),
           JL.mlp(jp, jnp.asarray(x), kind))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    x = _rand((2, 7, 3, 16), 5)
    pos = (np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6]])
           if per_row else np.arange(7) + 11)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         theta=1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6),
           atol=2e-5, rtol=2e-5)
    _close(TL.rope_freqs(16, theta=1e6), JL.rope_freqs(16, theta=1e6))


@pytest.mark.parametrize("scale", [False, True])
def test_embed_unembed(scale):
    jp = JL.init_embedding(KEY, 50, 16)
    tp = _cross(jp)
    tok = np.random.RandomState(6).randint(0, 50, (2, 9))
    _close(TL.embed(tp, torch.from_numpy(tok), scale_by_sqrt_dim=scale),
           JL.embed(jp, jnp.asarray(tok), scale_by_sqrt_dim=scale))
    x = _rand((2, 9, 16), 7)
    for cap in (None, 0.05):
        _close(TL.unembed(tp, torch.from_numpy(x), softcap=cap),
               JL.unembed(jp, jnp.asarray(x), softcap=cap))
    logits = _rand((3, 11), 8) * 40
    _close(TL.softcap_logits(torch.from_numpy(logits), 30.0),
           JL.softcap_logits(jnp.asarray(logits), 30.0))


def test_bridge_keeps_bf16_bits():
    a = _rand((5, 7), 9)
    jb = np.asarray(jnp.asarray(a, jnp.bfloat16))
    t = bridge.params_from_numpy({"w": jb}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), jb.astype(np.float32))
    t32 = bridge.params_from_numpy({"w": jb}, device="cpu",
                                   dtype=torch.float32)["w"]
    assert t32.dtype == torch.float32


ATTN_CFGS = [
    dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
         rope_theta=1e6),
    dict(d_model=32, n_heads=4, n_kv_heads=1, head_dim=16, window=5,
         softcap=20.0, bias=True),
]


@pytest.mark.parametrize("cfg_kw", ATTN_CFGS)
def test_attention_prefill(cfg_kw):
    """``attention`` without a cache and the single-device ``attention_sp``
    body, both through flash attention (JAX: Pallas kernel, interpret)."""
    jcfg, tcfg = JA.AttnConfig(**cfg_kw), TA.AttnConfig(**cfg_kw)
    jp = JA.init_attention(KEY, jcfg)
    tp = _cross(jp)
    x = _rand((2, 12, 32), 10)
    _close(TA.attention(tp, torch.from_numpy(x), tcfg),
           JA.attention(jp, jnp.asarray(x), jcfg, backend="pallas"))
    sharder = make_sharder(None, ParallelPlan(mode="none"))
    jo, (jk, jv) = JA.attention_sp(jp, jnp.asarray(x), jcfg, sharder=sharder,
                                   backend="pallas", return_kv=True)
    to, (tk, tv) = TA.attention_sp(tp, torch.from_numpy(x), tcfg,
                                   return_kv=True)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("cfg_kw", ATTN_CFGS)
def test_attention_decode(cfg_kw, per_slot):
    """One decode step against a cache: the write at ``pos`` and
    ``_ref_decode``'s masked attention, scalar and per-slot positions."""
    jcfg, tcfg = JA.AttnConfig(**cfg_kw), TA.AttnConfig(**cfg_kw)
    jp = JA.init_attention(KEY, jcfg)
    tp = _cross(jp)
    k0, v0 = _rand((2, cfg_kw["n_kv_heads"], 16, 16), 11), _rand(
        (2, cfg_kw["n_kv_heads"], 16, 16), 12)
    pos = np.array([6, 11]) if per_slot else np.array(9)
    x = _rand((2, 1, 32), 13)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0),
              "pos": jnp.asarray(pos, jnp.int32)}
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy()), "pos": torch.from_numpy(pos)}
    jo, jc = JA.attention(jp, jnp.asarray(x), jcfg, cache=jcache)
    to, tc = TA.attention(tp, torch.from_numpy(x), tcfg, cache=tcache)
    _close(to, jo)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
