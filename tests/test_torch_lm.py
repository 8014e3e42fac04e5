"""The port's LM serving path against the JAX package at the SMOKE sizes
of qwen3-14b, starcoder2-7b (layer norm, biases, GELU MLP), gemma2-2b
(local/global windows of 16, attention and final softcaps, post-norms,
scaled embeddings), qwen2-moe-a2.7b (MoE) (float32, d_model 64) and
mistral-large-123b (d_model 96, untied):
``forward_prefill`` logits and caches (JAX through the Pallas kernel,
interpret mode) over a 24-token prompt, past gemma2's window,
``forward_decode`` logits over 4 steps with scalar and per-slot
positions, and ``lm_loss`` with every gradient.  JAX weights cross over
through ``bridge.params_from_numpy``.  Tolerance 1e-4: sums over the
layers in another order."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro_torch import bridge
from repro_torch.models import lm as TLM
from _torch_threads import one_thread  # noqa: E402,F401

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = {"qwen3-14b": "qwen3_14b", "starcoder2-7b": "starcoder2_7b",
         "gemma2-2b": "gemma2_2b", "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
         "mistral-large-123b": "mistral_large_123b"}


def _confs(arch):
    mod = ARCHS[arch]
    return (importlib.import_module(f"repro.configs.{mod}"),
            importlib.import_module(f"repro_torch.configs.{mod}"))


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """(JAX SMOKE config, port SMOKE config, JAX params, port params)."""
    jconf, tconf = _confs(request.param)
    jp = JLM.init_lm(jax.random.PRNGKey(0), jconf.SMOKE)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jconf.SMOKE, tconf.SMOKE, jp, tp


def _tokens(shape, seed, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape)


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


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configs_match_jax(name):
    jconf, tconf = _confs(name)
    for cname in ("CONFIG", "SMOKE"):
        j, t = getattr(jconf, cname), getattr(tconf, cname)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "mlp_kind", "qk_norm", "rope_theta",
                  "attn_softcap", "final_softcap", "attn_bias",
                  "embed_scale", "norm_kind", "post_norm", "tie_embeddings",
                  "window", "window_pattern", "n_experts", "top_k",
                  "moe_every", "moe_offset", "n_shared", "shared_ff",
                  "dense_ff", "norm_topk", "ep_pad"):
            assert getattr(j, f) == getattr(t, f), (cname, f)
        assert jnp.dtype(j.dtype).name == str(t.dtype).split(".")[-1]
        assert TLM.param_counts(t) == JLM.param_counts(j)
    assert tconf.SPEC.plan == type(tconf.SPEC.plan)(
        **{f: getattr(jconf.SPEC.plan, f) for f in ("mode", "ep", "zero",
                                                   "shard_vocab")})
    assert tconf.SPEC.source == jconf.SPEC.source


def test_init_tree_matches_jax(arch):
    """Same keys and shapes, so weights cross over with no transpose."""
    jcfg, tcfg, jp, _ = arch
    tp = TLM.init_lm(0, tcfg, device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = TLM.tree_map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    w = tp["periods"]["0"]["attn"]["wq"]["w"]
    assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05


def test_prefill_matches_jax(arch):
    """A 24-token prompt: past gemma2's window of 16, so its local layers
    mask keys."""
    jcfg, tcfg, jp, tp = arch
    tok = _tokens((2, 24), 1)
    jl, jc = JLM.forward_prefill(jp, jnp.asarray(tok), jcfg, backend="pallas")
    tl, tc = TLM.forward_prefill(tp, torch.from_numpy(tok), tcfg)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 24
    _close_tree(tc["periods"], jc["periods"])


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_matches_jax(arch, per_slot):
    """4 decode steps from positions up to 19, past gemma2's window."""
    jcfg, tcfg, jp, tp = arch
    b, max_len = 2, 28
    rng = np.random.RandomState(2)
    shape = (jcfg.n_periods, b, jcfg.n_kv_heads, max_len, jcfg.head_dim)
    kv = {str(i): {"kv": {"k": rng.standard_normal(shape).astype(np.float32),
                          "v": rng.standard_normal(shape).astype(np.float32)}}
          for i in range(len(jcfg.period_specs()))}
    pos = np.array([5, 19]) if per_slot else np.array(19)
    jc = {"pos": jnp.asarray(pos, jnp.int32),
          "periods": jax.tree_util.tree_map(jnp.asarray, kv)}
    tc = {"pos": torch.from_numpy(pos),
          "periods": bridge.params_from_numpy(kv, device="cpu")}
    tok = _tokens((b, 1), 3)
    for _ in range(4):
        jl, jc = JLM.forward_decode(jp, jnp.asarray(tok), jc, jcfg)
        tl, tc = TLM.forward_decode(tp, torch.from_numpy(tok), tc, tcfg)
        _close(tl, jl)
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close_tree(tc["periods"], jc["periods"])


def test_lm_loss_and_grads_match_jax(arch):
    """``lm_loss`` (with MoE's aux where the config has MoE layers) and
    every gradient against JAX's (``backend="ref"``), over 24 tokens."""
    jcfg, tcfg, jp, tp = arch
    rng = np.random.RandomState(4)
    b = {k: rng.randint(0, jcfg.vocab, (2, 24)) for k in ("tokens",
                                                          "labels")}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: JLM.lm_loss(p, jb, jcfg, backend="ref"), has_aux=True)(jp)
    leaves = TLM.tree_map(lambda a: a.detach().requires_grad_(True), tp)
    tl, _ = TLM.lm_loss(leaves, {k: torch.from_numpy(v)
                                 for k, v in b.items()}, tcfg)
    grads = iter(torch.autograd.grad(tl, TLM.tree_leaves(leaves)))
    _close(tl.detach(), jl)
    got = TLM.tree_map(lambda _: next(grads), leaves)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        g = got
        for k in path:
            g = g[k.key]
        want = np.asarray(want, np.float32)
        gap = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert gap < 1e-4, (path, gap)
