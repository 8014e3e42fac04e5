"""A KV cache in float8_e4m3fn (mistral-large-123b's ``cache_dtype``) on
one device, against the JAX package: qwen3-14b's and mistral-large-123b's
SMOKE configs (float32) with ``cache_dtype`` replaced in both packages.

JAX's static engine keeps the prefill's K/V in the activation dtype (its
``forward_prefill`` returns them so, and the engine only widens them);
the slot pool (``init_caches``) and the block pool hold fp8, and round
the K/V they take in.  So: ``generate``, the continuous scheduler and the
paged scheduler each give JAX's engine's tokens; the prefill's K/V
rounded to fp8 (what a pool stores) are JAX's bytes; and a decode step
with a scalar position into an fp8 ``init_caches`` cache (the write that
``index_copy_`` cannot do for fp8) leaves JAX's bytes and logits.
Logits within 1e-4."""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as JL
from repro.serving import engine as JE
from repro_torch import bridge
from repro_torch.models import lm as TL
from repro_torch.serving import engine as TE
from _torch_threads import one_thread  # noqa: E402,F401

ARCHS = {"qwen3-14b": "qwen3_14b", "mistral-large-123b": "mistral_large_123b"}
BATCH, PROMPT, MAX_LEN, NEW = 2, 12, 32, 6
BUDGETS = (6, 3, 5, 6)
TOL = dict(atol=1e-4, rtol=1e-4)


def _fp8(cfg, dtype):
    return dataclasses.replace(cfg, cache_dtype=dtype)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """Both packages' fp8 SMOKE configs, JAX's init on both sides, the
    prompts, and both engines on one device."""
    mod = ARCHS[request.param]
    jcfg = _fp8(importlib.import_module(f"repro.configs.{mod}").SMOKE,
                jnp.float8_e4m3fn)
    tcfg = _fp8(importlib.import_module(f"repro_torch.configs.{mod}").SMOKE,
                torch.float8_e4m3fn)
    jp = JL.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    prompts = np.random.RandomState(3).randint(0, tcfg.vocab,
                                               (BATCH, PROMPT + 4))
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": jp, "tp": tp,
            "prompts": prompts,
            "jeng": JE.ServingEngine(jp, jcfg, max_len=MAX_LEN),
            "teng": TE.ServingEngine(tp, tcfg, max_len=MAX_LEN,
                                     device="cpu")}


def test_static_generate_matches_jax(arch):
    want = np.asarray(arch["jeng"].generate(
        jnp.asarray(arch["prompts"][:, :PROMPT]), NEW))
    got = arch["teng"].generate(
        torch.from_numpy(arch["prompts"][:, :PROMPT]), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def _requests(prompts, cls, conv):
    return [cls(prompt=conv(prompts[i % BATCH, :PROMPT]), max_new_tokens=m,
                request_id=i) for i, m in enumerate(BUDGETS)]


@pytest.mark.parametrize("kind", ["continuous", "paged"])
def test_pools_match_jax(arch, kind):
    """The slot pool (2 fp8 slots) and the block pool (fp8 blocks of 4,
    4-token prefill chunks) give JAX's engine's tokens."""
    kw = (dict(continuous=True) if kind == "continuous"
          else dict(paged=True, block_size=4, prefill_chunk=4))
    jr = _requests(arch["prompts"], JE.Request, jnp.asarray)
    arch["jeng"].serve(jr, max_batch=2, **kw)
    tr = _requests(arch["prompts"], TE.Request, torch.from_numpy)
    arch["teng"].serve(tr, max_batch=2, **kw)
    assert [r.generated for r in tr] == [list(r.generated) for r in jr]


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def test_prefill_cache_matches_jax(arch):
    """The prefill's logits and K/V (activation dtype) within 1e-4, and
    the K/V rounded to fp8, as a pool stores them, JAX's bytes."""
    tok = arch["prompts"][:, :PROMPT]
    jl, jc = JL.forward_prefill(arch["jp"], jnp.asarray(tok), arch["jcfg"],
                                backend="ref")
    tl, tc = TL.forward_prefill(arch["tp"], torch.from_numpy(tok),
                                arch["tcfg"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for j in jc["periods"]:
        for kv in ("k", "v"):
            want = jc["periods"][j]["kv"][kv]
            got = tc["periods"][j]["kv"][kv]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_array_equal(
                _bytes(got.to(torch.float8_e4m3fn)),
                _bytes(want.astype(jnp.float8_e4m3fn)))


def test_scalar_pos_decode_writes_fp8(arch):
    """4 decode steps with a scalar position into an fp8 cache from
    ``init_caches`` holding the prompt's fp8 K/V: the logits within 1e-4
    and the cache JAX's bytes after every step."""
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    tok = arch["prompts"][:, :PROMPT]
    _, jpre = JL.forward_prefill(arch["jp"], jnp.asarray(tok), jcfg,
                                 backend="ref")
    jc = JL.init_caches(jcfg, BATCH, MAX_LEN)
    tc = TL.init_caches(tcfg, BATCH, MAX_LEN, device="cpu")
    for j, layer in jpre["periods"].items():
        for kv in ("k", "v"):
            fp8 = layer["kv"][kv].astype(jnp.float8_e4m3fn)
            jc["periods"][j]["kv"][kv] = jc["periods"][j]["kv"][kv].at[
                :, :, :, :PROMPT].set(fp8)
            tc["periods"][j]["kv"][kv][:, :, :, :PROMPT].view(
                torch.uint8).copy_(torch.from_numpy(_bytes(fp8).copy()))
    jc["pos"] = jnp.asarray(PROMPT, jnp.int32)
    tc["pos"] = torch.tensor(PROMPT)
    assert tc["periods"]["0"]["kv"]["k"].dtype == torch.float8_e4m3fn
    step = arch["prompts"][:, PROMPT:PROMPT + 1]
    for i in range(4):
        jl, jc = JL.forward_decode(arch["jp"], jnp.asarray(step), jc, jcfg)
        tl, tc = TL.forward_decode(arch["tp"], torch.from_numpy(step), tc,
                                   tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for j in jc["periods"]:
            for kv in ("k", "v"):
                np.testing.assert_array_equal(
                    _bytes(tc["periods"][j]["kv"][kv]),
                    _bytes(jc["periods"][j]["kv"][kv]))
        step = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
