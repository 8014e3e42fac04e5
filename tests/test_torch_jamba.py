"""jamba-1.5-large-398b in the port (``configs/jamba_1_5_large_398b.py``)
against the JAX package on one device, on the CPU.

The config and ``param_counts`` (published and SMOKE) field for field;
then at SMOKE width (8 layers in two periods of attention at 1, SSD
elsewhere, MoE on the odd layers with 4 experts top-2; float32), and at
SMOKE with SSD heads of P = 128 (d_inner 256: the head dim of the
published config, two heads), from JAX's init (seed 0) and the same
seeded numpy tokens: ``forward``, ``lm_loss`` with every grad,
``forward_prefill`` and 3 decode steps into a ``float8_e4m3fn`` KV cache
(the published ``cache_dtype``) beside the SSM states, against JAX's
(the forward, prefill and decode through JAX's Pallas kernels in
interpret mode; the loss's grads through JAX's custom VJP, which
recomputes through its references).  Then both CLIs at SMOKE size.

Bars: outputs and logits within 1e-5 of the largest |value|, the loss
within 1e-5 relative, every grad leaf within 1e-4 of its max, the fp8
cache JAX's bytes after every step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_1_5_large_398b as JJ
from repro.models import lm as JL
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.configs import get
from repro_torch.configs import jamba_1_5_large_398b as TJ
from repro_torch.models import lm as TL
from repro_torch.models import ssm as TS
from repro_torch.parallel.partition import ParallelPlan

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

BATCH, PROMPT, MAX_LEN, STEPS = 2, 24, 32, 3


def _p128(cfg, ssm_mod):
    """``cfg`` with SSD heads of P = 128 (d_inner 256, two heads)."""
    return dataclasses.replace(cfg, ssm_cfg=ssm_mod.SSMConfig(
        d_model=cfg.d_model, d_inner=256, head_dim=128,
        d_state=cfg.ssm_cfg.d_state, n_groups=cfg.ssm_cfg.n_groups,
        chunk=cfg.ssm_cfg.chunk))


def _fp8(cfg, dtype):
    return dataclasses.replace(cfg, cache_dtype=dtype)


CASES = {"smoke": (JJ.SMOKE, TJ.SMOKE),
         "smoke_p128": (_p128(JJ.SMOKE, JS), _p128(TJ.SMOKE, TS))}


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_and_param_counts_match_jax(which):
    """Every field of the config equals JAX's (the SSM geometry field for
    field, the dtypes by name), so do ``param_counts`` (~398B for the
    published config), and the spec carries JAX's plan, ``dsp`` + ``ep``
    + ZeRO-3, and source."""
    t, j = getattr(TJ, which), getattr(JJ, which)
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("dtype", "cache_dtype"):
            assert (a is None) == (b is None), f.name
            if a is not None:
                assert str(a).split(".")[-1] == jnp.dtype(b).name, f.name
        elif f.name == "ssm_cfg":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert TL.param_counts(t) == JL.param_counts(j)
    if which == "CONFIG":
        assert t.ssm_cfg.n_heads == 128 and t.ssm_cfg.head_dim == 128
        assert abs(TL.param_counts(t)["total"] / 1e9 - 398) < 0.05 * 398
        assert [(s.mixer, s.ffn) for s in t.period_specs()] == [
            (("attn" if i == 3 else "ssm"), ("moe" if i % 2 else "mlp"))
            for i in range(8)]
    spec = get("jamba-1.5-large-398b")
    assert spec.plan == ParallelPlan(mode="dsp", ep=True, zero=True)
    assert (spec.family, spec.source) == (JJ.SPEC.family, JJ.SPEC.source)


# ---------------------------------------------------------------------------
# One device, at SMOKE and at SMOKE with P = 128
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both packages' configs (fp8 KV cache), JAX's init on both sides,
    the tokens, and JAX's forward, loss, grads, prefill and decode
    steps."""
    jcfg, tcfg = CASES[request.param]
    jcfg = _fp8(jcfg, jnp.float8_e4m3fn)
    tcfg = _fp8(tcfg, torch.float8_e4m3fn)
    jp = JL.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    rng = np.random.RandomState(7)
    toks = rng.randint(0, tcfg.vocab, (BATCH, PROMPT + STEPS))
    labels = rng.randint(0, tcfg.vocab, (BATCH, PROMPT))
    jt = jnp.asarray(toks[:, :PROMPT])
    x, _ = JL.forward(jp, jt, jcfg, backend="pallas", remat=False)
    jb = {"tokens": jt, "labels": jnp.asarray(labels)}
    loss, grads = jax.value_and_grad(lambda p: JL.lm_loss(
        p, jb, jcfg, backend="pallas")[0])(jp)
    logits, pre = JL.forward_prefill(jp, jt, jcfg, backend="pallas")
    caches = _decode_cache(jcfg, pre)
    steps = []
    for t in range(STEPS):
        lg, caches = JL.forward_decode(
            jp, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]), caches,
            jcfg, backend="pallas")
        steps.append((np.asarray(lg), jax.tree_util.tree_map(np.asarray,
                                                             caches)))
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg, "jp": jp,
            "tp": tp, "tokens": toks, "labels": labels,
            "out": np.asarray(x), "loss": float(loss),
            "grads": flatten(jax.tree_util.tree_map(np.asarray, grads)),
            "logits": np.asarray(logits),
            "prefill": flatten(jax.tree_util.tree_map(np.asarray, pre)),
            "steps": steps}


def _decode_cache(jcfg, pre):
    """JAX's ``init_caches`` (the KV leaves in fp8) holding the prefill's
    K/V rounded to fp8 and its SSM conv and state, at position PROMPT."""
    c = JL.init_caches(jcfg, BATCH, MAX_LEN)
    for j, layer in pre["periods"].items():
        if "kv" in layer:
            for kv in ("k", "v"):
                c["periods"][j]["kv"][kv] = c["periods"][j]["kv"][kv].at[
                    :, :, :, :PROMPT].set(
                        layer["kv"][kv].astype(jnp.float8_e4m3fn))
        else:
            c["periods"][j]["ssm"] = dict(layer["ssm"])
    c["pos"] = jnp.asarray(PROMPT, jnp.int32)
    return c


def _port_decode_cache(tcfg, pre):
    """``_decode_cache`` on the port's side, from the port's prefill."""
    c = TL.init_caches(tcfg, BATCH, MAX_LEN, device="cpu")
    for j, layer in pre["periods"].items():
        if "kv" in layer:
            for kv in ("k", "v"):
                c["periods"][j]["kv"][kv][:, :, :, :PROMPT] = \
                    layer["kv"][kv].to(torch.float8_e4m3fn)
        else:
            for k in ("conv", "state"):
                c["periods"][j]["ssm"][k].copy_(layer["ssm"][k])
    c["pos"] = torch.tensor(PROMPT)
    return c


def test_forward_matches_jax(case):
    """``forward`` within 1e-5 of the largest |value| of JAX's."""
    with torch.no_grad():
        x, _ = TL.forward(case["tp"], torch.from_numpy(
            case["tokens"][:, :PROMPT]), case["tcfg"], remat=False)
    assert _rel(x, case["out"]) <= 1e-5


def test_loss_and_grads_match_jax(case):
    """``lm_loss`` (with MoE's aux) within 1e-5 relative of JAX's and
    every grad leaf (SSD, attention, experts, router) within 1e-4 of its
    max."""
    leaves = TL.tree_map(lambda a: a.detach().requires_grad_(True),
                         case["tp"])
    batch = {"tokens": torch.from_numpy(case["tokens"][:, :PROMPT]),
             "labels": torch.from_numpy(case["labels"])}
    loss, _ = TL.lm_loss(leaves, batch, case["tcfg"])
    grads = iter(torch.autograd.grad(loss, TL.tree_leaves(leaves)))
    assert abs(float(loss.detach()) - case["loss"]) <= \
        1e-5 * abs(case["loss"])
    got = flatten(TL.tree_map(lambda _: next(grads), leaves))
    assert set(got) == set(case["grads"])
    assert any("ssm" in k for k in got) and any("moe" in k for k in got)
    for k, want in case["grads"].items():
        assert _rel(got[k], want) <= 1e-4, k


def test_prefill_and_fp8_decode_match_jax(case):
    """``forward_prefill``'s logits and caches (the K/V in the activation
    dtype, the SSM conv and state) within 1e-5 of JAX's; then 3 decode
    steps into an ``init_caches`` cache whose KV leaves are fp8: the
    logits within 1e-5, the fp8 K/V JAX's bytes and the SSM state within
    1e-5 after every step."""
    tcfg = case["tcfg"]
    toks = torch.from_numpy(case["tokens"])
    with torch.no_grad():
        logits, pre = TL.forward_prefill(case["tp"], toks[:, :PROMPT], tcfg)
    assert _rel(logits, case["logits"]) <= 1e-5
    got = flatten(pre)
    for k, want in case["prefill"].items():
        if k == "pos":
            assert int(got[k]) == int(want) == PROMPT
        else:
            assert _rel(got[k], want) <= 1e-5, k
    caches = _port_decode_cache(tcfg, pre)
    kv = next(v["kv"]["k"] for v in caches["periods"].values() if "kv" in v)
    assert kv.dtype == torch.float8_e4m3fn
    for t, (want_logits, want_caches) in enumerate(case["steps"]):
        with torch.no_grad():
            lg, caches = TL.forward_decode(
                case["tp"], toks[:, PROMPT + t:PROMPT + t + 1], caches, tcfg)
        assert _rel(lg, want_logits) <= 1e-5, t
        got, want = flatten(caches), flatten(want_caches)
        assert set(got) == set(want)
        for k, w in want.items():
            if k.endswith("/k") or k.endswith("/v"):
                np.testing.assert_array_equal(_bytes(got[k]), _bytes(w))
            elif k != "pos":
                assert _rel(got[k], w) <= 1e-5, (t, k)
        assert int(caches["pos"]) == PROMPT + t + 1


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def test_clis_take_jamba():
    """``launch.serve`` (static and continuous) and ``launch.train`` take
    ``--arch jamba-1.5-large-398b`` at SMOKE size on the CPU, as JAX's
    CLIs do: every request finishes, the loss is finite."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    out = serve_main(["--arch", "jamba-1.5-large-398b", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16",
                      "--new-tokens", "4"])
    assert tuple(out.shape) == (2, 4)
    reqs = serve_main(["--arch", "jamba-1.5-large-398b", "--device", "cpu",
                       "--continuous", "--batch", "2", "--prompt-len", "16",
                       "--new-tokens", "4"])
    assert all(len(r.generated) == 4 for r in reqs)
    out = train_main(["--arch", "jamba-1.5-large-398b", "--device", "cpu",
                      "--steps", "2", "--seq", "32", "--batch", "2"])
    assert all(np.isfinite(l) for _, l in out["history"])
