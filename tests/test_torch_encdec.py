"""The port's enc-dec model (``repro_torch.models.encdec``, seamless-m4t-
large-v2) against the JAX package's ``repro.models.encdec`` on the CPU.

Both packages run the same numpy inputs with JAX's init carried over by
``bridge.params_from_numpy``, in float32; JAX with ``backend="ref"``, the
port with K1's plain version (its CPU path).  Bars: encode, decode and
the loss within 1e-5 of the largest |value| (relative for the loss),
every gradient leaf within 1e-4 of its leaf's max; logits within 1e-5 of
the largest.

Serving: JAX's ``prefill`` returns caches of exactly the prompt's length,
and its first ``decode_step`` writes at ``pos`` = S_dec through a
``dynamic_update_slice`` whose start clamps, overwriting the prompt's
last K/V row.  The port's prefill leaves room for the decode, so its
steps are held against JAX's full decoder forward and against JAX's
``decode_step`` on caches this test pads to ``max_len``; one case records
JAX's unpadded step departing from the full forward."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import seamless_m4t_large_v2 as JSC
from repro.data import pipeline as JP
from repro.models import encdec as JE
from repro_torch import bridge
from repro_torch import configs as TCONF
from repro_torch.configs import seamless_m4t_large_v2 as TSC
from repro_torch.data.pipeline import DataConfig, batch_for_arch, make_batch
from repro_torch.models import encdec as ED
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.parallel.partition import ParallelPlan, make_sharder

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_encdec_jax import CONFIG_KW, config, inputs, params_np  # noqa
from _torch_threads import one_thread  # noqa: E402,F401

NAMES = ("smoke", "narrow")
S_ENC, S_DEC = 24, 12


def _cfgs(name):
    return config(ED, name, torch.float32), config(JE, name, jnp.float32)


def _batch(name, s_enc=S_ENC, s_dec=S_DEC):
    return inputs(CONFIG_KW[name], batch=2, s_enc=s_enc, s_dec=s_dec, seed=3)


def _port_batch(raw):
    return {"feats": torch.from_numpy(raw["feats"]),
            "tokens": torch.from_numpy(raw["tokens"]).long(),
            "labels": torch.from_numpy(raw["labels"]).long()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def trees():
    return {name: params_np(name, seed=1) for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_encode_and_decode_match_jax(trees, name):
    """``encode`` (the frontend, bidirectional self-attention through K1's
    plain version) and ``decode`` (causal self-attention, cross-attention
    at S_dec queries against S_enc keys) within 1e-5 of JAX's."""
    tcfg, jcfg = _cfgs(name)
    raw = _batch(name)
    params = bridge.params_from_numpy(trees[name], device="cpu")
    jp = _jax(trees[name])
    enc = ED.encode(params, torch.from_numpy(raw["feats"]), tcfg,
                    remat=False)
    jenc = JE.encode(jp, jnp.asarray(raw["feats"]), jcfg, backend="ref",
                     remat=False)
    assert _gap(enc, jenc) < 1e-5
    x = ED.decode(params, torch.from_numpy(raw["tokens"]).long(), enc, tcfg,
                  remat=False)
    jx = JE.decode(jp, jnp.asarray(raw["tokens"]), jenc, jcfg,
                   backend="ref", remat=False)
    assert _gap(x, jx) < 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_jax(trees, name):
    """``encdec_loss`` with remat (each layer checkpointed) within 1e-5
    relative of JAX's, and every gradient leaf within 1e-4 of its leaf's
    max (the cross-attention's K bias, whose gradient is zero in exact
    arithmetic, against the whole gradient's max)."""
    tcfg, jcfg = _cfgs(name)
    raw = _batch(name)
    params = bridge.params_from_numpy(trees[name], device="cpu")
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss, metrics = ED.encdec_loss(leaves, _port_batch(raw), tcfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))

    def jloss(p):
        return JE.encdec_loss(p, {k: jnp.asarray(v) for k, v in raw.items()},
                              jcfg, backend="ref")[0]
    jl, jg = jax.value_and_grad(jloss)(_jax(trees[name]))
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(metrics["xent"].detach()) == loss
    want = flatten(jax.tree_util.tree_map(np.asarray, jg))
    top = max(np.abs(w).max() for w in want.values())
    assert list(want) == list(flatten(params))
    for (path, w), g in zip(want.items(), grads):
        scale = (top if path.endswith("cross_attn/wk/b")
                 else max(np.abs(w).max(), 1e-30))
        assert np.abs(g.numpy() - w).max() / scale < 1e-4, path


def _jax_prefill(jp, raw, jcfg, s_prompt, max_len=None):
    """JAX's prefill of the first ``s_prompt`` tokens; with ``max_len`` its
    self-attention caches zero-padded to that many positions."""
    logits, caches = JE.prefill(jp, {"feats": jnp.asarray(raw["feats"]),
                                     "tokens": jnp.asarray(
                                         raw["tokens"][:, :s_prompt])},
                                jcfg, backend="ref", remat=False)
    if max_len is not None:
        pad = ((0, 0), (0, 0), (0, 0), (0, max_len - s_prompt), (0, 0))
        kv = caches["periods"]["kv"]
        caches["periods"]["kv"] = {k: jnp.pad(v, pad) for k, v in kv.items()}
    return logits, caches


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_steps_match_jax(trees, name):
    """The port's ``prefill`` of the first 8 tokens (caches of 12
    positions) and ``decode_step``s on the next 4: each step's logits
    within 1e-5 of JAX's full decoder forward at that position and of
    JAX's ``decode_step`` on padded caches; the prefill's logits and the
    cross caches within 1e-5 of JAX's; the first step equal to the full
    forward (the write lands past the prompt, not on it)."""
    tcfg, jcfg = _cfgs(name)
    raw = _batch(name)
    jp = _jax(trees[name])
    params = bridge.params_from_numpy(trees[name], device="cpu")
    prompt, max_len = 8, S_DEC
    jenc = JE.encode(jp, jnp.asarray(raw["feats"]), jcfg, backend="ref",
                     remat=False)
    jx = JE.decode(jp, jnp.asarray(raw["tokens"]), jenc, jcfg,
                   backend="ref", remat=False)
    full = np.asarray(jnp.einsum("bsd,vd->bsv", jx,
                                 jp["embed"]["table"]))
    tokens = torch.from_numpy(raw["tokens"]).long()
    logits, caches = ED.prefill(
        params, {"feats": torch.from_numpy(raw["feats"]),
                 "tokens": tokens[:, :prompt]}, tcfg, max_len=max_len)
    jlog, jc = _jax_prefill(jp, raw, jcfg, prompt, max_len)
    assert _gap(logits, jlog) < 1e-5
    assert _gap(logits[:, 0], full[:, prompt - 1]) < 1e-5
    for k in ("k", "v"):
        assert _gap(caches["periods"]["cross"][k],
                    jc["periods"]["cross"][k]) < 1e-5
    assert caches["periods"]["kv"]["k"].shape[3] == max_len
    for i in range(prompt, max_len):
        logits, caches = ED.decode_step(params, tokens[:, i:i + 1], caches,
                                        tcfg)
        jlog, jc = JE.decode_step(jp, jnp.asarray(raw["tokens"][:, i:i + 1]),
                                  jc, jcfg)
        assert int(caches["pos"]) == i + 1
        assert _gap(logits[:, 0], full[:, i]) < 1e-5, i
        assert _gap(logits, jlog) < 1e-5, i


def test_jax_unpadded_decode_step_departs(trees):
    """JAX's own prefill -> decode_step, on caches of exactly the prompt's
    length: the step's write clamps onto the prompt's last row, and its
    logits leave the full forward's by far more than the bar (recorded:
    the reference's fault, not copied), while the port's match."""
    tcfg, jcfg = _cfgs("smoke")
    raw = _batch("smoke")
    jp = _jax(trees["smoke"])
    prompt = 8
    jenc = JE.encode(jp, jnp.asarray(raw["feats"]), jcfg, backend="ref",
                     remat=False)
    jx = JE.decode(jp, jnp.asarray(raw["tokens"]), jenc, jcfg,
                   backend="ref", remat=False)
    full = np.asarray(jnp.einsum("bsd,vd->bsv", jx, jp["embed"]["table"]))
    _, jc = _jax_prefill(jp, raw, jcfg, prompt)
    assert jc["periods"]["kv"]["k"].shape[3] == prompt
    jlog, _ = JE.decode_step(jp, jnp.asarray(raw["tokens"][:, prompt:
                                                           prompt + 1]),
                             jc, jcfg)
    assert _gap(jlog[:, 0], full[:, prompt]) > 1e-3
    params = bridge.params_from_numpy(trees["smoke"], device="cpu")
    tokens = torch.from_numpy(raw["tokens"]).long()
    _, caches = ED.prefill(params, {"feats": torch.from_numpy(raw["feats"]),
                                    "tokens": tokens[:, :prompt]}, tcfg,
                           max_len=prompt + 1)
    logits, _ = ED.decode_step(params, tokens[:, prompt:prompt + 1], caches,
                               tcfg)
    assert _gap(logits[:, 0], full[:, prompt]) < 1e-5


def test_prefill_into_given_caches():
    """``prefill`` writes into ``init_dec_caches``' buffers in place (the
    same tensors come back), zeros past the prompt, and refuses caches
    that cannot hold the prompt or that lack ``max_len``; each greedy
    ``decode_step`` then writes its position."""
    cfg = TSC.SMOKE
    params = ED.init_encdec(0, cfg, device="cpu")
    raw = _port_batch(inputs(CONFIG_KW["smoke"], batch=2, s_enc=16,
                             s_dec=6))
    batch = {"feats": raw["feats"], "tokens": raw["tokens"]}
    caches = ED.init_dec_caches(cfg, 2, 10, 16, device="cpu")
    k = caches["periods"]["kv"]["k"]
    logits, out = ED.prefill(params, batch, cfg, caches=caches)
    assert out["periods"]["kv"]["k"] is k and int(out["pos"]) == 6
    assert bool(k[:, :, :, :6].abs().sum() > 0)
    assert bool((k[:, :, :, 6:] == 0).all())
    again, _ = ED.prefill(params, batch, cfg, max_len=10)
    assert torch.equal(logits, again)
    with pytest.raises(ValueError, match="max_len"):
        ED.prefill(params, batch, cfg)
    with pytest.raises(ValueError, match="cannot take"):
        ED.prefill(params, batch, cfg,
                   caches=ED.init_dec_caches(cfg, 2, 4, 16, device="cpu"))
    tok = logits.argmax(-1)
    for step in range(6, 10):
        logits, out = ED.decode_step(params, tok, out, cfg)
        tok = logits.argmax(-1)
        assert int(out["pos"]) == step + 1
        assert bool(k[:, :, :, step].abs().sum() > 0)


def test_prefill_keeps_the_cross_kv_its_prompt_projects():
    """The cross caches ``prefill`` returns are the K/V its prompt's
    cross-attention projected, equal to ``build_cross_caches`` of the
    encoder output (each projected once a request)."""
    cfg = TSC.SMOKE
    params = ED.init_encdec(0, cfg, device="cpu")
    raw = _port_batch(inputs(CONFIG_KW["smoke"], batch=2, s_enc=16,
                             s_dec=6))
    _, caches = ED.prefill(params, {"feats": raw["feats"],
                                    "tokens": raw["tokens"]}, cfg, max_len=8)
    enc = ED.encode(params, raw["feats"], cfg, remat=False)
    want = ED.build_cross_caches(params, enc, cfg)
    for k in ("k", "v"):
        assert torch.equal(caches["periods"]["cross"][k], want[k])


def test_chip_smoke_relu_held_keeps_the_function():
    """``chip_smoke.relu_held`` (phase 26 (e)'s ReLU MLP): with nothing
    held the loss and every grad equal ``encdec_loss``'s, through the
    checkpoints' recompute, and each length's forward pre-activations are
    recorded; with a layer's every entry held its ``wi`` gets no
    gradient while the loss is unchanged."""
    import chip_smoke
    cfg = dataclasses.replace(TSC.SMOKE, n_enc_layers=1, n_dec_layers=1)
    params = ED.init_encdec(0, cfg, device="cpu")
    raw = _port_batch(inputs(CONFIG_KW["smoke"], batch=2, s_enc=16,
                             s_dec=6))

    def run(held, seen):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with chip_smoke.relu_held(held, seen):
            loss, _ = ED.encdec_loss(leaves, raw, cfg, backend="ref")
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
        return loss, grads, leaves

    want = run({}, {})
    seen = {}
    loss, grads, _ = run({}, seen)
    assert torch.equal(loss, want[0])
    assert all(torch.equal(a, b) for a, b in zip(grads, want[1]))
    assert {k: tuple(v.shape) for k, v in seen.items()} == {
        16: (2, 16, cfg.d_ff), 6: (2, 6, cfg.d_ff)}
    loss, grads, leaves = run({6: torch.ones(2, 6, cfg.d_ff, dtype=bool)},
                              {})
    assert torch.equal(loss, want[0])
    of = {id(p): g for g, p in zip(grads, tree_leaves(leaves))}
    wi = leaves["dec_periods"]["mlp"]["wi"]
    assert not of[id(wi["w"])].any() and not of[id(wi["b"])].any()
    assert of[id(leaves["enc_periods"]["mlp"]["wi"]["w"])].any()


def test_param_count_and_tree_match_jax():
    """``encdec_param_count`` equals JAX's (1.37 B at seamless's shapes),
    and ``init_encdec``'s tree has JAX's keys, shapes and dtypes (bf16 at
    full width), drawn on the device asked for."""
    for tc, jc in ((TSC.CONFIG, JSC.CONFIG), (TSC.SMOKE, JSC.SMOKE)):
        assert ED.encdec_param_count(tc) == JE.encdec_param_count(jc)
    assert round(ED.encdec_param_count(TSC.CONFIG) / 1e9, 2) == 1.37
    want = flatten(jax.eval_shape(lambda: JE.init_encdec(
        jax.random.PRNGKey(0), JSC.SMOKE)))
    got = flatten(ED.init_encdec(0, TSC.SMOKE, device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    full = flatten(jax.eval_shape(lambda: JE.init_encdec(
        jax.random.PRNGKey(0), JSC.CONFIG)))
    assert full["embed/table"].shape == (256206, 1024)
    assert full["enc_periods/mlp/wi/w"].dtype == jnp.bfloat16
    assert TSC.CONFIG.dtype == torch.bfloat16
    assert {f.name: getattr(TSC.CONFIG, f.name)
            for f in dataclasses.fields(TSC.CONFIG) if f.name != "dtype"} == {
        f.name: getattr(JSC.CONFIG, f.name)
        for f in dataclasses.fields(JSC.CONFIG) if f.name != "dtype"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ED.init_encdec(0, TSC.SMOKE)


def test_spec_and_stages():
    """The registry holds seamless with family ``encdec`` and JAX's plan;
    the stage graph and the plans equal JAX's."""
    spec = TCONF.get("seamless-m4t-large-v2")
    assert spec.family == "encdec" and spec.plan == ParallelPlan(
        mode="dsp", zero=True)
    assert "long_500k" not in spec.shapes()
    tc, jc = TSC.CONFIG, JSC.CONFIG
    t = ED.stages(tc, s_enc=4096, s_dec=1024, batch=2)
    j = JE.stages(jc, s_enc=4096, s_dec=1024, batch=2)
    assert [(s.name, s.compute_dims, s.shape) for s in t] == [
        (s.name, s.compute_dims, s.shape) for s in j]
    for joint in (False, True):
        for n in (2, 4):
            ts = ED.dsp_schedule(tc, n, s_enc=4096, s_dec=1024, batch=2,
                                 joint=joint)
            js = JE.dsp_schedule(jc, n, s_enc=4096, s_dec=1024, batch=2,
                                 joint=joint)
            assert tuple(ts.dims) == tuple(js.dims)
            assert ts.mirrored


def test_encdec_batches():
    """The ``encdec`` task: feats (B, S_enc, F) float32 from normals,
    tokens (B, S_dec) int64 and labels = (tokens + 1) mod V, as JAX's
    task draws them (the bits differ: each package its own generator);
    ``batch_for_arch`` gives seamless S_enc = seq and S_dec = seq // 4,
    as JAX's does."""
    cfg = DataConfig(task="encdec", vocab=97, seq=16, enc_seq=64, batch=3,
                     frontend_dim=40)
    b0, again = (make_batch(cfg, 0, device="cpu") for _ in range(2))
    jb = JP.make_batch(JP.DataConfig(task="encdec", vocab=97, seq=16,
                                     enc_seq=64, batch=3, frontend_dim=40), 0)
    assert set(b0) == set(jb) == {"feats", "tokens", "labels"}
    for k in b0:
        assert tuple(b0[k].shape) == tuple(jb[k].shape)
        assert torch.equal(b0[k], again[k])
    assert b0["feats"].dtype == torch.float32
    assert b0["tokens"].dtype == torch.int64
    assert torch.equal(b0["labels"], (b0["tokens"] + 1) % 97)
    assert not torch.equal(b0["feats"], make_batch(cfg, 1,
                                                   device="cpu")["feats"])
    spec = TCONF.get("seamless-m4t-large-v2")
    b = batch_for_arch(spec, "train_4k", batch_override=2,
                       seq_override=256, device="cpu")
    jspec = JSC.SPEC
    jb = JP.batch_for_arch(jspec, "train_4k", batch_override=2,
                           seq_override=256)
    for k in b:
        assert tuple(b[k].shape) == tuple(jb[k].shape), k
    assert tuple(b["feats"].shape) == (2, 256, 1024)
    assert tuple(b["tokens"].shape) == (2, 64)


def test_train_cli_on_the_cpu():
    """The train CLI trains seamless's SMOKE config on ``encdec`` batches
    of ``--seq`` frames and ``--seq // 2`` tokens (the JAX CLI's), with a
    finite loss each step, and refuses ``--replan``, as JAX's CLI has no
    elastic resize for the enc-dec family."""
    from repro_torch.launch.train import main as train_main
    out = train_main(["--arch", "seamless-m4t-large-v2", "--device", "cpu",
                      "--steps", "4", "--seq", "32", "--batch", "2",
                      "--lr", "1e-2"])
    losses = [l for _, l in out["history"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    with pytest.raises(SystemExit, match="as in JAX's train CLI"):
        train_main(["--arch", "seamless-m4t-large-v2", "--device", "cpu",
                    "--steps", "1", "--replan", "2"])


@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, on a FileStore."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            from repro_torch.launch.mesh import make_mesh
            yield make_mesh((1, 1), ("data", "model"), "cpu")
        finally:
            dist.destroy_process_group()


def test_refusals_on_a_mesh(world_of_one):
    """On a mesh ``prefill`` and ``decode_step`` serve (ROADMAP item 3.7,
    done): at one rank their logits and caches equal one device's bit for
    bit.  ``dsp_schedule(overlap=)`` raises naming item 2; a forced
    non-mirrored backward is rejected by the explicit executor
    (``make_sharder``); cross-attention under ``tp`` raises.  The
    training loss runs at one rank."""
    cfg = TSC.SMOKE
    params = ED.init_encdec(0, cfg, device="cpu")
    sh = make_sharder(world_of_one, ParallelPlan(mode="dsp", zero=False,
                                                 shard_vocab=False))
    raw = _port_batch(inputs(CONFIG_KW["smoke"], batch=2, s_enc=16,
                             s_dec=8))
    with torch.no_grad():
        got, caches = ED.prefill(params, raw, cfg, sharder=sh, max_len=12)
        want, one = ED.prefill(params, raw, cfg, max_len=12)
        assert torch.equal(got, want)
        for _ in range(2):
            tok = ED.argmax(want, cfg)
            got, caches = ED.decode_step(params, tok, caches, cfg,
                                         sharder=sh)
            want, one = ED.decode_step(params, tok, one, cfg)
            assert torch.equal(got, want)
    for part in ("kv", "cross"):
        for kv in ("k", "v"):
            assert torch.equal(caches["periods"][part][kv],
                               one["periods"][part][kv])
    with pytest.raises(NotImplementedError, match="item 2"):
        ED.dsp_schedule(cfg, 1, overlap="chunked")
    n_stages = len(ED.stages(cfg))
    sched = ED.dsp_schedule(cfg, 1, s_enc=16, s_dec=8, batch=2, joint=True,
                            bwd_dims=(2,) * n_stages)
    assert not sched.mirrored
    with pytest.raises(NotImplementedError, match="non-mirrored"):
        make_sharder(world_of_one, ParallelPlan(mode="dsp", zero=False,
                                                shard_vocab=False),
                     schedule=sched)
    with pytest.raises(ValueError, match="full stage graph"):
        ED.dsp_schedule(cfg, 1, bwd_dims=(1, 2))
    tp = make_sharder(world_of_one, ParallelPlan(mode="tp", zero=False,
                                                 shard_vocab=False),
                      param_specs={})
    from repro_torch.models import attention as A
    x = torch.zeros(2, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        A.attention_sp(params["dec_periods"]["cross_attn"], x,
                       cfg.attn_cfg(rope=False), sharder=tp, x_kv=x)
    loss, _ = ED.encdec_loss(params, raw, cfg, sharder=sh, backend="ref")
    want, _ = ED.encdec_loss(params, raw, cfg, backend="ref")
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
