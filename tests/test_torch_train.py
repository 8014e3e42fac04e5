"""The port's training path against the JAX package at mamba2-370m's SMOKE
size (float32, 4 layers, d_model 64, chunk 16): ``forward``, ``lm_loss``
and every gradient (JAX through the Pallas kernel, interpret mode), one
AdamW step, and 5 ``Trainer`` steps on the JAX pipeline's batches; and
qwen3-14b's SMOKE loss and gradients through flash attention's autograd.  JAX
weights cross over through ``bridge.params_from_numpy``; batches cross
as numpy, since ``torch.Generator`` cannot replay ``jax.random``.
Tolerance 1e-4 relative: the same math summed in another order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_370m as jconf
from repro.configs import qwen3_14b as jqconf
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import lm as JLM
from repro.optim import adamw as JO
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch import bridge
from repro_torch.configs import mamba2_370m as tconf
from repro_torch.configs import qwen3_14b as tqconf
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TO
from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

JCFG, TCFG = jconf.SMOKE, tconf.SMOKE
REL = 1e-4


@pytest.fixture(scope="module")
def jparams():
    return JLM.init_lm(jax.random.PRNGKey(0), JCFG)


def _cross(jtree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                                    device="cpu")


def _batch(seed, shape=(2, 40)):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, JCFG.vocab, shape),
            "labels": rng.randint(0, JCFG.vocab, shape)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _pairs(ttree, jtree, path=""):
    """(path, port leaf, JAX leaf) over the port tree's leaves."""
    if isinstance(ttree, dict):
        for k in ttree:
            yield from _pairs(ttree[k], jtree[k], f"{path}/{k}")
    else:
        yield path, ttree, jtree


def test_configs_match_jax():
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "pure_ssm", "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert dataclasses.asdict(j.ssm_cfg) == dataclasses.asdict(t.ssm_cfg)
        assert jnp.dtype(j.dtype).name == str(t.dtype).split(".")[-1]
    assert TLM.param_counts(tconf.CONFIG) == JLM.param_counts(jconf.CONFIG)
    from repro_torch import configs
    assert configs.get("mamba2-370m").config is tconf.CONFIG


def test_init_tree_matches_jax(jparams):
    """Same keys, shapes and dtypes, so weights cross over as they are."""
    tp = TLM.init_lm(0, TCFG, device="cpu")
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype.name),
                                  jparams)
    assert TLM.tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                        tp) == want
    full = TLM.init_lm(0, dataclasses.replace(TCFG, dtype=torch.bfloat16),
                       device="cpu")
    ssm = full["periods"]["0"]["ssm"]
    assert ssm["a_log"].dtype == torch.float32
    assert ssm["in_proj"]["w"].dtype == torch.bfloat16


def test_forward_matches_jax(jparams):
    b = _batch(1)
    want, _ = JLM.forward(jparams, jnp.asarray(b["tokens"]), JCFG,
                          backend="pallas")
    with torch.no_grad():
        got = TLM.forward(_cross(jparams), torch.from_numpy(b["tokens"]),
                          TCFG)
    assert _rel(got, want) < REL


@pytest.fixture(scope="module")
def jax_loss_and_grads(jparams):
    b = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: JLM.lm_loss(p, b, JCFG, backend="pallas")[0]))
    return fn(jparams)


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_grads_match_jax(jparams, jax_loss_and_grads, remat):
    jloss, jgrads = jax_loss_and_grads
    tp = TLM.tree_map(lambda a: a.requires_grad_(True), _cross(jparams))
    b = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    loss, aux = TLM.lm_loss(tp, b, TCFG, remat=remat)
    assert aux["xent"] is loss
    loss.backward()
    assert abs(loss.item() - float(jloss)) / abs(float(jloss)) < REL
    n = 0
    for path, t, j in _pairs(tp, jgrads):
        assert _rel(t.grad, j) < REL, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))


@pytest.mark.parametrize("clip", [1.0, 1e-3, None])
@pytest.mark.parametrize("master", [True, False])
def test_apply_adamw_matches_jax(clip, master):
    rng = np.random.RandomState(3)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "n": {"b": rng.standard_normal((7,)).astype(np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    jcfg = JO.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                        grad_clip=clip, use_master=master)
    tcfg = TO.OptConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                        grad_clip=clip, use_master=master)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jp["w"] = jp["w"].astype(jnp.bfloat16)       # a bf16 leaf beside f32
    tp = _cross(jp)
    jst, tst = JO.init_opt_state(jp, jcfg), TO.init_opt_state(tp, tcfg)
    tg = _cross(grads)
    for _ in range(2):
        jp, jst, jm = JO.apply_adamw(jp, grads, jst, jcfg)
        tp, tst, tm = TO.apply_adamw(tp, tg, tst, tcfg)
    assert tst["step"] == int(jst["step"]) == 2
    assert abs(tm["lr"] - float(jm["lr"])) <= 1e-7
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    assert tp["w"].dtype == torch.bfloat16
    for tree_t, tree_j in ((tp, jp), (tst["m"], jst["m"]),
                           (tst["v"], jst["v"])):
        for path, t, j in _pairs(tree_t, tree_j):
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-6,
                                       err_msg=path)
    assert ("master" in tst) == master


def test_schedule_matches_jax():
    for warm, total in ((10, 110), (0, 5), (3, 3)):
        jc = JO.OptConfig(peak_lr=2.0, warmup_steps=warm, total_steps=total)
        tc = TO.OptConfig(peak_lr=2.0, warmup_steps=warm, total_steps=total)
        for step in (0, 1, warm, warm + 1, total // 2, total, total + 7):
            assert TO.schedule(tc, step) == pytest.approx(
                float(JO.schedule(jc, jnp.asarray(step))), rel=1e-6, abs=1e-7)


def test_trainer_matches_jax(jparams):
    """5 Trainer steps on the JAX pipeline's lm_shift batches: the same
    loss at every step (JAX through its plain reference backend, as its
    train CLI runs on a CPU)."""
    dcfg = JDataConfig(task="lm_shift", vocab=JCFG.vocab, seq=32, batch=2)
    batches = [{k: np.asarray(v) for k, v in jmake_batch(dcfg, s).items()}
               for s in range(5)]
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5)
    jt = JTrainer(loss_fn=lambda p, b: JLM.lm_loss(p, b, JCFG, backend="ref"),
                  params=jparams, opt_cfg=JO.OptConfig(**kw),
                  cfg=JTrainerConfig(total_steps=5, log_every=1),
                  data_fn=lambda s: {k: jnp.asarray(v)
                                     for k, v in batches[s].items()})
    tt = Trainer(loss_fn=lambda p, b: TLM.lm_loss(p, b, TCFG),
                 params=_cross(jparams), opt_cfg=TO.OptConfig(**kw),
                 cfg=TrainerConfig(total_steps=5, log_every=1),
                 data_fn=lambda s: {k: torch.tensor(v)
                                    for k, v in batches[s].items()},
                 device="cpu")
    jh, th = jt.run()["history"], tt.run()["history"]
    assert [s for s, _ in th] == [s for s, _ in jh] == [1, 2, 3, 4, 5]
    for (_, tl), (_, jl) in zip(th, jh):
        assert abs(tl - jl) / abs(jl) < REL, (th, jh)
    assert th[-1][1] < th[0][1]


def test_grad_accum_matches_jax(jparams):
    """Two microbatches stacked on a leading dim: the averaged loss and the
    updated parameters match JAX's scanned accumulation."""
    b = _batch(4, shape=(2, 2, 24))
    # eps well above the smallest gradients: a first Adam step is
    # lr * sign(g) where |g| << eps fails to hold, which would turn
    # rounding-level gradient differences into whole-step differences
    ocfg = dict(peak_lr=1e-2, warmup_steps=0, total_steps=4, eps=1e-3)
    jstep = jax.jit(jmake_train_step(
        lambda p, mb: JLM.lm_loss(p, mb, JCFG, backend="ref"),
        JO.OptConfig(**ocfg), grad_accum=2))
    jp, _, jm = jstep(jparams, JO.init_opt_state(jparams, JO.OptConfig(**ocfg)),
                      {k: jnp.asarray(v) for k, v in b.items()})
    tp = _cross(jparams)
    step = make_train_step(lambda p, mb: TLM.lm_loss(p, mb, TCFG),
                           TO.OptConfig(**ocfg), grad_accum=2)
    tp, _, tm = step(tp, TO.init_opt_state(tp, TO.OptConfig(**ocfg)),
                     {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) / float(jm["loss"]) < REL
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < \
        REL * float(jm["grad_norm"])
    for path, t, j in _pairs(tp, jp):
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def _scan_no_carry(xdt, da, b, c, *, chunk):
    """Each chunk scanned from a zero state: the inter-chunk term dropped."""
    bsz, h, l, _ = xdt.shape
    n = l // chunk

    def split(t):
        t = t.reshape(bsz, t.shape[1], n, chunk, *t.shape[3:])
        return t.transpose(1, 2).reshape(bsz * n, *t.shape[1:2],
                                         *t.shape[3:])

    y = ssd_scan_plain(split(xdt), split(da), split(b), split(c), chunk=chunk)
    return y.reshape(bsz, n, h, chunk, -1).transpose(1, 2).reshape(xdt.shape)


def _scan_b_row_zeroed(xdt, da, b, c, *, chunk):
    b = b.clone()
    b[:, :, 37] = 0
    return ssd_scan_plain(xdt, da, b, c, chunk=chunk)


@pytest.mark.parametrize("scan, passes", [
    (lambda xdt, da, b, c, *, chunk: ssd_scan_plain(xdt, da, b, c,
                                                    chunk=chunk // 2), True),
    (_scan_no_carry, False),
    (_scan_b_row_zeroed, False)], ids=["reordered", "no_carry", "b_row"])
def test_chip_smoke_grads_bar_discriminates(monkeypatch, scan, passes):
    """The depth-2 loss-and-grads bars chip_smoke holds the kernel path to,
    at mamba2 SMOKE width with a plain scan standing in for the kernel.
    In float32, so that the sums in another order (half the chunk) differ
    at all; they pass.  A scan that drops the inter-chunk term, or one row
    of b, fails the loss bar and the grad bar each on its own."""
    import chip_smoke
    from repro_torch.kernels import ops as tops
    monkeypatch.setattr(tops, "_use_plain",
                        lambda t, backend: backend == "ref")
    monkeypatch.setattr(tops, "ssd_scan_fwd", scan)
    cfg = dataclasses.replace(TCFG, n_layers=2)
    params = TLM.init_lm(0, cfg, device="cpu")
    batch = make_batch(DataConfig(task="lm_random", vocab=cfg.vocab, seq=64,
                                  batch=2), 0, device="cpu")
    gap = chip_smoke.loss_grads_gap(params, batch, cfg)
    assert gap["leaves"] == len(TLM.tree_leaves(params))
    assert gap["leaf"].startswith("/")
    if passes:
        assert chip_smoke.gap_passes(gap), gap
    else:
        assert gap["loss_rel"] > chip_smoke.LOSS_BAR, gap
        assert gap["grad_rel"] > chip_smoke.GRAD_BAR, gap


@pytest.mark.parametrize("task", ["lm_shift", "lm_random"])
def test_make_batch(task):
    cfg = DataConfig(task=task, vocab=97, seq=64, batch=8, noise=0.05)
    b0, again, b1 = (make_batch(cfg, s, device="cpu") for s in (0, 0, 1))
    assert set(b0) == {"tokens", "labels"}
    for k in b0:
        assert b0[k].shape == (8, 64) and b0[k].dtype == torch.int64
        assert torch.equal(b0[k], again[k])
        assert int(b0[k].min()) >= 0 and int(b0[k].max()) < 97
    assert not torch.equal(b0["tokens"], b1["tokens"])
    shifted = float(((b0["tokens"] + 1) % 97 == b0["labels"]).float().mean())
    if task == "lm_shift":
        assert shifted > 0.85
    else:
        assert shifted < 0.1
    with pytest.raises(ValueError):
        make_batch(dataclasses.replace(cfg, task="encdec"), 0, device="cpu")


def test_trainer_rejects_what_is_not_ported():
    tp = TLM.init_lm(0, TCFG, device="cpu")
    kw = dict(loss_fn=None, params=tp, opt_cfg=TO.OptConfig(),
              data_fn=None, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Trainer(cfg=TrainerConfig(), ckpt_dir="/nonexistent", **kw)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Trainer(cfg=TrainerConfig(grad_compress=True), **kw)


# ---------------------------------------------------------------------------
# qwen3-14b: attention layers train through flash attention's autograd
# ---------------------------------------------------------------------------

QJCFG, QTCFG = jqconf.SMOKE, tqconf.SMOKE


@pytest.fixture(scope="module")
def qwen_jparams():
    return JLM.init_lm(jax.random.PRNGKey(1), QJCFG)


def test_qwen3_lm_loss_and_grads_match_jax(qwen_jparams):
    """lm_loss and every grad leaf of qwen3 SMOKE (2 layers, GQA 8/2,
    qk-norm, untied embeddings): JAX through the Pallas forward (interpret
    mode) and its custom VJP, the port through ``_FlashAttention``."""
    b = {k: v for k, v in zip(("tokens", "labels"), (
        np.random.RandomState(7).randint(0, QJCFG.vocab, (2, 40)),
        np.random.RandomState(8).randint(0, QJCFG.vocab, (2, 40))))}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JLM.lm_loss(p, jb, QJCFG, backend="pallas")[0]))(
        qwen_jparams)
    tp = TLM.tree_map(lambda a: a.requires_grad_(True), _cross(qwen_jparams))
    loss, _ = TLM.lm_loss(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                          QTCFG)
    loss.backward()
    assert abs(loss.item() - float(jloss)) / abs(float(jloss)) < REL
    n = 0
    for path, t, j in _pairs(tp, jgrads):
        assert _rel(t.grad, j) < REL, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads)) > 10


def test_qwen3_checkpointed_step_launches_the_kernel_twice_a_layer(
        monkeypatch):
    """With a stand-in for the flash-attention kernel on the kernel route,
    one loss and backward launches it twice per attention layer (the
    forward and the checkpointed recompute) and the backward through
    ``attention_ref`` not at all: chip_smoke's 2 x layers x steps count."""
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    calls = []

    def stand_in(*a, **kw):
        calls.append(1)
        return flash_attention_plain(*a, **kw)

    monkeypatch.setattr(tops, "_use_plain", lambda t, backend: False)
    monkeypatch.setattr(tops, "flash_attention_fwd", stand_in)
    tp = TLM.tree_map(lambda a: a.requires_grad_(True),
                      TLM.init_lm(0, QTCFG, device="cpu"))
    b = make_batch(DataConfig(task="lm_shift", vocab=QTCFG.vocab, seq=24,
                              batch=2), 0, device="cpu")
    loss, _ = TLM.lm_loss(tp, b, QTCFG)
    assert len(calls) == QTCFG.n_layers
    loss.backward()
    assert len(calls) == 2 * QTCFG.n_layers
    assert all(p.grad is not None for p in TLM.tree_leaves(tp))


def test_train_cli_trains_qwen3_on_cpu():
    from repro_torch.launch.train import main
    out = main(["--arch", "qwen3-14b", "--steps", "20", "--batch", "4",
                "--seq", "32", "--grad-accum", "2", "--device", "cpu"])
    hist = out["history"]
    assert out["final_step"] == 20 and len(hist) == 10
    assert all(np.isfinite(l) for _, l in hist)
    assert hist[-1][1] < hist[0][1]


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch.train import main
    out = main(["--arch", "mamba2-370m", "--steps", "20", "--batch", "4",
                "--seq", "32", "--grad-accum", "2", "--device", "cpu"])
    hist = out["history"]
    assert out["final_step"] == 20 and len(hist) == 10
    assert all(np.isfinite(l) for _, l in hist)
    assert hist[-1][1] < hist[0][1]
    assert "loss " in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--ckpt-dir", "x"], ["--resume"],
                                  ["--replan", "2"], ["--devices", "4"],
                                  ["--mesh", "2,2"], ["--grad-compress"]])
def test_train_cli_unported_flags_exit(flag):
    from repro_torch.launch.train import main
    with pytest.raises(SystemExit, match="not yet ported"):
        main(["--arch", "mamba2-370m", "--device", "cpu"] + flag)
