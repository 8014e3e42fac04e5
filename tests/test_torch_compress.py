"""The port's error-feedback int8 compression (``optim.compress``) and the
``Trainer`` with checkpoints and compression, against the JAX package on
the CPU.

1. ``compress_with_feedback`` over 3 steps of residuals, bit for bit
   against JAX's jitted one (the step its trainer runs: XLA rounds the
   residual once, through a fused multiply-subtract), with leaves under
   and over the 4096-element pass-through; ``quantize_int8``'s rounding
   at exact halves; ``compressed_bytes``.
2. The ``Trainer`` with ``ckpt_dir`` and ``grad_compress`` against JAX's
   on the same init and batches (JAX's parameters carried over as numpy,
   batches from a seeded numpy generator): the losses of 6 steps within
   1e-5 relative.  A restart from the step-3 checkpoint replays steps 4 to
   6 bit for bit against the uninterrupted run (JAX's
   ``tests/test_system.py`` restart test), residuals included.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models import lm as JLM
from repro.optim import adamw as JO
from repro.optim import compress as JC
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.models import lm as TLM
from repro_torch.optim import adamw as TO
from repro_torch.optim import compress as TC
from repro_torch.train.trainer import Trainer, TrainerConfig

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

# tests/test_system.py's TINY: 2 attention layers, GQA 4/2, f32
JCFG = JLM.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                    dtype=jnp.float32)
TCFG = TLM.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                    dtype=torch.float32)
STEPS, RESTART = 6, 3
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=STEPS)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _grads(rng, step):
    """Seeded grads: a leaf under the pass-through, two over it (one of
    them small in scale), scaled by the step so that the residuals move."""
    scale = 1.0 + step
    return {"w": (rng.standard_normal((64, 100)) * scale).astype(np.float32),
            "norm": {"scale": rng.standard_normal(10).astype(np.float32)},
            "tiny": (rng.standard_normal(5000) * 1e-3).astype(np.float32)}


def test_compress_with_feedback_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    first = _grads(rng, 0)
    jr = JC.init_residuals(jax.tree_util.tree_map(jnp.asarray, first))
    tr = TC.init_residuals(_torch_tree(first))
    jstep = jax.jit(JC.compress_with_feedback)
    for step in range(3):
        g = first if step == 0 else _grads(rng, step)
        jg, jr = jstep(jax.tree_util.tree_map(jnp.asarray, g), jr)
        tg, tr = TC.compress_with_feedback(_torch_tree(g), tr)
        for name, a, b in (("grads", jg, tg), ("residuals", jr, tr)):
            fa, fb = flatten(a), flatten(b)
            assert sorted(fa) == sorted(fb) and len(fa) == 3
            for key, x in fa.items():
                assert np.asarray(x).tobytes() == fb[key].numpy().tobytes(), \
                    (step, name, key)
        # the small leaf passes through with a zero residual
        assert torch.equal(tg["norm"]["scale"],
                           torch.from_numpy(g["norm"]["scale"]))
        assert not tr["norm"]["scale"].any()
    assert TC.compressed_bytes(tg) == JC.compressed_bytes(jg) == \
        64 * 100 + 10 * 4 + 5000


def test_quantize_int8_rounds_halves_to_even():
    """``torch.round`` and ``jnp.round`` both round halves to even: the
    127-step grid of x = amax * k / 254 lands on halves."""
    x = np.arange(-254, 255, dtype=np.float32) / 254.0
    tq, ts = TC.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert np.asarray(jq).tobytes() == tq.numpy().tobytes()
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    assert int(tq.abs().max()) == 127


def _batch(step):
    rng = np.random.RandomState(100 + step)
    tokens = rng.randint(0, JCFG.vocab, (8, 32))
    return {"tokens": tokens, "labels": (tokens + 1) % JCFG.vocab}


def _port_trainer(params_np, ckpt_dir, total):
    return Trainer(
        loss_fn=lambda p, b: TLM.lm_loss(p, b, TCFG),
        params=bridge.params_from_numpy(params_np, device="cpu"),
        opt_cfg=TO.OptConfig(**OPT),
        cfg=TrainerConfig(total_steps=total, log_every=1, ckpt_every=RESTART,
                          grad_compress=True),
        data_fn=lambda s: {k: torch.from_numpy(v).long()
                           for k, v in _batch(s).items()},
        ckpt_dir=ckpt_dir, device="cpu")


def _leaves(tr):
    return [t for t in TLM.tree_leaves(tr._state()) if isinstance(
        t, torch.Tensor)]


def test_trainer_with_checkpoints_and_compression_matches_jax(tmp_path):
    params = JLM.init_lm(jax.random.PRNGKey(0), JCFG)
    jt = JTrainer(
        loss_fn=lambda p, b: JLM.lm_loss(p, b, JCFG, backend="ref"),
        params=params, opt_cfg=JO.OptConfig(**OPT),
        cfg=JTrainerConfig(total_steps=STEPS, log_every=1,
                           ckpt_every=RESTART, grad_compress=True),
        data_fn=lambda s: {k: jnp.asarray(v) for k, v in _batch(s).items()},
        ckpt_dir=str(tmp_path / "jax"))
    jh = [loss for _, loss in jt.run()["history"]]
    params_np = jax.tree_util.tree_map(np.asarray, params)

    whole = _port_trainer(params_np, str(tmp_path / "port"), STEPS)
    th = [loss for _, loss in whole.run()["history"]]
    assert len(th) == len(jh) == STEPS
    for t, (a, b) in enumerate(zip(th, jh)):
        assert abs(a - b) <= 1e-5 * abs(b), (t, th, jh)
    assert whole.ckpt.all_steps() == [RESTART, STEPS]
    # a fresh trainer resumes at the checkpoint and replays bit for bit
    again = _port_trainer(params_np, str(tmp_path / "port"), STEPS)
    _, restart = again.ckpt.restore(again._state(), RESTART)
    again.params, again.opt_state = restart["params"], restart["opt"]
    again.residuals = restart["residuals"]
    again.start_step = RESTART
    assert again.opt_state["step"] == RESTART
    assert again.residuals["embed"]["table"].abs().max() > 0
    rh = [loss for _, loss in again.run()["history"]]
    assert rh == th[RESTART:]
    for a, b in zip(_leaves(whole), _leaves(again)):
        assert torch.equal(a, b)


def test_try_resume_restores_the_latest_state(tmp_path):
    """``try_resume`` is a no-op on an empty directory; after a run it
    restores params, AdamW's moments, master copy and step and the
    residuals of the latest step, and the next ``run`` continues from
    it."""
    params_np = jax.tree_util.tree_map(
        np.asarray, JLM.init_lm(jax.random.PRNGKey(1), JCFG))
    first = _port_trainer(params_np, str(tmp_path), RESTART)
    first.try_resume()              # nothing saved yet: a no-op
    assert first.start_step == 0 and first.opt_state["step"] == 0
    first.run()
    saved = [t.clone() for t in _leaves(first)]
    second = _port_trainer(params_np, str(tmp_path), STEPS)
    second.try_resume()
    assert second.start_step == RESTART
    assert second.opt_state["step"] == RESTART
    got = _leaves(second)
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out = second.run()
    assert out["final_step"] == STEPS
    assert [s for s, _ in out["history"]] == [4, 5, 6]
