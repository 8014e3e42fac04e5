"""The JAX package's side of the port's elastic check, on 4 simulated CPU
devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_ckpt_jax.py <dir>

Reads ``dir/params.npz`` (written by ``tests/test_torch_elastic.py``) and
writes ``dir/jax.npz``: ``tests/md_scenarios.py``'s
``elastic_train_resize`` at the port's worker's sizes
(``_torch_ckpt_worker``: its config, plan, batches and AdamW): JAX's
``Trainer`` on a (2, 2) mesh for ``RESIZE_AT`` steps with a checkpoint,
then a fresh one that resumes, ``replan(2)`` and runs to
``ELASTIC_STEPS``; the losses of both runs and the resized mesh.
``backend="ref"``.

This module imports no JAX at the top, as its siblings."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import unflatten  # noqa: E402

WORLD = 4


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from _torch_ckpt_worker import (BATCH, CFG_KW, ELASTIC_OPT,
                                    ELASTIC_STEPS, RESIZE_AT, SEQ, batch)
    from repro.models import lm
    from repro.optim.adamw import OptConfig
    from repro.parallel.partition import (ParallelPlan, make_sharder,
                                          param_pspecs)
    from repro.train.trainer import ElasticSpec, Trainer, TrainerConfig

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = lm.LMConfig(**CFG_KW, dtype=jnp.float32)
    plan = ParallelPlan(mode="dsp", shard_vocab=False)
    host = unflatten(dict(np.load(os.path.join(work, "params.npz"))))

    def make_loss(mesh, sharder, schedule):
        return lambda p, b: lm.lm_loss(p, b, cfg, sharder=sharder,
                                       backend="ref")

    def solve_schedule(sp, topo):
        return lm.dsp_schedule(cfg, sp, seq=SEQ, batch=BATCH, topology=topo,
                               joint=True)

    def make_trainer(total):
        mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
        specs = param_pspecs(host, plan, axis_sizes=dict(mesh.shape))
        params = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
            host, specs)
        schedule = solve_schedule(2, None)
        sharder = make_sharder(mesh, plan, schedule=schedule)
        return Trainer(
            loss_fn=make_loss(mesh, sharder, schedule), params=params,
            opt_cfg=OptConfig(**ELASTIC_OPT),
            cfg=TrainerConfig(total_steps=total, log_every=1,
                              ckpt_every=RESIZE_AT),
            data_fn=lambda s: {k: jnp.asarray(v) for k, v in
                               batch(s).items()},
            ckpt_dir=os.path.join(work, "ck_jax"), schedule=schedule,
            mesh=mesh, elastic=ElasticSpec(make_loss=make_loss,
                                           solve_schedule=solve_schedule,
                                           plan=plan))

    first = make_trainer(RESIZE_AT)
    losses = [loss for _, loss in first.run()["history"]]
    second = make_trainer(ELASTIC_STEPS)
    second.try_resume()
    assert second.start_step == RESIZE_AT
    second.replan(2)
    losses += [loss for _, loss in second.run()["history"]]
    np.savez(os.path.join(work, "jax.npz"), losses=np.array(losses),
             mesh=np.array([second.mesh.shape["data"],
                            second.mesh.shape["model"]]))


if __name__ == "__main__":
    main()
