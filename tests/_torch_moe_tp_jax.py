"""The JAX package's side of the port's MoE-under-``tp`` checks, on 4
simulated CPU devices.

    XLA_FLAGS="$JAX_XLA_FLAGS" python tests/_torch_moe_tp_jax.py <dir>

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_moe_tp.py``) and writes ``dir/jax.npz``: for each run
of ``JAX_RUNS``, under ``ParallelPlan(mode="tp", ep=, zero=True)`` on its
mesh with the parameters placed by JAX's own ``param_pspecs``, one jitted
``value_and_grad`` of ``forward`` and ``chunked_xent`` (``backend="ref"``,
``remat=False``): the global forward output, the loss and every gradient
leaf.  Each step compiles once (~5 s a step on the CPU).

JAX's semantics are global, so its values depend neither on the mesh
nor on ``ep`` (each config's loss is the same under every plan and mesh
bit for bit, jax 0.9.0 on 4 simulated devices): each config runs once,
arctic with ``ep`` at (1, 4), qwen2-moe without at (2, 2), and the test
holds each of the port's scenarios against its config's run.

This module imports no JAX at the top: the gloo workers and the test read
its constants and ``configs`` from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_jax_flags import jax_xla_flags  # noqa: E402

WORLD = 4

# 4 simulated devices
JAX_XLA_FLAGS = jax_xla_flags(4)
BATCH, SEQ = 2, 32
# scenario -> (config, (data, model) mesh, ep); all under ZeRO-3 over data
SCENARIOS = {f"{c}/{d}x{m}/{'ep' if ep else 'cols'}": (c, (d, m), ep)
             for c in ("arctic", "qwen2moe")
             for d, m in ((1, 4), (2, 2)) for ep in (True, False)}
# the JAX package's runs: one scenario of each config
JAX_RUNS = ("arctic/1x4/ep", "qwen2moe/2x2/cols")


def configs(mod):
    """arctic-480b's and qwen2-moe-a2.7b's SMOKE configs from the package
    ``mod`` (``repro`` or ``repro_torch``)."""
    import importlib
    return {"arctic": importlib.import_module(
                f"{mod}.configs.arctic_480b").SMOKE,
            "qwen2moe": importlib.import_module(
                f"{mod}.configs.qwen2_moe_a2_7b").SMOKE}


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.models import lm
    from repro.parallel.partition import (ParallelPlan, make_sharder,
                                          param_pspecs)

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfgs = configs("repro")
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    batch = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
    trees = {c: jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, f"params_{c}.npz"))))) for c in cfgs}
    out = {}
    for name in JAX_RUNS:
        cname, shape, ep = SCENARIOS[name]
        cfg, params = cfgs[cname], trees[cname]
        plan = ParallelPlan(mode="tp", ep=ep, zero=True)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        sh = make_sharder(mesh, plan)
        specs = param_pspecs(params, plan, axis_sizes=dict(mesh.shape))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            specs)

        def loss(p, s=sh, c=cfg):
            x, _ = lm.forward(p, batch["tokens"], c, sharder=s,
                              backend="ref", remat=False)
            return lm.chunked_xent(x, p["unembed"]["table"], batch["labels"],
                                   c, sharder=s), x

        (value, x), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(placed)
        out[f"{name}/out"] = np.asarray(x)
        out[f"{name}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
