"""The JAX package's side of the port's ZeRO-3 checks of the 2D DiT, on 4
simulated CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_t2d_zero_jax.py <dir>

Reads ``dir/params.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_t2d_zero.py``) and writes ``dir/jax.npz``: for each
scenario of ``SCENARIOS``, the steps of ``repro.launch.steps.
build_t2d_cell`` on its ``("data", "model")`` mesh: the parameters placed
by JAX's own ``param_pspecs`` under ``PLAN``, the batch by the cell's
specs, and one jitted ``value_and_grad`` of ``t2d_loss(mesh=, mode=,
backend="ref", remat=True, schedule=)`` (the joint ``dsp_schedule`` under
``dsp``, priced in bytes as the port's is): the loss, every gradient leaf
whole, and the collectives of the compiled step by kind
(``parse_collectives``; a finding, not a bar).

This module imports no JAX at the top: the gloo workers and the test read
its constants."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

WORLD = 4
# the DiT of tests/test_torch_dsp.py: 4 blocks (2 pairs), d 64, 4 heads
CFG_KW = dict(name="t", n_layers=4, d_model=64, n_heads=4, d_ff=128,
              in_dim=16)
BATCH, FRAMES, PATCHES = 2, 8, 16
# scenario -> (mode, (data, model) mesh), each under the specs' own plan
# of transformer2d-720m: ParallelPlan(mode="dsp", zero=True,
# shard_vocab=False)
SCENARIOS = {"dsp/2x2": ("dsp", (2, 2)), "dsp/1x4": ("dsp", (1, 4)),
             "ulysses/1x4": ("ulysses", (1, 4))}
HLO_KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
             "collective-permute")


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.analysis.roofline import parse_collectives
    from repro.models import transformer2d as JT
    from repro.parallel.partition import ParallelPlan, param_pspecs

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = JT.T2DConfig(**CFG_KW, dtype=jnp.float32)
    plan = ParallelPlan(mode="dsp", zero=True, shard_vocab=False)
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, "params.npz")))))
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {}
    for name, (mode, shape) in SCENARIOS.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        specs = param_pspecs(params, plan, axis_sizes=dict(mesh.shape))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params, specs)
        bspecs = {"x": P("data", "model", None, None), "t": P("data"),
                  "target": P("data", "model", None, None)}
        batch = {k: jax.device_put(jnp.asarray(raw[k]),
                                   NamedSharding(mesh, s))
                 for k, s in bspecs.items()}
        psched = None
        if mode == "dsp":
            psched = JT.dsp_schedule(cfg, shape[1], t_len=FRAMES,
                                     s_len=PATCHES, batch=BATCH, joint=True)

        def loss(p, b, mode=mode, mesh=mesh, psched=psched):
            return JT.t2d_loss(p, b, cfg, mesh=mesh, mode=mode,
                               backend="ref", remat=True,
                               schedule=psched)[0]

        step = jax.jit(jax.value_and_grad(loss)).lower(placed,
                                                       batch).compile()
        value, grads = step(placed, batch)
        out[f"{name}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)
        counts = parse_collectives(step.as_text()).by_kind_count
        out[f"{name}/hlo"] = np.array([int(counts.get(k, 0))
                                       for k in HLO_KINDS])
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
