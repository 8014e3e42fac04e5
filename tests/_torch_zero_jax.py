"""The JAX package's side of the port's parameter-layout checks (ZeRO-3,
the vocab ring), on 4 simulated CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_zero_jax.py <dir>

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_param_layouts.py``) and writes ``dir/jax.npz``: for
each scenario of ``SCENARIOS``, on its ``("data", "model")`` mesh under
its plan and the joint ``dsp_schedule``, with the parameters placed by
JAX's own ``param_pspecs`` (as ``repro.train.trainer._place_tree`` places
them), one jitted ``value_and_grad`` of ``lm_loss``'s forward and chunked
loss: the global forward output, the loss, every gradient leaf, and the
collectives of the compiled step by kind (``parse_collectives``; a
finding, not a bar).  ``backend="ref"``, ``remat=False``.

This module imports no JAX at the top: the gloo workers and the test read
``SCENARIOS`` and ``PLANS`` from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

# plan name -> (zero, shard_vocab) of ParallelPlan(mode="dsp", ...)
PLANS = {"zero_vocab": (True, True), "vocab": (False, True),
         "zero": (True, False)}
# scenario -> (config of ``_torch_lmdsp_jax.configs``, (data, model) mesh,
# plan name)
SCENARIOS = {
    **{f"{c}/{d}x{m}/zero_vocab": (c, (d, m), "zero_vocab")
       for c in ("hybrid", "mha", "kvg") for d, m in ((1, 4), (2, 2))},
    **{f"mha/{d}x{m}/{p}": ("mha", (d, m), p)
       for p in ("vocab", "zero") for d, m in ((1, 4), (2, 2))},
}
WORLD = 4
HLO_KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
             "collective-permute")


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from _torch_lmdsp_jax import BATCH, SEQ, configs
    from repro.analysis.roofline import parse_collectives
    from repro.models import lm, ssm
    from repro.parallel.partition import (ParallelPlan, make_sharder,
                                          param_pspecs)

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfgs = configs(lm, ssm, jnp.float32)
    params = {name: jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, f"params_{name}.npz"))))) for name in cfgs}
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    batch = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
    out = {}
    for name, (cname, shape, pname) in SCENARIOS.items():
        cfg = cfgs[cname]
        zero, vocab = PLANS[pname]
        plan = ParallelPlan(mode="dsp", zero=zero, shard_vocab=vocab)
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        sh = make_sharder(mesh, plan, schedule=lm.dsp_schedule(
            cfg, shape[1], seq=SEQ, batch=BATCH, joint=True))
        specs = param_pspecs(params[cname], plan, axis_sizes=dict(mesh.shape))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params[cname], specs)

        def loss(p, c=cfg, s=sh):
            x, _ = lm.forward(p, batch["tokens"], c, sharder=s,
                              backend="ref", remat=False)
            table = (p["embed"]["table"] if c.tie_embeddings
                     else p["unembed"]["table"])
            return lm.chunked_xent(x, table, batch["labels"], c,
                                   sharder=s), x

        step = jax.jit(jax.value_and_grad(loss, has_aux=True)).lower(
            placed).compile()
        (value, x), grads = step(placed)
        out[f"{name}/out"] = np.asarray(x)
        out[f"{name}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)
        counts = parse_collectives(step.as_text()).by_kind_count
        out[f"{name}/hlo"] = np.array([int(counts.get(k, 0))
                                       for k in HLO_KINDS])
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
