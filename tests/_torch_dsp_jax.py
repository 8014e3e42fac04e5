"""The JAX package's side of the port's DSP checks, on 4 simulated CPU
devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_dsp_jax.py <dir>

Reads ``dir/params.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_dsp.py``) and writes ``dir/jax.npz``: each rank's local
shard after ``dynamic_switch`` / ``gather`` inside ``shard_map``,
``make_spmd_forward(mode="dsp", backend="ref")`` at meshes (1, 4) and
(2, 2), and ``t2d_loss`` with its gradient at ``mesh=None``."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def flatten(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flatten(tree[key], f"{path}/{key}").items()}
    return {path.lstrip("/"): tree}


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import compat, dynamic_switch, gather
    from repro.models import transformer2d as JT

    work = sys.argv[1]
    assert len(jax.devices()) == 4, jax.devices()
    cfg = JT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                       d_ff=128, in_dim=16, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        jnp.asarray, unflatten(dict(np.load(os.path.join(work,
                                                         "params.npz")))))
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {}

    # each rank's local shard, stacked on a leading rank dim
    mesh = compat.make_mesh((1, 4), ("data", "model"))

    def local(body):
        f = compat.shard_map(lambda x: body(x)[None], mesh=mesh,
                             in_specs=P(None, "model"),
                             out_specs=P("model"), check_vma=False)
        return np.asarray(jax.jit(f)(jnp.asarray(raw["prim_x"])))

    out["prim/y"] = local(lambda x: dynamic_switch(x, 1, 2))
    out["prim/z"] = local(lambda x: dynamic_switch(dynamic_switch(x, 1, 2),
                                                   2, 1))
    out["prim/full"] = local(lambda x: gather(x, 1))

    x, t = jnp.asarray(raw["x"]), jnp.asarray(raw["t"])
    for name, shape in (("1x4", (1, 4)), ("2x2", (2, 2))):
        m = compat.make_mesh(shape, ("data", "model"))
        fwd = JT.make_spmd_forward(cfg, m, mode="dsp", backend="ref")
        out[f"fwd{name}"] = np.asarray(jax.jit(fwd)(params, x, t))

    batch = {k: jnp.asarray(raw[k]) for k in ("x", "t", "target")}

    def loss(p):
        return JT.t2d_loss(p, batch, cfg, backend="ref")[0]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    out["loss"] = np.asarray(value)
    for path, g in flatten(grads).items():
        out[f"grad/{path}"] = np.asarray(g)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
