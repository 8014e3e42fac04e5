"""The JAX package's side of the port's embedded-SP baseline checks, on 4
simulated CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_sp_jax.py <dir>

Reads ``dir/params.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_sp_baselines.py``) and writes ``dir/jax.npz``: for each
scenario of ``SCENARIOS``, ``make_spmd_forward(mode=..., backend="ref")``'s
global output, and ``jax.grad`` of the sum of its squares."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

# name -> (mode, overlap, mesh): "1x4" and "2x2" are ("data", "model")
# meshes, "sp2x2" is make_sp2d_mesh(2, 2)
SCENARIOS = {
    "dsp": ("dsp", None, "1x4"),
    "chunked": ("dsp", "chunked", "1x4"),
    "double_buffer": ("dsp", "double_buffer", "1x4"),
    "ulysses": ("ulysses", None, "1x4"),
    "ulysses_fused": ("ulysses_fused", None, "1x4"),
    "ring": ("ring", None, "1x4"),
    "megatron": ("megatron", None, "1x4"),
    "megatron2x2": ("megatron", None, "2x2"),
    "hybrid": ("hybrid", None, "sp2x2"),
}


def main():
    import jax
    import jax.numpy as jnp

    from repro.core import compat
    from repro.launch.mesh import make_sp2d_mesh
    from repro.models import transformer2d as JT

    work = sys.argv[1]
    assert len(jax.devices()) == 4, jax.devices()
    cfg = JT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                       d_ff=128, in_dim=16, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        jnp.asarray, unflatten(dict(np.load(os.path.join(work,
                                                         "params.npz")))))
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    x, t = jnp.asarray(raw["x"]), jnp.asarray(raw["t"])
    meshes = {"1x4": compat.make_mesh((1, 4), ("data", "model")),
              "2x2": compat.make_mesh((2, 2), ("data", "model")),
              "sp2x2": make_sp2d_mesh(2, 2)}
    out = {}
    for name, (mode, overlap, mesh) in SCENARIOS.items():
        fwd = JT.make_spmd_forward(cfg, meshes[mesh], mode=mode,
                                   backend="ref", overlap=overlap)

        def loss(p):
            y = fwd(p, x, t)
            return jnp.sum(y * y), y

        (_, y), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        out[f"{name}/out"] = np.asarray(y)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
