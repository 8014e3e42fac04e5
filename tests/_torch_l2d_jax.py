"""The JAX package's side of the port's 2D-layout checks, on 8 simulated
CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_l2d_jax.py <dir>

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_layout2d.py``) and writes ``dir/jax.npz``:
``forward2d(backend="ref")`` at each case of ``CASES`` on its SP grid
(global outputs, and at ``HLO_CASE`` the collectives of its compiled
HLO by kind),
and the gradient of mean(out²) at (2, 4) with ``remat``."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

# case -> (config: "t" or "fold", input, (sp_out, sp_in, data)); JAX runs
# each on its SP grid alone, the port with the data dim
CASES = {"g24": ("t", "x24", (2, 4, 1)), "g18": ("t", "x18", (1, 8, 1)),
         "g222": ("t6", "x22", (2, 2, 2)), "g412": ("t", "x22", (4, 1, 2)),
         "g11": ("t", "x24", (1, 1, 1)), "fold": ("fold", "xf", (2, 4, 1))}
# the case whose compiled forward2d is counted, by the collective kinds of
# HLO_KINDS
HLO_CASE = "g222"
HLO_KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
             "collective-permute")


def configs(dtype):
    """The configs of the checks, as keyword dicts: ``t`` (the
    ``layout2d_t2d`` scenario's), ``t6`` (the same at 6 blocks: an odd
    number of periods, so a misnumbered diagonal on the (2, 2) grid, an
    involution there, does not undo itself) and ``fold``
    (``comm_volume.py``'s TSP-fold instance at d 32)."""
    t = dict(name="t", n_layers=4, d_model=32, n_heads=4, d_ff=64, in_dim=8,
             dtype=dtype)
    fold = dict(name="fold", n_layers=4, d_model=32, n_heads=4, d_ff=64,
                in_dim=16, modulate=False, dtype=dtype)
    return {"t": t, "t6": dict(t, n_layers=6), "fold": fold}


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.analysis.roofline import parse_collectives
    from repro.launch.mesh import make_sp2d_mesh
    from repro.models import transformer2d as JT

    work = sys.argv[1]
    assert len(jax.devices()) == 8, jax.devices()
    cfgs = {k: JT.T2DConfig(**kw) for k, kw in configs(jnp.float32).items()}
    params = {name: jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, f"params_{name}.npz"))))) for name in cfgs}
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    t = jnp.asarray(raw["t"])
    out = {}
    for case, (cname, xname, (p_out, p_in, _)) in CASES.items():
        # the SP grid alone: JAX's forward2d names a data dim twice in its
        # fold's sharding, so the port alone runs the data dim
        mesh = Mesh(np.array(jax.devices()[:p_out * p_in]).reshape(
            p_out, p_in), ("sp_out", "sp_in"))
        cfg = cfgs[cname]
        x = jnp.asarray(raw[xname])
        fn = jax.jit(lambda p, xx, tt, m=mesh, c=cfg: JT.forward2d(
            p, xx, tt, c, mesh=m, remat=False)).lower(
                params[cname], x, t).compile()
        out[case] = np.asarray(fn(params[cname], x, t))
        if case == HLO_CASE:
            counts = parse_collectives(fn.as_text()).by_kind_count
            out[f"hlo/{case}"] = np.array([int(counts.get(k, 0))
                                           for k in HLO_KINDS])

    cfg, mesh = cfgs["t"], make_sp2d_mesh(2, 4)
    x = jnp.asarray(raw["x24"])

    def loss(p):
        y = JT.forward2d(p, x, t, cfg, mesh=mesh, remat=True)
        return jnp.mean(y.astype(jnp.float32) ** 2)

    for path, g in flatten(jax.jit(jax.grad(loss))(params["t"])).items():
        out[f"grad/{path}"] = np.asarray(g)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
