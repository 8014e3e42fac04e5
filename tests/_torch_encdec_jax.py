"""The JAX package's side of the port's enc-dec checks on a mesh
(``tests/test_torch_encdec_dsp.py``), on 4 simulated CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_encdec_jax.py <dir>

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` and writes
``dir/jax.npz``: for each scenario of ``SCENARIOS``, JAX's
``encdec_loss(sharder=make_sharder(mesh, PLAN), backend="ref",
remat=True)`` on its ``("data", "model")`` mesh, the parameters placed by
JAX's ``param_pspecs(stacked_prefixes=("enc_periods", "dec_periods"))``
and the batch split by batch over ``data`` and by each sequence over
``model`` (``repro.launch.steps.build_encdec_cell``'s specs), one jitted
``value_and_grad``: the loss, every gradient leaf whole, and the
collectives of the compiled step by kind (``parse_collectives``; a
finding, not a bar).

This module imports no JAX at the top: the gloo workers and the tests
read its constants and configs."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

WORLD = 4
# config name -> EncDecConfig fields (both packages' dataclass takes them)
CONFIG_KW = {
    # seamless-m4t-large-v2's SMOKE config
    "smoke": dict(name="seamless-smoke", n_enc_layers=2, n_dec_layers=2,
                  d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                  d_ff=128, vocab=512, frontend_dim=40, mlp_kind="relu",
                  norm_kind="layer"),
    # a narrow 2 + 2 config with the other branches: GQA 6/2, gelu, rms
    "narrow": dict(name="narrow", n_enc_layers=2, n_dec_layers=2,
                   d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
                   d_ff=160, vocab=510, frontend_dim=24, mlp_kind="gelu",
                   norm_kind="rms"),
    # the SMOKE shape with a vocab that 2 divides and 4 does not, as
    # seamless's 256206 = 2 x 3 x 42701: the table stays whole at (1, 4)
    # and splits over model at (2, 2)
    "mesh": dict(name="mesh", n_enc_layers=2, n_dec_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=510,
                 frontend_dim=40, mlp_kind="relu", norm_kind="layer"),
    # GQA 4/2 on 4 ranks: the K/V heads repeated up to the ranks
    "gqa": dict(name="gqa", n_enc_layers=1, n_dec_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96, vocab=512,
                frontend_dim=40, mlp_kind="relu", norm_kind="layer"),
}
# scenario -> (config, (data, model) mesh)
SCENARIOS = {"mesh/1x4": ("mesh", (1, 4)), "mesh/2x2": ("mesh", (2, 2)),
             "gqa/1x4": ("gqa", (1, 4))}
BATCH, S_ENC, S_DEC = 2, 32, 16
HLO_KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
             "collective-permute")


def config(ed, name: str, dtype):
    """The config ``name`` of the package whose ``models.encdec`` is
    ``ed``, in ``dtype``."""
    return ed.EncDecConfig(**CONFIG_KW[name], dtype=dtype)


def params_np(name: str, seed: int = 0):
    """JAX's init of config ``name`` (float32) as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.models import encdec as JE
    cfg = config(JE, name, jnp.float32)
    return jax.tree_util.tree_map(
        np.asarray, JE.init_encdec(jax.random.PRNGKey(seed), cfg))


def inputs(cfg_kw, batch=BATCH, s_enc=S_ENC, s_dec=S_DEC, seed=11):
    """feats (B, S_enc, F) float32, tokens and labels (B, S_dec) int32."""
    rng = np.random.RandomState(seed)
    return {"feats": rng.randn(batch, s_enc,
                               cfg_kw["frontend_dim"]).astype(np.float32),
            "tokens": rng.randint(0, cfg_kw["vocab"],
                                  (batch, s_dec)).astype(np.int32),
            "labels": rng.randint(0, cfg_kw["vocab"],
                                  (batch, s_dec)).astype(np.int32)}


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.analysis.roofline import parse_collectives
    from repro.models import encdec as JE
    from repro.parallel.partition import (ParallelPlan, make_sharder,
                                          param_pspecs)

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    plan = ParallelPlan(mode="dsp", zero=True)
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {}
    for name, (cname, shape) in SCENARIOS.items():
        cfg = config(JE, cname, jnp.float32)
        params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
            np.load(os.path.join(work, f"params_{cname}.npz")))))
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        specs = param_pspecs(params, plan, axis_sizes=dict(mesh.shape),
                             stacked_prefixes=("enc_periods", "dec_periods"))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params, specs)
        bspecs = {"feats": P("data", "model", None),
                  "tokens": P("data", "model"), "labels": P("data", "model")}
        batch = {k: jax.device_put(jnp.asarray(raw[f"{cname}/{k}"]),
                                   NamedSharding(mesh, s))
                 for k, s in bspecs.items()}
        sharder = make_sharder(mesh, plan)

        def loss(p, b, cfg=cfg, sharder=sharder):
            return JE.encdec_loss(p, b, cfg, sharder=sharder, backend="ref",
                                  remat=True)[0]

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
