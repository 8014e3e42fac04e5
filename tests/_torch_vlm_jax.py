"""The JAX package's side of the port's VLM checks on a mesh
(``tests/test_torch_vlm.py``), on 4 simulated CPU devices.

    XLA_FLAGS="$JAX_XLA_FLAGS" python tests/_torch_vlm_jax.py <dir>

Reads ``dir/params.npz`` (pixtral-12b's SMOKE config, JAX's init) and
``dir/inputs.npz`` and writes ``dir/jax.npz``: on each mesh of
``MESHES``, under pixtral's plan (``ParallelPlan(mode="dsp", zero=True)``,
the vocab split over ``model`` where it divides) and the joint
``dsp_schedule``, with the parameters placed by JAX's own
``param_pspecs``, one jitted ``value_and_grad`` of ``forward(extra=)``
and the chunked loss (``backend="ref"``, ``remat=False``): the global
forward output, the loss and every gradient leaf, the frontend's
included.

This module imports no JAX at the top: the gloo workers and the test
read its constants."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

WORLD = 4
# SMOKE's 8 patch rows in 24 positions: at (1, 4) chunks of 6, so rank 0
# takes 6 rows, rank 1 two and the last two ranks none; at (2, 2) chunks
# of 12, so a model rank's first 8 rows and the other's none
BATCH, SEQ = 2, 24
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def inputs(vocab: int, tokens: int, width: int, seed: int = 9):
    """tokens and labels (B, SEQ) int32, patch_embeds (B, tokens, width)
    float32."""
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "patch_embeds": rng.randn(BATCH, tokens,
                                      width).astype(np.float32)}


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import pixtral_12b as JP
    from repro.models import lm
    from repro.parallel.partition import make_sharder, param_pspecs

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfg, plan = JP.SMOKE, JP.SPEC.plan
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, "params.npz")))))
    raw = {k: jnp.asarray(v) for k, v in
           np.load(os.path.join(work, "inputs.npz")).items()}
    extra = {"patch_embeds": raw["patch_embeds"]}
    out = {}
    for name, shape in MESHES.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        sh = make_sharder(mesh, plan, schedule=lm.dsp_schedule(
            cfg, shape[1], seq=SEQ, batch=BATCH, joint=True))
        specs = param_pspecs(params, plan, axis_sizes=dict(mesh.shape))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params, specs)

        def loss(p, s=sh):
            x, _ = lm.forward(p, raw["tokens"], cfg, sharder=s,
                              backend="ref", remat=False, extra=extra)
            return lm.chunked_xent(x, p["unembed"]["table"], raw["labels"],
                                   cfg, sharder=s), x
        (value, x), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(placed)
        out[f"{name}/out"] = np.asarray(x)
        out[f"{name}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
