"""The JAX package's side of the port's enc-dec serving on a mesh
(``tests/test_torch_encdec_serving_dsp.py``), on 4 simulated CPU
devices.

    XLA_FLAGS="$JAX_XLA_FLAGS" python tests/_torch_encdec_serve_jax.py <dir>

Reads ``dir/params.npz`` and ``dir/inputs.npz`` and writes
``dir/jax.npz``: on each mesh of ``JAX_MESHES``, under seamless's plan
(``ParallelPlan(mode="dsp", zero=True)``) with the parameters placed by
JAX's ``param_pspecs`` and the batch by ``build_encdec_cell``'s specs,
one jitted ``prefill(sharder=)`` and ``STEPS`` jitted
``decode_step(sharder=)``s on the forced tokens: each step's logits and
the caches after the prefill and after the last step.  JAX's prefill
returns self-attention caches of exactly the prompt's length, whose
first decode write would clamp onto the prompt's last row (ROADMAP §3),
so they are padded here with numpy to ``MAX_LEN`` first.  It also
records that JAX cannot place a batch whose frame count the model ranks
do not divide.

JAX's values do not depend on the plan's ``zero``: the port's runs with
ZeRO and without are both held against the one run a mesh.  This module
imports no JAX at the top: the gloo workers and the tests read its
constants."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_encdec_jax import CONFIG_KW  # noqa: E402

WORLD = 4
# the SMOKE shape with a vocab that 2 divides and 4 does not: at (1, 4)
# the table stays whole, at (2, 2) the logits are vocab-sharded
CONFIG = "mesh"
BATCH, S_ENC, S_DEC, STEPS = 2, 32, 16, 3
MAX_LEN = S_DEC + STEPS + 1
# a frame count that 4 model ranks do not divide
UNEVEN_ENC = 30
JAX_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# scenario -> ((data, model) mesh, zero)
SCENARIOS = {f"{m}/{'zero' if z else 'whole'}": (shape, z)
             for m, shape in JAX_MESHES.items() for z in (True, False)}


def inputs(seed=5):
    """feats (B, S_enc, F) float32, the prompt (B, S_dec) and the forced
    decode tokens (B, STEPS), int32."""
    kw = CONFIG_KW[CONFIG]
    rng = np.random.RandomState(seed)
    return {"feats": rng.randn(BATCH, S_ENC,
                               kw["frontend_dim"]).astype(np.float32),
            "tokens": rng.randint(0, kw["vocab"],
                                  (BATCH, S_DEC)).astype(np.int32),
            "forced": rng.randint(0, kw["vocab"],
                                  (BATCH, STEPS)).astype(np.int32)}


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.models import encdec as JE
    from repro.parallel.partition import (ParallelPlan, cache_pspecs,
                                          make_sharder, param_pspecs)

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    plan = ParallelPlan(mode="dsp", zero=True)
    cfg = JE.EncDecConfig(**CONFIG_KW[CONFIG], dtype=jnp.float32)
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, "params.npz")))))
    out = {}
    for label, shape in JAX_MESHES.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))

        def put(tree, specs):
            return jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                tree, specs)
        specs = param_pspecs(params, plan, axis_sizes=dict(mesh.shape),
                             stacked_prefixes=("enc_periods", "dec_periods"))
        placed = put(params, specs)
        batch = put({k: jnp.asarray(raw[k]) for k in ("feats", "tokens")},
                    {"feats": P("data", "model", None),
                     "tokens": P("data", "model")})
        sharder = make_sharder(mesh, plan)
        logits, caches = jax.jit(lambda p, b: JE.prefill(
            p, b, cfg, sharder=sharder, backend="ref", remat=False))(
                placed, batch)
        out[f"{label}/prefill/logits"] = np.asarray(logits)
        caches = jax.tree_util.tree_map(np.asarray, caches)
        pad = [(0, 0)] * 3 + [(0, MAX_LEN - S_DEC), (0, 0)]
        caches["periods"]["kv"] = {k: np.pad(v, pad) for k, v in
                                   caches["periods"]["kv"].items()}
        for path, v in flatten(caches["periods"]).items():
            out[f"{label}/prefill/{path}"] = v
        caches = put(jax.tree_util.tree_map(jnp.asarray, caches),
                     cache_pspecs(caches, plan))
        step = jax.jit(lambda p, t, c: JE.decode_step(
            p, t, c, cfg, sharder=sharder, backend="ref"))
        for i in range(STEPS):
            tok = jax.device_put(jnp.asarray(raw["forced"][:, i:i + 1]),
                                 NamedSharding(mesh, P("data", None)))
            logits, caches = step(placed, tok, caches)
            out[f"{label}/step{i}/logits"] = np.asarray(logits)
        for path, v in flatten(caches["periods"]).items():
            out[f"{label}/last/{path}"] = np.asarray(v)
    mesh = Mesh(np.array(jax.devices()).reshape(1, WORLD), ("data", "model"))
    try:
        jax.device_put(np.zeros((BATCH, UNEVEN_ENC, 4), np.float32),
                       NamedSharding(mesh, P("data", "model", None)))
        out["uneven/raises"] = np.array(0)
    except ValueError:
        out["uneven/raises"] = np.array(1)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
