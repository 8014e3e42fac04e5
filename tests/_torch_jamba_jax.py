"""The JAX package's side of the port's jamba-1.5-large-398b checks on a
mesh (``tests/test_torch_jamba_dsp.py``), on 4 simulated CPU devices.

    XLA_FLAGS="$JAX_XLA_FLAGS" python tests/_torch_jamba_jax.py <dir>

Reads ``dir/params.npz`` (jamba's SMOKE config, JAX's init) and
``dir/inputs.npz`` and writes ``dir/jax.npz``, on each mesh of
``MESHES``:

* training under the spec's plan (``TRAIN_PLAN``: ``dsp`` + ``ep`` +
  ZeRO-3) and the joint ``dsp_schedule``, with the parameters placed by
  JAX's own ``param_pspecs``: one jitted ``value_and_grad`` of
  ``forward`` and the chunked cross-entropy (``backend="ref"``,
  ``remat=False``): the global forward output, the loss and every
  gradient leaf;
* serving under ``SERVE_PLAN`` (``dsp`` + ``ep``, ZeRO off: JAX's
  serving rule drops ZeRO for decode): ``ServingEngine(mesh=, plan=)``'s
  prefill logits, one decode step's logits and the greedy tokens through
  its own jitted steps (``_torch_moe_serve_jax.greedy``).

This module imports no JAX at the top: the gloo workers and the test read
its constants from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

WORLD = 4
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# training: (B, S); at (1, 4) chunks of 8 rows, at (2, 2) of 16 (one SSD
# chunk of the SMOKE config)
BATCH, SEQ = 2, 32
# serving: prompts (BATCH, PROMPT + 1), prefill PROMPT tokens (3 rows a
# rank at (1, 4): the conv halo's d_conv - 1), decode the last one
PROMPT, MAX_LEN, NEW = 12, 32, 6
# (mode, ep, zero) of the two plans
TRAIN_PLAN = ("dsp", True, True)
SERVE_PLAN = ("dsp", True, False)


def inputs(vocab: int, seed: int = 11):
    """tokens and labels (BATCH, SEQ), prompts (BATCH, PROMPT + 1), int32."""
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, vocab, shape).astype(np.int32)
            for k, shape in (("tokens", (BATCH, SEQ)),
                             ("labels", (BATCH, SEQ)),
                             ("prompts", (BATCH, PROMPT + 1)))}


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import jamba_1_5_large_398b as JJ
    from repro.models import lm
    from repro.parallel.partition import (ParallelPlan, make_sharder,
                                          param_pspecs)
    from repro.serving.engine import ServingEngine
    from _torch_moe_serve_jax import greedy

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfg = JJ.SMOKE
    train_plan, serve_plan = (ParallelPlan(mode=m, ep=e, zero=z)
                              for m, e, z in (TRAIN_PLAN, SERVE_PLAN))
    assert train_plan == JJ.SPEC.plan
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, "params.npz")))))
    raw = {k: jnp.asarray(v) for k, v in
           np.load(os.path.join(work, "inputs.npz")).items()}
    out = {}
    for name, shape in MESHES.items():
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        sh = make_sharder(mesh, train_plan, schedule=lm.dsp_schedule(
            cfg, shape[1], seq=SEQ, batch=BATCH, joint=True))
        specs = param_pspecs(params, train_plan, axis_sizes=dict(mesh.shape))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params, specs)

        def loss(p, s=sh):
            x, _ = lm.forward(p, raw["tokens"], cfg, sharder=s,
                              backend="ref", remat=False)
            return lm.chunked_xent(x, p["unembed"]["table"], raw["labels"],
                                   cfg, sharder=s), x
        (value, x), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(placed)
        out[f"{name}/out"] = np.asarray(x)
        out[f"{name}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)

        eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh,
                            plan=serve_plan)
        logits, caches = eng._prefill(raw["prompts"][:, :PROMPT])
        out[f"{name}/prefill"] = first = np.asarray(logits)
        logits, _ = eng._decode(raw["prompts"][:, PROMPT:PROMPT + 1], caches)
        out[f"{name}/decode"] = np.asarray(logits)
        out[f"{name}/generate"] = greedy(eng, first, caches)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
