"""The JAX package's side of the port's ``tp`` checks, on 4 simulated CPU
devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_tp_jax.py <dir>

Reads ``dir/params.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_tp.py``) and writes ``dir/jax.npz``:

* for each mesh of ``MESHES``, under ``ParallelPlan(mode="tp",
  zero=True)`` with the parameters placed by JAX's own ``param_pspecs``:
  one jitted ``value_and_grad`` of ``forward`` and ``chunked_xent``
  (``backend="ref"``, ``remat=False``): the global forward output, the
  loss and every gradient leaf;
* ``ServingEngine(mesh=SERVE_MESH, plan=ParallelPlan(mode="tp"))`` with
  the config's ``cache_dtype`` float8_e4m3fn: the prefill's logits, one
  decode step's logits, and ``generate``'s tokens;
* the engine on one device with the fp8 cache: the continuous and the
  paged schedulers' tokens over ``requests``.  (JAX's static path keeps
  the prefill's K/V in the activation dtype; the pools hold fp8.)

The jitted steps compile once each.  This module imports no JAX at the
top: the gloo workers and the test read its constants and ``configs``
from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

WORLD = 4
# (data, model) meshes: at (1, 4) the 2 K/V heads do not divide the ranks
# (``wk``/``wv`` read whole), at (2, 2) they do
MESHES = ((1, 4), (2, 2))
SERVE_MESH = (1, 4)
BATCH, SEQ = 2, 32
# serving: prompts (SERVE_BATCH, PROMPT + 1), the last token decoded
SERVE_BATCH, PROMPT, MAX_LEN, NEW = 2, 12, 32, 8
# the schedulers' runs: request i prompts row i % SERVE_BATCH with budget
# CONT_BUDGETS[i], on 2 slots; paged in BLOCK-token blocks (2 positions of
# a block a rank at n = 4) and CHUNK-token prefill slices
CONT_BUDGETS = (8, 3, 6, 8)
BLOCK, CHUNK = 8, 8


def configs(mod):
    """mistral-large-123b's SMOKE config from the package ``mod``
    (``repro`` or ``repro_torch``), and the same with its KV cache in
    float8_e4m3fn (``fp8``), as the full config stores it."""
    import dataclasses
    import importlib
    conf = importlib.import_module(f"{mod}.configs.mistral_large_123b")
    if mod == "repro":
        import jax.numpy as jnp
        fp8 = jnp.float8_e4m3fn
    else:
        import torch
        fp8 = torch.float8_e4m3fn
    return {"plain": conf.SMOKE,
            "fp8": dataclasses.replace(conf.SMOKE, cache_dtype=fp8)}


def requests(prompts, request):
    """The schedulers' requests over ``prompts`` (SERVE_BATCH, >= PROMPT),
    made by ``request`` (either package's ``Request``)."""
    return [request(prompt=prompts[i % SERVE_BATCH, :PROMPT],
                    max_new_tokens=m, request_id=i)
            for i, m in enumerate(CONT_BUDGETS)]


def label(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.models import lm
    from repro.parallel.partition import (ParallelPlan, make_sharder,
                                          param_pspecs)
    from repro.serving.engine import Request, ServingEngine

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    cfgs = configs("repro")
    cfg = cfgs["plain"]
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, "params.npz")))))
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    batch = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
    plan = ParallelPlan(mode="tp", zero=True)
    out = {}
    for shape in MESHES:
        mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
        sh = make_sharder(mesh, plan)
        specs = param_pspecs(params, plan, axis_sizes=dict(mesh.shape))
        placed = jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params,
            specs)

        def loss(p, s=sh):
            x, _ = lm.forward(p, batch["tokens"], cfg, sharder=s,
                              backend="ref", remat=False)
            return lm.chunked_xent(x, p["unembed"]["table"], batch["labels"],
                                   cfg, sharder=s), x

        (value, x), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(placed)
        key = label(shape)
        out[f"{key}/out"] = np.asarray(x)
        out[f"{key}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{key}/grad/{path}"] = np.asarray(g)

    prompts = jnp.asarray(raw["prompts"])
    mesh = Mesh(np.array(jax.devices()).reshape(SERVE_MESH),
                ("data", "model"))
    eng = ServingEngine(params, cfgs["fp8"], max_len=MAX_LEN, mesh=mesh,
                        plan=ParallelPlan(mode="tp"))
    logits, caches = eng._prefill(prompts[:, :PROMPT])
    out["serve/prefill"] = np.asarray(logits)
    logits, _ = eng._decode(prompts[:, PROMPT:PROMPT + 1], caches)
    out["serve/decode"] = np.asarray(logits)
    out["serve/generate"] = np.asarray(eng.generate(prompts[:, :PROMPT],
                                                    NEW))
    alone = ServingEngine(params, cfgs["fp8"], max_len=MAX_LEN)
    for kind, kw in (("continuous", dict(continuous=True)),
                     ("paged", dict(paged=True, block_size=BLOCK,
                                    prefill_chunk=CHUNK))):
        reqs = requests(prompts, Request)
        alone.serve(reqs, max_batch=2, **kw)
        for r in reqs:
            out[f"serve/{kind}/{r.request_id}"] = np.array(r.generated)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
