"""The JAX package's side of the port's MoE-serving-on-a-mesh checks, on 4
simulated CPU devices.

    XLA_FLAGS="$JAX_XLA_FLAGS" python tests/_torch_moe_serve_jax.py <dir>

(``_torch_moe_tp_jax.JAX_XLA_FLAGS``: 4 simulated devices.)

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_moe_serving_dsp.py``) and writes ``dir/jax.npz``: for
each config of ``_torch_moe_tp_jax.configs`` and each plan of ``PLANS``,
JAX's ``ServingEngine(mesh=MESH, plan=)``: the prefill's last-position
logits, one decode step's logits and the greedy tokens through its steps
(``greedy``).  Each engine's prefill and decode compile once.

This module imports no JAX at the top: the gloo workers and the test read
its constants from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import unflatten  # noqa: E402
from _torch_moe_tp_jax import configs  # noqa: E402

WORLD = 4
MESH = (1, 4)
# prompts (BATCH, PROMPT + 1): prefill PROMPT tokens, decode the last one
BATCH, PROMPT, MAX_LEN, NEW = 2, 12, 32, 6
# plan name -> (mode, ep), each with ZeRO and the vocab split on
PLANS = {"dsp": ("dsp", False), "dsp_ep": ("dsp", True),
         "tp": ("tp", False), "tp_ep": ("tp", True)}
# the schedulers' runs: request i prompts row i % BATCH with budget
# CONT_BUDGETS[i], on 2 slots; paged in BLOCK-token blocks and
# CHUNK-token prefill slices
CONT_BUDGETS = (8, 3, 6, 8)
BLOCK, CHUNK = 8, 8
SHORT = 13                    # a prompt length the 4 ranks do not divide
# the router bias of the short-prompt checks: expert 0 wins most tokens,
# so a 13-token prompt passes its capacity, and a capacity taken from the
# padded 16 would keep one pair more
ROUTER_BIAS = 1.2


def biased(tree):
    """A copy of a parameter tree (numpy) with a router bias ``b`` on
    every MoE layer (a leaf both packages' linears read) favouring expert
    0 by ``ROUTER_BIAS``."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
    out["periods"] = {}
    for key, layer in tree["periods"].items():
        layer = dict(layer)
        if "moe" in layer:
            moe = dict(layer["moe"])
            w = moe["router"]["w"]
            b = np.zeros((w.shape[0], w.shape[2]), np.float32)
            b[:, 0] = ROUTER_BIAS
            moe["router"] = {**moe["router"], "b": b}
            layer["moe"] = moe
        out["periods"][key] = layer
    return out


def greedy(eng, logits, caches):
    """``generate``'s tokens through the engine's own jitted steps: the
    greedy token of each row (``argmax``, ties to the lowest id, as
    ``jnp.argmax``) fed back NEW - 1 times from the prefill's ``logits``
    and ``caches`` (``generate`` adds eager ops on the sharded logits,
    each a compile of its own)."""
    import jax.numpy as jnp
    out = []
    for t in range(NEW):
        token = np.argmax(np.asarray(logits)[:, -1], axis=-1).astype(
            np.int32)[:, None]
        out.append(token[:, 0])
        if t + 1 < NEW:
            logits, caches = eng._decode(jnp.asarray(token), caches)
    return np.stack(out, axis=1)


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.parallel.partition import ParallelPlan
    from repro.serving.engine import ServingEngine

    work = sys.argv[1]
    assert len(jax.devices()) == WORLD, jax.devices()
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    prompts = jnp.asarray(raw["prompts"])
    mesh = Mesh(np.array(jax.devices()).reshape(MESH), ("data", "model"))
    out = {}
    for cname, cfg in configs("repro").items():
        params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
            np.load(os.path.join(work, f"params_{cname}.npz")))))
        for pname, (mode, ep) in PLANS.items():
            eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh,
                                plan=ParallelPlan(mode=mode, ep=ep))
            logits, caches = eng._prefill(prompts[:, :PROMPT])
            key = f"{cname}/{pname}"
            out[f"{key}/prefill"] = first = np.asarray(logits)
            logits, _ = eng._decode(prompts[:, PROMPT:PROMPT + 1], caches)
            out[f"{key}/decode"] = np.asarray(logits)
            out[f"{key}/generate"] = greedy(eng, first, caches)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
