"""The JAX package's side of the port's sharded-serving checks, on 8
simulated CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_serve_jax.py <dir>

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_serving_dsp.py``) and writes ``dir/jax.npz``: for each
config of ``configs`` and each mesh of ``MESHES`` (the first devices),
JAX's ``ServingEngine(mesh=, plan=ParallelPlan(mode="dsp"),
topology=Topology.uniform(sp))``: the prefill's last-position logits,
one decode step's logits, ``generate`` with ragged budgets and an EOS,
the prefill cache's ``cache_pspecs`` and the engine's schedule; and the
same from the engine without a mesh, with the static references of the
continuous runs and of the short prompts (where JAX's engine raises on
one, a fault of the reference that ROADMAP §3 records, that it raised).

This module imports no JAX at the top: the gloo workers and the test read
its constants and ``configs`` from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_jax import configs as lmdsp_configs  # noqa: E402

# (data, model) meshes of the sharded checks, each on 4 ranks
MESHES = ((1, 4), (2, 2))
# prompts (BATCH, SEQ + 1): prefill SEQ tokens, decode the last one
BATCH, SEQ, MAX_LEN = 4, 12, 32
BUDGETS = (6, 3, 5, 6)                 # the static runs, with an EOS
CONT_BUDGETS = (8, 3, 6, 8)            # the continuous runs (2 slots)
SHORT = (13, 2)                        # prompt lengths 4 ranks do not divide
SHORT_NEW = 6


def configs(lm, ssm, dtype):
    """``attn``: ``tests/md_scenarios.py``'s ``decode_sharded`` config with
    2 K/V heads (fewer than 4 ranks); ``hybrid``: the attention/SSM config
    of ``tests/test_torch_lm_dsp.py``."""
    return {
        "attn": lm.LMConfig(
            name="attn", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
            head_dim=16, d_ff=128, vocab=96, dtype=dtype),
        "hybrid": lmdsp_configs(lm, ssm, dtype)["hybrid"],
    }


def label(shape) -> str:
    return "none" if shape is None else f"{shape[0]}x{shape[1]}"


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core.topology import Topology
    from repro.models import lm, ssm
    from repro.parallel.partition import ParallelPlan, cache_pspecs
    from repro.serving.engine import ServingEngine

    work = sys.argv[1]
    assert len(jax.devices()) == 8, jax.devices()
    cfgs = configs(lm, ssm, jnp.float32)
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    prompts = jnp.asarray(raw["prompts"])
    out = {}
    for cname, cfg in cfgs.items():
        params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(np.load(
            os.path.join(work, f"params_{cname}.npz")))))
        eos = int(raw[f"{cname}/eos"])
        for shape in (None,) + MESHES:
            key = f"{cname}/{label(shape)}"
            if shape is None:
                eng = ServingEngine(params, cfg, max_len=MAX_LEN)
            else:
                mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                            .reshape(shape), ("data", "model"))
                eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh,
                                    plan=ParallelPlan(mode="dsp"),
                                    topology=Topology.uniform(shape[1]))
                out[f"{key}/schedule"] = np.array(eng.schedule.dims)
            logits, caches = eng._prefill(prompts[:, :SEQ])
            out[f"{key}/prefill"] = np.asarray(logits)
            if shape is not None:
                specs = cache_pspecs(caches["periods"], eng.plan)
                for path, spec in flatten(specs).items():
                    out[f"{key}/cache_spec/{path}"] = np.array(
                        [str(e) for e in tuple(spec)])
            logits, _ = eng._decode(prompts[:, SEQ:SEQ + 1], caches)
            out[f"{key}/decode"] = np.asarray(logits)
            out[f"{key}/generate"] = np.asarray(eng.generate(
                prompts[:, :SEQ], list(BUDGETS), eos_id=eos, pad_id=-1))
            if shape is None:
                out[f"{key}/static"] = np.asarray(eng.generate(
                    prompts[:, :SEQ], max(CONT_BUDGETS)))
                for n in SHORT:
                    try:
                        out[f"{key}/short{n}"] = np.asarray(eng.generate(
                            prompts[:2, :n], SHORT_NEW))
                    except ValueError:
                        # a prompt shorter than an SSM layer's d_conv - 1
                        # (a fault of the reference, ROADMAP §3)
                        out[f"{key}/short{n}/raised"] = np.array(True)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
