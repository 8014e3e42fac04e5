"""The JAX package's side of the port's sharded paged-serving checks, on 8
simulated CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_paged_jax.py <dir>

Reads ``dir/params.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_paged_dsp.py``) and writes ``dir/jax.npz``: on a (1, 4)
mesh of the first 4 devices and without a mesh, JAX's ``ServingEngine``
under ``ParallelPlan(mode="dsp")`` with a ``BlockPool`` of ``SLOTS`` slots
(``POOL_CASE``: the chunks of two prompts, then one decode step, each
step's logits), the pool's ``cache_pspecs(paged=True)``, and the
unsharded engine's static ``generate`` of the trace's requests
(``trace_prompts``) at their budgets.

This module imports no JAX at the top: the gloo workers and the test read
its constants from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

SP = 4                          # the (1, SP) mesh of the checks
SLOTS, MAX_LEN, BLOCK = 2, 32, 8
# the pool case: prompt lengths, each one's chunk widths, then one decode
# step of both slots
POOL_PROMPTS = (12, 5)
POOL_CHUNKS = ((8, 4), (5,))
# the trace: a shared SHARED-token prompt prefix (2 blocks), suffixes of
# these lengths, these budgets, 2 slots, chunks of TRACE_CHUNK tokens
SHARED, SUFFIXES, BUDGETS, TRACE_CHUNK = 16, (4, 9, 6, 3), (8, 3, 6, 8), 8


def config(lm, dtype):
    """``tests/_torch_serve_jax.py``'s ``attn``: GQA 8/2, fewer K/V heads
    than ranks."""
    return lm.LMConfig(name="attn", n_layers=2, d_model=64, n_heads=8,
                       n_kv_heads=2, head_dim=16, d_ff=128, vocab=96,
                       dtype=dtype)


def trace_prompts(raw) -> list:
    """The trace's prompts: the shared prefix, then each suffix."""
    shared = raw["shared"]
    return [np.concatenate([shared, raw[f"suffix{i}"]])
            for i in range(len(SUFFIXES))]


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core.topology import Topology
    from repro.models import lm
    from repro.parallel.partition import ParallelPlan, cache_pspecs
    from repro.serving.block_pool import BlockPool
    from repro.serving.engine import ServingEngine

    work = sys.argv[1]
    assert len(jax.devices()) == 8, jax.devices()
    cfg = config(lm, jnp.float32)
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    params = jax.tree_util.tree_map(jnp.asarray, unflatten(dict(np.load(
        os.path.join(work, "params.npz")))))
    out = {}
    plan = ParallelPlan(mode="dsp")
    for label, mesh in (("none", None), ("1x4", Mesh(np.array(
            jax.devices()[:SP]).reshape(1, SP), ("data", "model")))):
        if mesh is None:
            eng = ServingEngine(params, cfg, max_len=MAX_LEN)
        else:
            eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh,
                                plan=plan, topology=Topology.uniform(SP))
        pool = BlockPool(cfg, SLOTS, MAX_LEN, block_size=BLOCK, mesh=mesh,
                         plan=eng.plan)
        if mesh is not None:
            specs = cache_pspecs(pool.caches, eng.plan, paged=True)
            for path, spec in flatten(specs).items():
                out[f"spec/{path}"] = np.array([str(e) for e in tuple(spec)])
        last = []
        for i, (n, widths) in enumerate(zip(POOL_PROMPTS, POOL_CHUNKS)):
            prompt = jnp.asarray(raw["pool_prompts"][i, :n])
            blocks = pool.alloc_blocks(pool.blocks_for(n + 4))
            slot = pool.bind(blocks, 0)
            done = 0
            for j, c in enumerate(widths):
                logits, pool.caches = eng._chunk(
                    prompt[None, done:done + c], pool.caches,
                    jnp.asarray(slot, jnp.int32))
                out[f"{label}/chunk{i}.{j}"] = np.asarray(logits)
                done += c
            last.append(int(raw["pool_next"][i]))
        logits, pool.caches = eng._decode(jnp.asarray(last)[:, None],
                                          pool.caches)
        out[f"{label}/decode"] = np.asarray(logits)
        if mesh is None:
            for i, p in enumerate(trace_prompts(raw)):
                out[f"static{i}"] = np.asarray(eng.generate(
                    jnp.asarray(p)[None], BUDGETS[i]))[0]
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
