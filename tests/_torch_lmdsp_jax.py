"""The JAX package's side of the port's LM-under-DSP checks, on 8 simulated
CPU devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_lmdsp_jax.py <dir>

Reads ``dir/params_<config>.npz`` and ``dir/inputs.npz`` (written by
``tests/test_torch_lm_dsp.py``) and writes ``dir/jax.npz``: for each
scenario of ``SCENARIOS``, ``forward`` on its ``("data", "model")`` mesh
under ``ParallelPlan(mode="dsp", zero=False, shard_vocab=False)`` and the
joint ``dsp_schedule`` (global output, and the collectives of its
compiled HLO by kind), and at ``GRAD_MESHES`` ``lm_loss`` with its
gradient; ``backend="ref"``, ``remat=False``.

This module imports no JAX at the top: the gloo workers and the test read
``configs`` and ``SCENARIOS`` from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

# scenario -> (config, (data, model) mesh, fused_switch)
SCENARIOS = {
    "hybrid/1x4": ("hybrid", (1, 4), True),
    "hybrid/2x4": ("hybrid", (2, 4), True),
    "hybrid/4x2": ("hybrid", (4, 2), True),
    "hybrid/1x4/unfused": ("hybrid", (1, 4), False),
    "mha/1x4": ("mha", (1, 4), True),
    "mha/2x4": ("mha", (2, 4), True),
    "kvg/1x4": ("kvg", (1, 4), True),
    "kvg/2x4": ("kvg", (2, 4), True),
}
# the meshes JAX's loss and gradient are taken at, per config
GRAD_MESHES = ((1, 4), (2, 4))
HLO_KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
             "collective-permute")
BATCH, SEQ, VOCAB = 4, 32, 64


def inputs():
    """The checks' tokens and labels, (BATCH, SEQ) int32 from seed 3."""
    import numpy as np
    rng = np.random.RandomState(3)
    return {k: rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def configs(lm, ssm, dtype):
    """The checks' configs, from package ``lm``'s LMConfig and ``ssm``'s
    SSMConfig: ``hybrid`` is ``tests/md_scenarios.py``'s
    ``lm_parallel_equivalence`` config without its MoE layers (an SSM
    period of 4 with attention at 1, GQA 4/2, 4 B/C groups), ``mha``
    ``tests/_hlo_worker.py``'s LM (8/8 heads), and ``kvg`` 6 q and 2 K/V
    heads with qk-norm, which do not divide 4 (the kv-gather layout)."""
    sc = ssm.SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=32,
                       n_groups=4, chunk=16)
    return {
        "hybrid": lm.LMConfig(
            name="hybrid", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=96, vocab=128, ssm_every=4, ssm_attn_offset=1,
            ssm_cfg=sc, dtype=dtype),
        "mha": lm.LMConfig(
            name="hlo", n_layers=4, d_model=64, n_heads=8, n_kv_heads=8,
            head_dim=8, d_ff=128, vocab=64, dtype=dtype),
        "kvg": lm.LMConfig(
            name="kvg", n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
            head_dim=8, d_ff=96, vocab=64, qk_norm=True, dtype=dtype),
    }


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.analysis.roofline import parse_collectives
    from repro.models import lm, ssm
    from repro.parallel.partition import ParallelPlan, make_sharder

    work = sys.argv[1]
    assert len(jax.devices()) == 8, jax.devices()
    cfgs = configs(lm, ssm, jnp.float32)
    params = {name: jax.tree_util.tree_map(jnp.asarray, unflatten(dict(
        np.load(os.path.join(work, f"params_{name}.npz"))))) for name in cfgs}
    raw = dict(np.load(os.path.join(work, "inputs.npz")))
    batch = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
    plan = ParallelPlan(mode="dsp", shard_vocab=False, zero=False)
    out = {}

    def sharder_on(cname, shape):
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(
            shape), ("data", "model"))
        sched = lm.dsp_schedule(cfgs[cname], shape[1], seq=SEQ, batch=BATCH,
                                joint=True)
        return make_sharder(mesh, plan, schedule=sched)

    for name, (cname, shape, fused) in SCENARIOS.items():
        cfg, sh = cfgs[cname], sharder_on(cname, shape)
        fn = jax.jit(lambda p, t, c=cfg, s=sh, f=fused: lm.forward(
            p, t, c, sharder=s, backend="ref", remat=False,
            fused_switch=f)[0]).lower(params[cname], batch["tokens"]).compile()
        out[f"{name}/out"] = np.asarray(fn(params[cname], batch["tokens"]))
        counts = parse_collectives(fn.as_text()).by_kind_count
        out[f"{name}/hlo"] = np.array([int(counts.get(k, 0))
                                       for k in HLO_KINDS])
        if shape not in GRAD_MESHES or not fused:
            continue

        def loss(p, c=cfg, s=sh):
            return lm.lm_loss(p, batch, c, sharder=s, backend="ref",
                              remat=False)[0]

        value, grads = jax.jit(jax.value_and_grad(loss))(params[cname])
        out[f"{name}/loss"] = np.asarray(value)
        for path, g in flatten(grads).items():
            out[f"{name}/grad/{path}"] = np.asarray(g)
    np.savez(os.path.join(work, "jax.npz"), **out)


if __name__ == "__main__":
    main()
