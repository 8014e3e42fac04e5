"""The JAX package's side of the port's MoE-on-a-mesh checks
(``tests/test_torch_moe_ep.py``): the configs, the scenarios, and JAX's
forward with the dropped share of each MoE call.

JAX's semantics are global, so its reference is the forward on one
device (``tests/md_scenarios.py``'s ``lm_parallel_equivalence`` holds
its meshed forward within 2e-3 of that).  This module imports no JAX at
the top: the gloo workers read ``configs`` and ``SCENARIOS`` from it."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# scenario -> (config, (data, model) mesh, plan: (ep, zero))
SCENARIOS = {
    "hybrid/1x4/ep_zero": ("hybrid", (1, 4), (True, True)),
    "hybrid/2x2/ep_zero": ("hybrid", (2, 2), (True, True)),
    "hybrid/1x4/zero": ("hybrid", (1, 4), (False, True)),
    "hybrid/2x2/zero": ("hybrid", (2, 2), (False, True)),
    "biased/1x4/ep_zero": ("biased", (1, 4), (True, True)),
    "biased/2x2/ep": ("biased", (2, 2), (True, False)),
    "biased/1x4/zero": ("biased", (1, 4), (False, True)),
}
BATCH, SEQ = 2, 32
# the router bias of the ``biased`` config: expert 0 wins most tokens, so
# its pairs pass the capacity inside some rank's sequence chunk
ROUTER_BIAS = 1.2


def configs(lm, ssm, dtype):
    """``hybrid`` is ``tests/md_scenarios.py``'s
    ``lm_parallel_equivalence`` config (an SSM period of 4, attention at
    1, MoE at 1 and 3 with 4 experts top-2; GQA 4/2, 4 B/C groups), whose
    capacity of 2 x S x 2 / 4 pairs an expert never drops; ``biased`` two
    attention layers of MoE with 6 experts padded to 8, top-2, a shared
    expert and the router biased (``ROUTER_BIAS``), so the capacity of S
    / 2 pairs drops."""
    sc = ssm.SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=32,
                       n_groups=4, chunk=16)
    return {
        "hybrid": lm.LMConfig(
            name="t", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
            head_dim=16, d_ff=96, vocab=128, ssm_every=4, ssm_attn_offset=1,
            n_experts=4, top_k=2, moe_every=2, moe_offset=1, ssm_cfg=sc,
            dtype=dtype),
        "biased": lm.LMConfig(
            name="biased", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            head_dim=16, d_ff=48, vocab=128, n_experts=6, top_k=2,
            n_shared=1, shared_ff=96, ep_pad=8, norm_topk=False,
            dtype=dtype),
    }


def params_np(name: str):
    """The config's JAX init (seed 0) as numpy; ``biased`` gains a router
    bias on every MoE layer (a ``b`` leaf both packages' linears read)."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as JL
    from repro.models import ssm as JS
    cfg = configs(JL, JS, jnp.float32)[name]
    tree = jax.tree_util.tree_map(np.asarray,
                                  JL.init_lm(jax.random.PRNGKey(0), cfg))
    if name == "biased":
        for layer in tree["periods"].values():
            if "moe" in layer:
                w = layer["moe"]["router"]["w"]
                b = np.zeros((w.shape[0], w.shape[2]), np.float32)
                b[:, 0] = ROUTER_BIAS
                layer["moe"]["router"]["b"] = b
    return tree


def tokens():
    return np.random.RandomState(5).randint(0, 128, (BATCH, SEQ))


def jax_forward(name: str, params, toks):
    """JAX's ``forward`` (``backend="ref"``, no remat) on one device, and
    the dropped share of each MoE call in order, read eagerly: the period
    loop unrolled (``flags.flat_cost_mode``) and ``models.moe.moe``
    wrapped in this process only."""
    import jax
    import jax.numpy as jnp
    from repro.models import flags
    from repro.models import lm as JL
    from repro.models import moe as JM
    from repro.models import ssm as JS
    cfg = configs(JL, JS, jnp.float32)[name]
    dropped = []
    inner = JM.moe

    def moe(*args, **kw):
        y, aux = inner(*args, **kw)
        dropped.append(float(aux["dropped"]))
        return y, aux
    JM.moe = moe
    try:
        with flags.flat_cost_mode():
            x, aux = JL.forward(jax.tree_util.tree_map(jnp.asarray, params),
                                jnp.asarray(toks), cfg, backend="ref",
                                remat=False)
    finally:
        JM.moe = inner
    return np.asarray(x), float(aux["moe_load_balance"]), dropped
