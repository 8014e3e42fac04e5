"""The port's MoE (``repro_torch.models.moe``) and qwen2-moe-a2.7b's LM
path against the JAX package on the CPU: the MoE module under both
dispatch implementations (shared experts and their gate, padded experts,
``norm_topk`` on and off, a router biased so that pairs pass the
capacity and drop) with its aux stats and gradients; qwen2-moe's SMOKE
config (init tree, dtypes, ``param_counts``, ``lm_loss`` with the
load-balance aux and every gradient, two ``Trainer`` steps); and MoE
served on a mesh at a world of one.  JAX weights cross over through
``bridge.params_from_numpy``.  Tolerance 1e-4, as in
``test_torch_lm.py``: the same sums in another order."""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import qwen2_moe_a2_7b as jconf
from repro.models import lm as JLM
from repro.models import moe as JM
from repro.optim import adamw as JO
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.configs import qwen2_moe_a2_7b as tconf
from repro_torch.models import lm as TLM
from repro_torch.models import moe as TM
from repro_torch.optim import adamw as TO
from repro_torch.train.trainer import Trainer, TrainerConfig
from _torch_threads import one_thread  # noqa: E402,F401

TOL = 1e-4
JCFG, TCFG = jconf.SMOKE, tconf.SMOKE
D, FF, E, K, E_PHYS = 32, 24, 6, 2, 8


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _module(shared: int, dense, kind="silu_glu"):
    """JAX's MoE init at (d 32, f 24, 6 experts padded to 8, top-2) as
    numpy, with expert 0 favoured by a router bias and the inputs' first
    channel, so that its pairs pass the capacity."""
    tree = jax.tree_util.tree_map(np.asarray, JM.init_moe(
        jax.random.PRNGKey(0), D, FF, E, K, n_shared=shared, dense_ff=dense,
        kind=kind, pad_experts_to=E_PHYS))
    tree["router"]["b"] = np.zeros(E_PHYS, np.float32)
    tree["router"]["b"][0] = 1.0
    x = np.random.RandomState(1).standard_normal((2, 16, D))
    x[..., 0] += 2.0
    return tree, x.astype(np.float32)


def _metas(kind, shared, dense):
    kw = dict(n_experts=E, top_k=K, e_phys=E_PHYS, kind=kind,
              has_shared=shared > 0, has_dense=dense is not None)
    return JM.MoEArgs(**kw), TM.MoEArgs(**kw)


CASES = {f"{impl}/{'norm' if norm else 'raw'}/{extra}": (impl, norm, extra)
         for impl in ("gather", "einsum") for norm in (True, False)
         for extra in ("plain", "shared", "dense_gelu")}


def _extra(extra):
    return {"plain": (0, None, "silu_glu"), "shared": (2, None, "silu_glu"),
            "dense_gelu": (0, 40, "gelu_glu")}[extra]


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_jax(case):
    """Values and aux (load balance, dropped share) of both dispatches
    against JAX's, every case with drops (the same share in both)."""
    impl, norm, extra = CASES[case]
    shared, dense, kind = _extra(extra)
    tree, x = _module(shared, dense, kind)
    jmeta, tmeta = _metas(kind, shared, dense)
    jy, ja = JM.moe(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                    jmeta, impl=impl, norm_topk=norm)
    ty, ta = TM.moe(bridge.params_from_numpy(tree, device="cpu"),
                    torch.from_numpy(x), tmeta, impl=impl, norm_topk=norm)
    assert _rel(ty, jy) < TOL
    assert abs(float(ta["load_balance"]) - float(ja["load_balance"])) < \
        TOL * float(ja["load_balance"])
    assert float(ja["dropped"]) > 0
    assert float(ta["dropped"]) == pytest.approx(float(ja["dropped"]),
                                                 abs=1e-7)


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_moe_grads_match_jax(impl):
    """d/d(params, x) of sum(y * w) + the load-balance aux against
    ``jax.grad``, with drops and a shared expert."""
    tree, x = _module(2, None)
    jmeta, tmeta = _metas("silu_glu", 2, None)
    w = np.random.RandomState(2).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe(p, xx, jmeta, impl=impl)
        return jnp.sum(y * w) + aux["load_balance"]
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    tp = bridge.params_from_numpy(tree, device="cpu")
    leaves = TLM.tree_map(lambda a: a.requires_grad_(True), tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe(leaves, tx, tmeta, impl=impl)
    loss = torch.sum(y * torch.from_numpy(w)) + aux["load_balance"]
    grads = torch.autograd.grad(loss, TLM.tree_leaves(leaves) + [tx])
    flat = dict(zip(_paths(tp), grads[:-1]))
    for path, want in _paths_j(jg):
        assert _rel(flat[path], want) < TOL, path
    assert _rel(grads[-1], jgx) < TOL


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _paths_j(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths_j(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_combine_is_bitwise_repeatable():
    """Two runs of the gather dispatch, values and grads, agree bit for
    bit: the combine sums each token's k outputs in order, no atomics."""
    tree, x = _module(2, None)
    _, tmeta = _metas("silu_glu", 2, None)
    runs = []
    for _ in range(2):
        tp = TLM.tree_map(lambda a: a.requires_grad_(True),
                          bridge.params_from_numpy(tree, device="cpu"))
        y, _ = TM.moe(tp, torch.from_numpy(x), tmeta)
        g = torch.autograd.grad(y.square().sum(), TLM.tree_leaves(tp))
        runs.append([y] + list(g))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# qwen2-moe-a2.7b
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = JLM.init_lm(jax.random.PRNGKey(0), JCFG)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    return jp, tp


def _batch(seed, shape=(2, 24)):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, JCFG.vocab, shape),
            "labels": rng.randint(0, JCFG.vocab, shape)}


def test_configs_and_param_counts_match_jax():
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                  "d_ff", "vocab", "n_experts", "top_k", "n_shared",
                  "shared_ff", "norm_topk", "ep_pad", "attn_bias",
                  "tie_embeddings"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert TLM.param_counts(t) == JLM.param_counts(j)
    assert TLM.param_counts(tconf.CONFIG)["total"] == 14_312_538_112
    assert tconf.SPEC.plan == type(tconf.SPEC.plan)(mode="dsp", ep=True,
                                                    zero=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_and_dtypes_match_jax(dtype):
    """Same keys, shapes and dtypes as JAX's init, the router float32 in a
    bf16 model; ``params_from_numpy(dtype=)`` keeps it float32 too."""
    jcfg = dataclasses.replace(JCFG, dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(TCFG, dtype=getattr(torch, dtype))
    jp = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = TLM.init_lm(0, tcfg, device="cpu")
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), jnp.dtype(a.dtype).name), jp)
    got = TLM.tree_map(lambda a: (tuple(a.shape),
                                  str(a.dtype).split(".")[-1]), tp)
    assert got == want
    router = got["periods"]["0"]["moe"]["router"]["w"]
    assert router[1] == "float32"
    crossed = bridge.params_from_numpy(
        TLM.tree_map(lambda a: a.float().numpy(), tp), device="cpu",
        dtype=getattr(torch, dtype))
    assert crossed["periods"]["0"]["moe"]["router"]["w"].dtype == \
        torch.float32
    assert crossed["periods"]["0"]["moe"]["wi"].dtype == getattr(torch,
                                                                 dtype)


def test_lm_loss_aux_and_grads_match_jax(params):
    """``lm_loss``: the cross-entropy plus 0.01 x the load-balance aux
    over the layer count, its metrics, and every gradient, against
    JAX's (``backend="ref"``), with drops in the MoE layers."""
    jp, tp = params
    b = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JLM.lm_loss(p, jb, JCFG, backend="ref"), has_aux=True)(jp)
    leaves = TLM.tree_map(lambda a: a.detach().requires_grad_(True), tp)
    tl, tm = TLM.lm_loss(leaves, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, TCFG)
    grads = torch.autograd.grad(tl, TLM.tree_leaves(leaves))
    assert _rel(tl, jl) < TOL and _rel(tm["xent"], jm["xent"]) < TOL
    assert _rel(tm["moe_load_balance"], jm["moe_load_balance"]) < TOL
    assert float(tm["moe_dropped"]) > 0
    flat = dict(zip(_paths(tp), grads))
    for path, want in _paths_j(jg):
        assert _rel(flat[path], want) < TOL, path


def test_forward_aux_through_remat(params):
    """The aux is the same with the periods checkpointed or not."""
    _, tp = params
    tok = torch.from_numpy(_batch(2)["tokens"])
    with torch.no_grad():
        (x0, a0), (x1, a1) = (TLM.forward(tp, tok, TCFG, remat=r)
                              for r in (False, True))
    assert torch.equal(x0, x1)
    assert all(torch.equal(a0[k], a1[k]) for k in a0)


def test_trainer_steps_match_jax(params):
    """Two ``Trainer`` steps against JAX's (``apply_adamw``): the same
    loss at both."""
    jp, tp = params
    batches = [_batch(10 + s) for s in range(2)]
    kw = dict(peak_lr=3e-3, warmup_steps=1, total_steps=2)
    jt = JTrainer(loss_fn=lambda p, b: JLM.lm_loss(p, b, JCFG, backend="ref"),
                  params=jp, opt_cfg=JO.OptConfig(**kw),
                  cfg=JTrainerConfig(total_steps=2, log_every=1),
                  data_fn=lambda s: {k: jnp.asarray(v)
                                     for k, v in batches[s].items()})
    tt = Trainer(loss_fn=lambda p, b: TLM.lm_loss(p, b, TCFG),
                 params=TLM.tree_map(lambda a: a.detach().clone(), tp),
                 opt_cfg=TO.OptConfig(**kw),
                 cfg=TrainerConfig(total_steps=2, log_every=1),
                 data_fn=lambda s: {k: torch.tensor(v)
                                    for k, v in batches[s].items()},
                 device="cpu")
    jh, th = jt.run()["history"], tt.run()["history"]
    assert [s for s, _ in th] == [s for s, _ in jh] == [1, 2]
    for (_, tl), (_, jl) in zip(th, jh):
        assert abs(tl - jl) / abs(jl) < TOL, (th, jh)


def test_moe_serving_on_a_mesh_raises(params):
    """MoE serves on a mesh (the refusal this test once pinned is lifted):
    at a gloo world of one, the engine on a (1, 1) mesh under plan
    ``dsp`` with ``ep`` gives one device's tokens, and
    ``forward_prefill(sharder=)`` one device's logits and K/V."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.partition import ParallelPlan, make_sharder
    from repro_torch.serving.engine import ServingEngine
    _, tp = params
    prompts = torch.from_numpy(np.random.RandomState(3).randint(
        0, TCFG.vocab, (2, 6)))
    want = ServingEngine(tp, TCFG, max_len=16, device="cpu").generate(
        prompts, 4)
    ref_logits, ref_caches = TLM.forward_prefill(tp, prompts, TCFG,
                                                 backend="ref")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cpu")
            eng = ServingEngine(tp, TCFG, max_len=16, mesh=mesh, device="cpu",
                                plan=ParallelPlan(mode="dsp", ep=True))
            assert torch.equal(eng.generate(prompts, 4), want)
            sharder = make_sharder(mesh, ParallelPlan(
                mode="dsp", zero=False, shard_vocab=False))
            logits, caches = TLM.forward_prefill(tp, prompts, TCFG,
                                                 sharder=sharder,
                                                 backend="ref")
            assert _rel(logits, ref_logits.numpy()) < TOL
            kv = caches["periods"]["0"]["kv"]["k"]
            assert _rel(kv, ref_caches["periods"]["0"]["kv"]["k"]
                        .numpy()) < TOL
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# chip_smoke's MoE helpers: the routing record and replay, the kept pairs
# ---------------------------------------------------------------------------

def test_chip_smoke_kept_pairs_are_the_dispatch_drops():
    """``kept_pairs`` of the recorded routing drops, call for call, the
    pairs the gather dispatch reports dropped, which are JAX's."""
    import chip_smoke
    tree, x = _module(0, None)
    jm, tm = _metas("silu_glu", 0, None)
    _, jaux = JM.moe(jax.tree_util.tree_map(jnp.asarray, tree),
                     jnp.asarray(x), jm, impl="gather", capacity_factor=1.0)
    with chip_smoke.moe_calls() as calls:
        TM.moe(bridge.params_from_numpy(tree, device="cpu"),
               torch.from_numpy(x), tm, impl="gather")
    (call,) = calls
    cap = max(1, int(np.ceil(x.shape[1] * K / E_PHYS * 2.0)))
    kept = chip_smoke.kept_pairs(call["experts"], E_PHYS, cap)
    pairs = kept.numel()
    assert float(jaux["dropped"]) > 0
    assert int((~kept).sum()) == round(call["dropped"] * pairs) == round(
        float(jaux["dropped"]) * pairs)
    assert chip_smoke.route_rows([call["experts"]], E_PHYS, cap, 1, 1, 0,
                                 0) == (int(kept.sum()), int(kept.sum()))


def _loss_and_grads(tp, batch):
    leaves = TLM.tree_map(lambda a: a.detach().requires_grad_(True), tp)
    loss, _ = TLM.lm_loss(leaves, batch, TCFG)
    return loss, torch.autograd.grad(loss, TLM.tree_leaves(leaves))


def test_chip_smoke_replays_a_routing_through_remat(params):
    """``moe_calls(replay=)`` finds every MoE layer by its router in the
    checkpointed forward and its recompute: replaying the path's own
    routing changes no bit of the loss or the grads, and replaying
    another routing takes effect, the router's grads flowing through the
    replayed experts' gate values."""
    import chip_smoke
    _, tp = params
    batch = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    with torch.no_grad(), chip_smoke.moe_calls() as plain:
        TLM.lm_loss(tp, batch, TCFG)
    n_moe = TLM.n_moe_layers(TCFG)
    assert len(plain) == n_moe
    table = chip_smoke.layer_routes(plain)
    assert len(table) == n_moe
    loss0, grads0 = _loss_and_grads(tp, batch)
    with chip_smoke.moe_calls(table) as calls:
        loss1, grads1 = _loss_and_grads(tp, batch)
    assert len(calls) == 2 * n_moe            # forward and recompute
    assert all(c["differ"] == 0 for c in calls)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(grads0, grads1))

    other = {k: (v + 1) % E for k, v in table.items()}
    with chip_smoke.moe_calls(other) as calls:
        loss2, grads2 = _loss_and_grads(tp, batch)
    assert all(c["differ"] > 0 for c in calls)
    assert not torch.equal(loss0, loss2)
    router = [i for i, p in enumerate(_paths(tp)) if "router" in p]
    assert router and all(float(grads2[i].abs().max()) > 0 for i in router)
