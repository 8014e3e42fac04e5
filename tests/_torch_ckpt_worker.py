"""One rank of the port's checkpoint, compression and elastic checks over
gloo on the CPU.

    python tests/_torch_ckpt_worker.py <rank> <world> <dir>

``tests/test_torch_elastic.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds ``params.npz`` (JAX's init of
``CFG``).  Each rank writes ``dir/rank<r>.npz``:

1. ``layout/*``: the training state of ``layout_tree`` (bf16 parameters,
   AdamW's f32 moments and master copy, the step, the residuals) cut to
   the (2, 2) mesh's slices under ZeRO-3 and the vocab ring
   (``LAYOUT_PLAN``), saved async into ``dir/ck_layout`` (step
   ``LAYOUT_STEP``); then restored at (1, 4) and (4, 1), each slice
   against ``shard_params`` of the saved global tree, bit for bit.
2. ``compress/*``: ``COMPRESS_STEPS`` steps of ``compress_with_feedback``
   on the (2, 2) slices of seeded grads (``compress_grads``), each against
   the whole-leaf compression's slice, bit for bit, and the all-reduces
   it issued.
3. ``elastic/*``: the ``Trainer`` at (2, 2) under ``ELASTIC_PLAN`` for
   ``RESIZE_AT`` steps with a checkpoint, then a fresh ``Trainer`` that
   resumes (its state gathered against the first's, bit for bit),
   ``replan(2)`` (on ranks 0 and 1 the moved state, gathered, against
   the resumed one, bit for bit) and runs to ``ELASTIC_STEPS``: the
   losses of both runs.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.optim.compress import compress_with_feedback  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs, shard_params,
    unshard_params)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    ElasticSpec, Trainer, TrainerConfig)

from _torch_dsp_jax import flatten, unflatten  # noqa: E402

# tests/md_scenarios.py's elastic_train_resize LM: 2 layers, MHA 8/8
CFG_KW = dict(name="t", n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
              head_dim=8, d_ff=128, vocab=96)
SEQ, BATCH = 32, 2
LAYOUT_PLAN = ParallelPlan(mode="dsp", zero=True, shard_vocab=True)
LAYOUT_STEP = 5
LAYOUTS = ((1, 4), (4, 1))
COMPRESS_STEPS = 3
# elastic_train_resize's plan and steps: resize 4 -> 2 after step 3 of 6.
# AdamW's eps is 1e-3: at 1e-8 its first updates divide grads near 1e-8
# by themselves, turning f32 summation-order noise between the packages
# into whole-step gaps (see _torch_zero_worker.py)
ELASTIC_PLAN = ParallelPlan(mode="dsp", shard_vocab=False)
RESIZE_AT, ELASTIC_STEPS = 3, 6
ELASTIC_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=ELASTIC_STEPS,
                   eps=1e-3)


def cfg():
    return TL.LMConfig(**CFG_KW, dtype=torch.float32)


def batch(step: int):
    """The global batch of step ``step``, the same on every rank, in the
    test and in JAX (numpy)."""
    rng = np.random.RandomState(100 + step)
    tokens = rng.randint(0, CFG_KW["vocab"], (BATCH, SEQ))
    return {"tokens": tokens, "labels": (tokens + 1) % CFG_KW["vocab"]}


def layout_tree(params_np):
    """The whole training state the layout check saves: the parameters in
    bf16, AdamW's moments (seeded normals) and master copy in f32, the
    step, the residuals (seeded normals)."""
    rng = np.random.default_rng(7)
    params = bridge.params_from_numpy(params_np, device="cpu")

    def normal(p):
        return torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32))
    return {"params": TL.tree_map(lambda p: p.bfloat16(), params),
            "opt": {"m": TL.tree_map(normal, params),
                    "v": TL.tree_map(lambda p: normal(p).abs(), params),
                    "master": params, "step": LAYOUT_STEP},
            "residuals": TL.tree_map(normal, params)}


def layout_specs(tree, sizes):
    """The state's specs: ``param_pspecs`` of each part (the moments see
    their parameters' names under ``m/``, ``v/``, ``master/``), the step
    whole."""
    opt = {k: v for k, v in tree["opt"].items() if k != "step"}
    return {"params": param_pspecs(tree["params"], LAYOUT_PLAN,
                                   axis_sizes=sizes),
            "opt": {**param_pspecs(opt, LAYOUT_PLAN, axis_sizes=sizes),
                    "step": ()},
            "residuals": param_pspecs(tree["residuals"], LAYOUT_PLAN,
                                      axis_sizes=sizes)}


def cut(tree, specs, ctx):
    """``shard_params`` of a state tree (the step stays)."""
    opt = {k: v for k, v in tree["opt"].items() if k != "step"}
    ospecs = {k: v for k, v in specs["opt"].items() if k != "step"}
    return {"params": shard_params(tree["params"], specs["params"], ctx),
            "opt": {**shard_params(opt, ospecs, ctx),
                    "step": tree["opt"]["step"]},
            "residuals": shard_params(tree["residuals"], specs["residuals"],
                                      ctx)}


def meta(tree):
    return TL.tree_map(lambda t: t if isinstance(t, int) else torch.empty(
        t.shape, dtype=t.dtype, device="meta"), tree)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).contiguous().view(torch.uint8)


def bit_equal(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    if sorted(fa) != sorted(fb):
        return False
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, int) or isinstance(y, int):
            if x != y:
                return False
        elif (x.dtype != y.dtype or x.shape != y.shape
              or not torch.equal(bits(x), bits(y))):
            return False
    return True


def layouts(out, work, params_np):
    whole = layout_tree(params_np)
    ctx = from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    specs = layout_specs(whole, mesh_sizes(ctx))
    mgr = CheckpointManager(os.path.join(work, "ck_layout"))
    mgr.save(LAYOUT_STEP, cut(whole, specs, ctx), specs=specs, ctx=ctx)
    mgr.wait()
    out["layout/steps"] = np.array(mgr.all_steps())
    for shape in LAYOUTS:
        ctx2 = from_mesh(make_mesh(shape, ("data", "model"), "cpu"))
        specs2 = layout_specs(whole, mesh_sizes(ctx2))
        step, got = mgr.restore(meta(whole), specs=specs2, ctx=ctx2,
                                device="cpu")
        want = cut(whole, specs2, ctx2)
        out[f"layout/{shape[0]}x{shape[1]}"] = np.array(
            [step == LAYOUT_STEP, bit_equal(got, want)])


def compress_grads(step: int, params_np):
    """Seeded grads of every parameter leaf at step ``step``."""
    rng = np.random.default_rng(50 + step)
    return TL.tree_map(
        lambda p: torch.from_numpy((rng.standard_normal(p.shape) * (1 + step))
                                   .astype(np.float32)),
        bridge.params_from_numpy(params_np, device="cpu"))


def compression(out, params_np):
    ctx = from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    grads0 = compress_grads(0, params_np)
    specs = param_pspecs(grads0, LAYOUT_PLAN, axis_sizes=mesh_sizes(ctx))
    res_whole = res_slices = None
    ok = []
    dsp.reset_calls()
    for step in range(COMPRESS_STEPS):
        g = compress_grads(step, params_np)
        if res_whole is None:
            res_whole = TL.tree_map(torch.zeros_like, g)
            res_slices = shard_params(res_whole, specs, ctx)
        want_g, res_whole = compress_with_feedback(g, res_whole)
        got_g, res_slices = compress_with_feedback(
            shard_params(g, specs, ctx), res_slices, specs=specs, ctx=ctx)
        ok.append(bit_equal(got_g, shard_params(want_g, specs, ctx))
                  and bit_equal(res_slices,
                                shard_params(res_whole, specs, ctx)))
    out["compress/ok"] = np.array(ok)
    out["compress/all_reduces"] = np.array(dsp.calls.get("all-reduce", 0))
    dsp.reset_calls()


def elastic_trainer(params_np, work, total, mesh_shape):
    c = cfg()
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    whole = bridge.params_from_numpy(params_np, device="cpu")
    specs = param_pspecs(whole, ELASTIC_PLAN, axis_sizes=mesh_sizes(ctx))

    def solve_schedule(sp):
        return TL.dsp_schedule(c, sp, seq=SEQ, batch=BATCH, joint=True)

    def make_loss(mesh, sharder, schedule):
        return lambda p, b: TL.lm_loss(p, TL.shard_lm_batch(b, sharder), c,
                                       sharder=sharder)
    sharder = make_sharder(mesh, ELASTIC_PLAN, solve_schedule(
        mesh_shape[1]), param_specs=specs)
    return Trainer(
        loss_fn=make_loss(mesh, sharder, sharder.schedule),
        params=shard_params(whole, specs, ctx),
        opt_cfg=OptConfig(**ELASTIC_OPT),
        cfg=TrainerConfig(total_steps=total, log_every=1,
                          ckpt_every=RESIZE_AT),
        data_fn=lambda s: {k: torch.from_numpy(v).long()
                           for k, v in batch(s).items()},
        ckpt_dir=os.path.join(work, "ck_elastic"), device="cpu",
        sharder=sharder,
        elastic=ElasticSpec(make_loss=make_loss,
                            solve_schedule=solve_schedule,
                            plan=ELASTIC_PLAN))


def elastic(out, work, params_np):
    first = elastic_trainer(params_np, work, RESIZE_AT, (2, 2))
    losses = [loss for _, loss in first.run()["history"]]
    saved = unshard_params(first._state(), first._state_specs(), first.ctx)
    second = elastic_trainer(params_np, work, ELASTIC_STEPS, (2, 2))
    second.try_resume()
    resumed = unshard_params(second._state(), second._state_specs(),
                             second.ctx)
    out["elastic/resumed"] = np.array([second.start_step == RESIZE_AT,
                                       bit_equal(resumed, saved)])
    second.replan(2)
    if second.active:
        moved = unshard_params(second._state(), second._state_specs(),
                               second.ctx)
        out["elastic/moved"] = np.array(bit_equal(moved, resumed))
    out["elastic/mesh"] = np.array(
        [-1, -1] if second.mesh is None else list(second.mesh.shape))
    losses += [loss for _, loss in second.run()["history"]]
    out["elastic/losses"] = np.array(losses)
    out["elastic/active"] = np.array(second.active)
    if second.active:
        out["elastic/steps"] = np.array(second.ckpt.all_steps())


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        params_np = unflatten(dict(np.load(os.path.join(work,
                                                        "params.npz"))))
        layouts(out, work, params_np)
        compression(out, params_np)
        elastic(out, work, params_np)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
