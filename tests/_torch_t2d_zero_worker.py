"""One rank of the port's ZeRO-3 checks of the 2D DiT over gloo on the CPU.

    python tests/_torch_t2d_zero_worker.py <rank> <world> <dir>

``tests/test_torch_t2d_zero.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params.npz``,
``inputs.npz``).  Each rank writes ``dir/rank<r>.npz``:

1. for each scenario of ``_torch_t2d_zero_jax.SCENARIOS``: the whole
   parameters laid out by ``param_pspecs`` of ``PLAN`` and cut to its
   slices (``shard_params``), ``t2d_loss(mesh=, mode=, remat=True,
   param_specs=)`` on its batch shard, the loss and the grad slices summed
   by ``allreduce_grads`` and the clip's norm (``slices_norm``); each
   slice's index in its whole leaf; the ``torch.distributed`` calls and
   bytes of that step beside its contract
   (``transformer2d.step_contract``);
2. ``train/*``: ``TRAIN_STEPS`` Trainer steps at ``TRAIN_MESH`` on the
   slices, each step's loss and grad norm, and the parameters gathered
   whole after them;
3. ``ckpt/*``: the same Trainer for ``CKPT_AT`` steps with a checkpoint
   in ``dir/ck`` (each rank its slices; rank 0 writes the state gathered
   whole to ``dir/saved.npz``), then a fresh Trainer at ``RESUME_MESH``
   that resumes (its state gathered, bit-equal to the saved one, or not)
   and takes step ``TRAIN_STEPS``: its loss.
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
from repro_torch.models import transformer2d as TT  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, mesh_sizes, param_pspecs, shard_params, slice_index,
    unshard_params)
from repro_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig, allreduce_grads, slices_norm)

from _torch_ckpt_worker import bit_equal  # noqa: E402
from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_t2d_zero_jax import (BATCH, CFG_KW, FRAMES,  # noqa: E402
                                 PATCHES, SCENARIOS)

CFG = TT.T2DConfig(**CFG_KW, dtype=torch.float32)
# transformer2d-720m's own plan (``configs.transformer2d_720m.SPEC.plan``)
PLAN = ParallelPlan(mode="dsp", zero=True, shard_vocab=False)
# the Trainer checks: 3 steps at (2, 2) against one process's Trainer on
# the whole parameters; a checkpoint after 2 of them, resumed at (1, 4).
# AdamW's eps is 1e-3, as _torch_zero_worker.py's: at 1e-8 its first
# updates divide grads near 1e-8 by themselves and turn f32
# summation-order noise into whole-step gaps
TRAIN_MESH, RESUME_MESH = (2, 2), (1, 4)
TRAIN_STEPS, CKPT_AT = 3, 2
TRAIN_OPT = OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                      eps=1e-3)


def train_batch(step: int):
    """The global batch of Trainer step ``step``: seeded normals and
    timesteps, the same on every rank and in the test."""
    rng = np.random.RandomState(200 + step)
    shape = (BATCH, FRAMES, PATCHES, CFG.in_dim)
    return {"x": torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)),
            "t": torch.from_numpy(rng.rand(BATCH).astype(np.float32)),
            "target": torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32))}


def schedule(shape):
    """The joint planned schedule of ``CFG`` at the global batch over
    ``shape``'s model dim, priced in bytes."""
    return TT.dsp_schedule(CFG, shape[1], t_len=FRAMES, s_len=PATCHES,
                           batch=BATCH, joint=True)


def step_contract(mode: str, shape, whole) -> dict:
    """{"calls", "bytes"} per rank, in ``KINDS`` order, of one loss with
    ``remat``, its grads, their sums and the clip's norm under ``mode`` on
    a ``shape`` mesh: ``transformer2d.step_contract`` (``dsp`` on the
    joint ``schedule``)."""
    step = TT.step_contract(
        CFG, whole, PLAN, {"data": shape[0], "model": shape[1]},
        batch=BATCH, frames=FRAMES, patches=PATCHES, mode=mode,
        schedule=schedule(shape) if mode == "dsp" else None)
    return {part: np.array([step[part].get(k, 0) for k in KINDS])
            for part in ("calls", "bytes")}


def setup(params_np, shape):
    """(mesh, context, specs, the whole tree, the rank's slices)."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    whole = bridge.params_from_numpy(params_np, device="cpu")
    specs = param_pspecs(whole, PLAN, axis_sizes=mesh_sizes(ctx))
    return mesh, ctx, specs, whole, shard_params(whole, specs, ctx)


def scenario(out, name, params_np, batch):
    mode, shape = SCENARIOS[name]
    mesh, ctx, specs, whole, params = setup(params_np, shape)
    local = TT.shard_video_batch(batch, mesh)
    psched = schedule(shape) if mode == "dsp" else None
    out[f"{name}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
    contract = step_contract(mode, shape, whole)
    for part, v in contract.items():
        out[f"{name}/contract_{part}"] = v
    dsp.reset_calls()
    flat = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = TT.t2d_loss(params, local, CFG, mesh=mesh, mode=mode,
                          remat=True, schedule=psched, param_specs=specs)
    grads = iter(torch.autograd.grad(loss, flat))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    norm = slices_norm(gtree, specs, ctx)
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{name}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    out[f"{name}/loss"] = total
    out[f"{name}/norm"] = norm
    for (path, g), w, s in zip(flatten(gtree).items(), tree_leaves(whole),
                               tree_leaves(specs)):
        out[f"{name}/grad/{path}"] = g
        out[f"{name}/index/{path}"] = np.array(slice_index(w.shape, s, ctx))
    dsp.reset_calls()


def trainer(params_np, shape, ckpt_dir=None, total=TRAIN_STEPS):
    """A Trainer on the rank's slices at ``shape``, the rank's shard of
    ``train_batch`` a step."""
    mesh, _, specs, _, params = setup(params_np, shape)
    psched = schedule(shape)
    return Trainer(
        loss_fn=lambda p, b: TT.t2d_loss(p, b, CFG, mesh=mesh,
                                         schedule=psched, param_specs=specs),
        params=params, opt_cfg=TRAIN_OPT,
        cfg=TrainerConfig(total_steps=total, log_every=1),
        data_fn=lambda s: TT.shard_video_batch(train_batch(s), mesh),
        ckpt_dir=ckpt_dir, device="cpu", mesh=mesh, param_specs=specs,
        schedule=psched.schedule)


def metered(tr) -> list:
    """``tr``'s step wrapped to record each step's [loss, grad norm]."""
    seen = []
    inner = tr.step_fn

    def step(*args):
        res = inner(*args)
        seen.append([float(res[-1]["loss"]), float(res[-1]["grad_norm"])])
        return res
    tr.step_fn = step
    return seen


def gathered(tr):
    with torch.no_grad():
        return unshard_params(tr._state(), tr._state_specs(), tr.ctx)


def train(out, params_np):
    tr = trainer(params_np, TRAIN_MESH)
    seen = metered(tr)
    tr.run()
    out["train/metrics"] = np.array(seen)
    for path, p in flatten(unshard_params(tr.params, tr.specs,
                                          tr.ctx)).items():
        out[f"train/param/{path}"] = p


def checkpoint(out, params_np, work, rank):
    ckdir = os.path.join(work, "ck")
    first = trainer(params_np, TRAIN_MESH, ckpt_dir=ckdir, total=CKPT_AT)
    first.run()
    saved = gathered(first)
    if rank == 0:
        np.savez(os.path.join(work, "saved.npz"), **{
            k: (np.array(v, dtype=np.int32) if isinstance(v, int)
                else v.numpy()) for k, v in flatten(saved).items()})
    second = trainer(params_np, RESUME_MESH, ckpt_dir=ckdir)
    second.try_resume()
    out["ckpt/start_step"] = second.start_step
    out["ckpt/restored_equal"] = bit_equal(gathered(second), saved)
    seen = metered(second)
    second.run()
    out["ckpt/losses"] = np.array([loss for loss, _ in seen])


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
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        batch = {k: torch.from_numpy(raw[k]) for k in ("x", "t", "target")}
        for name in SCENARIOS:
            scenario(out, name, params_np, batch)
        train(out, params_np)
        checkpoint(out, params_np, work, rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
