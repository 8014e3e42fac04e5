"""One rank of the port's DSP checks over gloo on the CPU.

    python tests/_torch_dsp_worker.py <rank> <world> <dir>

``tests/test_torch_dsp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params.npz``,
``inputs.npz``, written by the test).  Each rank runs every scenario in
turn and writes what it saw to ``dir/rank<r>.npz``: local shards and
shapes, losses, gradients, parameters after a Trainer step, and the
``torch.distributed`` calls the port issued per scenario (``core.dsp``'s
counter).  The test compares them with the JAX package's results."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh, submesh  # noqa: E402
from repro_torch.models import transformer2d as TT  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig, allreduce_grads)

CFG = TT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4, d_ff=128,
                   in_dim=16, dtype=torch.float32)
# AdamW's first step moves each weight by lr * g / (|g| + eps): eps 1e-4
# keeps it continuous in g, so grads summed in another order give updates
# within the bar
OPT = OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-4)
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}


def flatten(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flatten(tree[key], f"{path}/{key}").items()}
    return {path.lstrip("/"): tree}


def unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def counted(out, name):
    out[f"{name}/calls"] = np.array(
        [dsp.calls.get(k, 0) for k in ("all-to-all", "all-gather",
                                       "reduce-scatter", "all-reduce")])
    dsp.reset_calls()


def primitives(out, x, w):
    """dynamic_switch / split / gather on a (1, 4) mesh, as
    tests/md_scenarios.py's dsp_primitives checks them, and their
    backwards."""
    ctx = from_mesh(make_mesh((1, 4), ("data", "model"), "cpu"))
    g = ctx.sp_group
    dsp.reset_calls()
    local = dsp.split(x, 1, g).clone().requires_grad_(True)
    y = dsp.dynamic_switch(local, 1, 2, g)
    z = dsp.dynamic_switch(y, 2, 1, g)
    full = dsp.gather(z, 1, g)
    again = dsp.split(full, 1, g)
    (y * dsp.split(w, 2, g)).sum().backward()
    switch_grad = local.grad.clone()
    leaf = z.detach().requires_grad_(True)
    (dsp.gather(leaf, 1, g) * w).sum().backward()
    try:
        dsp.dynamic_switch(local.detach()[:, :, :6], 1, 2, g)
        refused = 0
    except ValueError:
        refused = 1
    out.update({"prim/refused": np.array(refused), "prim/y": y.detach(), "prim/z": z.detach(),
                "prim/full": full.detach(), "prim/again": again.detach(),
                "prim/local": local.detach(), "prim/switch_grad": switch_grad,
                "prim/gather_grad": leaf.grad,
                "prim/shape": np.array(y.shape)})
    counted(out, "prim")


def spmd_forward(out, params, inp):
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        ctx = from_mesh(mesh)
        fwd = TT.make_spmd_forward(CFG, mesh, mode="dsp", backend="ref")
        with torch.no_grad():
            y = fwd(params, inp["x"], inp["t"])
        out[f"fwd{name}/out"] = y
        out[f"fwd{name}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
        counted(out, f"fwd{name}")


def unrolled_forward(out, params, inp):
    """``forward`` on a (1, 4) mesh through the unrolled view of the same
    plan (boundaries by absolute stage index, the last switch at the
    exit): the same values and all-to-alls as the periodic view."""
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    local = TT.shard_video_batch(inp, mesh)
    outs = []
    for view in ("periodic", "unrolled"):
        ps = TT.dsp_schedule(CFG, 4, t_len=8, s_len=16, batch=2)
        if view == "unrolled":
            ps = ps.schedule.unrolled()
        with torch.no_grad():
            outs.append(TT.forward(params, local["x"], local["t"], CFG,
                                   mesh=mesh, backend="ref", schedule=ps))
        counted(out, f"view/{view}")
    out["view/gap"] = (outs[0] - outs[1]).abs().max()


def loss_and_grads(out, params, inp):
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        local = TT.shard_video_batch(inp, mesh)
        leaves = bridge.params_from_numpy(params, device="cpu")
        flat = [p.requires_grad_(True) for p in tree_leaves(leaves)]
        loss, _ = TT.t2d_loss(leaves, local, CFG, mesh=mesh,
                              backend="kernel", remat=True)
        grads = torch.autograd.grad(loss, flat)
        it = iter(grads)
        gtree = tree_map(lambda p: next(it), leaves)
        total, gtree = allreduce_grads(loss.detach(), gtree)
        out[f"grad{name}/loss"] = total
        for path, gleaf in flatten(gtree).items():
            out[f"grad{name}/{path}"] = gleaf
        counted(out, f"grad{name}")


def trainer_step(out, params_np, inp):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = bridge.params_from_numpy(params_np, device="cpu")
    trainer = Trainer(
        loss_fn=lambda p, b: TT.t2d_loss(p, b, CFG, mesh=mesh,
                                         backend="kernel"),
        params=params, opt_cfg=OPT,
        cfg=TrainerConfig(total_steps=1, log_every=1),
        data_fn=lambda step: TT.shard_video_batch(inp, mesh), device="cpu",
        mesh=mesh)
    hist = trainer.run()["history"]
    out["train/loss"] = np.array(hist[0][1])
    for path, p in flatten(trainer.params).items():
        out[f"train/{path}"] = p
    counted(out, "train")


def meshes(out):
    sub = submesh(2, device_type="cpu")
    coord = sub.get_coordinate()
    out["mesh/sub"] = np.array(coord if coord is not None else [-1, -1])
    ctx = from_mesh(make_mesh((2, 2), ("data", "model"), "cpu"))
    out["mesh/ctx"] = np.array([ctx.sp_size, ctx.dp_size, ctx.world_size,
                                ctx.sp_index, ctx.dp_index,
                                dist.get_world_size(ctx.sp_group)])


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    try:
        params_np = unflatten(dict(np.load(os.path.join(work,
                                                        "params.npz"))))
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        inp = {k: torch.from_numpy(raw[k]) for k in ("x", "t", "target")}
        params = bridge.params_from_numpy(params_np, device="cpu")
        out = {}
        primitives(out, torch.from_numpy(raw["prim_x"]),
                   torch.from_numpy(raw["prim_w"]))
        spmd_forward(out, params, inp)
        unrolled_forward(out, params, inp)
        loss_and_grads(out, params_np, inp)
        trainer_step(out, params_np, inp)
        meshes(out)
        np.savez(os.path.join(work, f"rank{rank}.npz"),
                 **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                        else v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
