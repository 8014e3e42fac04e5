"""One rank of the port's 2D-layout checks over gloo on the CPU.

    python tests/_torch_l2d_worker.py <rank> <world> <dir>

``tests/test_torch_layout2d.py`` starts ``world`` (8) of these on one
``FileStore`` in ``dir``, which also holds the inputs.  Each rank runs
``make_spmd_forward2d`` at every multi-rank case of
``_torch_l2d_jax.CASES``, the gradient of mean(out²) at (2, 4), and the
single transitions of ``TRANSITIONS`` on a (2, 4) grid against their
slices of a global tensor, and writes what it saw to
``dir/rank<r>.npz``: the gathered outputs, the gradients summed over the
world, and the ``torch.distributed`` calls of each run
(``core.dsp``'s counter)."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_l2d_jax import CASES, configs  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.core.plan import Stage  # noqa: E402
from repro_torch.core.schedule import (  # noqa: E402
    Schedule2D, ScheduleExecutor2D, classify2)
from repro_torch.launch.mesh import make_sp2d_mesh  # noqa: E402
from repro_torch.models import transformer2d as TT  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.trainer import allreduce_grads  # noqa: E402

KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce")
OUT, IN = (0, 1), (1, 0)
# name -> (source pair, its order, target pair, its order) on the (2, 4)
# grid, each applied alone to a rank's slice of a (2, 8, 8, 8) tensor; an
# order names the major axis of a diagonal (0 = sp_out, 1 = sp_in)
TRANSITIONS = {
    "in_switch": ((1, 2), OUT, (1, 3), OUT),
    "out_into_diagonal": ((1, 2), OUT, (2, 2), IN),
    "out_of_diagonal": ((2, 2), IN, (1, 2), OUT),
    "joint_renumbered": ((2, 2), IN, (1, 1), OUT),
    "joint_into_in_major": ((1, 1), OUT, (2, 2), IN),
    "joint_gather": ((2, 2), IN, None, OUT),
    "joint_split": (None, OUT, (2, 2), IN),
    "both_axes": ((1, 2), OUT, (2, 3), OUT),
    "gather_both": ((1, 2), OUT, None, OUT),
    "split_both": (None, OUT, (1, 2), OUT),
    # each of these would need traffic across the other axis' groups
    "refused_out_major": ((2, 2), OUT, (1, 2), OUT),
    "refused_swap": ((1, 2), OUT, (2, 1), OUT),
    "refused_renumber": ((2, 2), OUT, (2, 2), IN),
}


def counted(out, name):
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    dsp.reset_calls()


def oracle(g: torch.Tensor, pair, order, coord, grid) -> torch.Tensor:
    """The slice of the global ``g`` a rank at grid ``coord`` holds under
    the pair layout: component k cuts its dim ``grid[k]`` ways; a
    diagonal cuts it ``grid[0] * grid[1]`` ways, ``order[0]``'s index
    major."""
    pair = pair or (None, None)
    for d in sorted({a for a in pair if a is not None}):
        n, idx = 1, 0
        for k in order:
            if pair[k] == d:
                n, idx = n * grid[k], idx * grid[k] + coord[k]
        size = g.shape[d] // n
        g = g.narrow(d, idx * size, size)
    return g


def transitions(out, mesh):
    """Each case of TRANSITIONS through ``ScheduleExecutor2D.apply``
    against ``oracle``; the joint renumbered switch run as a bare all-to-all
    over the flattened group (its chunks taken in the group's own order),
    which must miss; and that switch's gradient."""
    ctx = from_mesh(mesh)
    grid = (ctx.size("sp_out"), ctx.size("sp_in"))
    coord = (ctx.index("sp_out"), ctx.index("sp_in"))
    stages = tuple(Stage(frozenset(), f"s{i}") for i in range(4))
    ex = ScheduleExecutor2D(Schedule2D(stages, ((1, 2),) * 4, grid=grid)
                            .periodic(4), backend="explicit", ctx=ctx)
    g = torch.arange(2 * 8 * 8 * 8, dtype=torch.float32).reshape(2, 8, 8, 8)
    dsp.reset_calls()
    for name, (src, so, tgt, to) in TRANSITIONS.items():
        x = oracle(g, src, so, coord, grid)
        try:
            y = ex.apply(x, classify2(src, tgt), src_order=so, order=to)
        except ValueError:
            out[f"tr/{name}/refused"] = np.array(1)
            counted(out, f"tr/{name}")
            continue
        out[f"tr/{name}/refused"] = np.array(0)
        out[f"tr/{name}/ok"] = np.array(int(torch.equal(
            y, oracle(g, tgt, to, coord, grid))))
        counted(out, f"tr/{name}")
    src, so, tgt, to = TRANSITIONS["joint_renumbered"]
    x = oracle(g, src, so, coord, grid)
    y = dsp.dynamic_switch(x, 2, 1, ctx.flat_group())
    out["tr/bare_all_to_all/ok"] = np.array(int(torch.equal(
        y, oracle(g, tgt, to, coord, grid))))
    w = torch.randn(g.shape, generator=torch.Generator().manual_seed(5))
    leaf = x.clone().requires_grad_(True)
    y = ex.apply(leaf, classify2(src, tgt), src_order=so, order=to)
    (y * oracle(w, tgt, to, coord, grid)).sum().backward()
    out["tr/joint_grad/ok"] = np.array(int(torch.equal(
        leaf.grad, oracle(w, src, so, coord, grid))))
    dsp.reset_calls()


def forwards(out, params, raw):
    """Every multi-rank case of CASES: the output gathered whole over the
    SP and data dims (after the counters were read)."""
    t = torch.from_numpy(raw["t"])
    meshes = {}
    for case, (cname, xname, shape) in CASES.items():
        if shape == (1, 1, 1):
            continue
        if shape not in meshes:
            meshes[shape] = make_sp2d_mesh(*shape, device_type="cpu")
        mesh = meshes[shape]
        cfg = TT.T2DConfig(**configs(torch.float32)[cname])
        fwd = TT.make_spmd_forward2d(cfg, mesh, backend="ref")
        dsp.reset_calls()
        with torch.no_grad():
            y = fwd(params[cname], torch.from_numpy(raw[xname]), t)
        counted(out, case)
        y = TT.gather_video2d(y, mesh)
        if shape[2] > 1:
            y = dsp.gather(y, 0, from_mesh(mesh).group("data"))
        out[case] = y
        dsp.reset_calls()
    return meshes[(2, 4, 1)]


def grads(out, params_np, raw, mesh):
    """mean(out²) at (2, 4) with remat: each rank's share of the sum over
    its shard, and its gradient, summed over the world."""
    cfg = TT.T2DConfig(**configs(torch.float32)["t"])
    x = torch.from_numpy(raw["x24"])
    leaves = bridge.params_from_numpy(params_np, device="cpu")
    flat = [p.requires_grad_(True) for p in tree_leaves(leaves)]
    local = TT.shard_video_batch2d({"x": x, "t": torch.from_numpy(
        raw["t"])}, mesh)
    dsp.reset_calls()
    y = TT.forward2d(leaves, local["x"], local["t"], cfg, mesh=mesh,
                     backend="ref", remat=True)
    loss = (y.float() ** 2).sum() / x.numel()     # out has x's shape
    g = iter(torch.autograd.grad(loss, flat))
    _, gtree = allreduce_grads(loss.detach(), tree_map(lambda p: next(g),
                                                       leaves))
    counted(out, "grad")
    for path, leaf in flatten(gtree).items():
        out[f"grad/{path}"] = leaf


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    try:
        params_np = {name: unflatten(dict(np.load(
            os.path.join(work, f"params_{name}.npz"))))
            for name in configs(torch.float32)}
        params = {k: bridge.params_from_numpy(v, device="cpu")
                  for k, v in params_np.items()}
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        out = {}
        mesh = forwards(out, params, raw)
        grads(out, params_np["t"], raw, mesh)
        transitions(out, mesh)
        np.savez(os.path.join(work, f"rank{rank}.npz"),
                 **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                        else v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
