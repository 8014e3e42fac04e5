"""One rank of the port's MoE-under-``tp`` checks over gloo on the CPU.

    python tests/_torch_moe_tp_worker.py <rank> <world> <dir>

``tests/test_torch_moe_tp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params_<config>
.npz``, JAX's init of each SMOKE config, and ``inputs.npz``).  For each
scenario of ``_torch_moe_tp_jax.SCENARIOS`` the rank lays the whole
parameters out by ``param_pspecs`` of ``ParallelPlan(mode="tp", ep=,
zero=True)`` and keeps its slices, then writes to ``dir/rank<r>.npz``:
its coordinate; the shapes ``Sharder.whole`` gives one period's expert
and shared or dense ``wi``; its ``forward(sharder=)`` shard with each MoE
call's experts for its tokens (``chip_smoke.moe_calls``);
``lm_loss(sharder=, aux_weight=0)`` with remat on its batch shard (the
cross-entropy alone, which JAX's ``forward`` and ``chunked_xent`` give),
its shares of the load-balance and dropped stats, the loss and grads
summed by ``allreduce_grads``, each grad slice with its place in the
whole leaf; and the ``torch.distributed`` calls and bytes of that step,
the clip's norm (``slices_norm``) included.
Every rank waits at a barrier, then leaves the group, before it exits."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models.lm import tree_map  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs, shard_params,
    slice_index, tree_map_with_path)
from repro_torch.train.trainer import allreduce_grads, slices_norm  # noqa

from chip_smoke import moe_calls  # noqa: E402
from _torch_dsp_jax import unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_moe_tp_jax import SCENARIOS, configs  # noqa: E402


def _shape(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree.shape)


def scenario(out, name, cfg, whole, batch, shape, ep):
    plan = ParallelPlan(mode="tp", ep=ep, zero=True)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    specs = param_pspecs(whole, plan, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, plan, param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([sharder.dp_index, sharder.sp_index])
    one = TL.unstack(params["periods"], cfg.n_periods)[0]
    read = TL.fit_sharder(sharder, cfg).whole(one, "periods")["0"]["moe"]
    out[f"{name}/expert_shape"] = np.array(read["wi"].shape)
    mlp = read["dense" if "dense" in read else "shared"]
    out[f"{name}/mlp_shape"] = np.array(mlp["wi"]["w"].shape)
    dsp.reset_calls()
    with torch.no_grad(), moe_calls() as calls:
        out[f"{name}/out"] = TL.forward(params, local["tokens"], cfg,
                                        sharder=sharder, remat=False)[0]
    for i, call in enumerate(calls):
        out[f"{name}/route{i}/experts"] = call["experts"]
    dsp.reset_calls()
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss, metrics = TL.lm_loss(leaves, local, cfg, sharder=sharder,
                               aux_weight=0.0)
    grads = iter(torch.autograd.grad(loss, TL.tree_leaves(leaves)))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    slices_norm(gtree, specs, ctx)                  # the clip's all-reduce
    out[f"{name}/step/calls"] = np.array([dsp.calls.get(k, 0)
                                          for k in KINDS])
    out[f"{name}/step/bytes"] = np.array([dsp.volume.get(k, 0)
                                          for k in KINDS])
    dsp.reset_calls()
    out[f"{name}/loss"] = total
    out[f"{name}/lb"] = metrics["moe_load_balance"].detach()
    out[f"{name}/dropped"] = metrics["moe_dropped"].detach()

    def save(path, g, spec):
        key = "/".join(path)
        out[f"{name}/grad/{key}"] = g
        out[f"{name}/index/{key}"] = np.array(
            slice_index(_shape(whole, path), spec, ctx))
    tree_map_with_path(save, gtree, specs)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        cfgs = configs("repro_torch")
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        batch = {k: torch.from_numpy(raw[k]).long()
                 for k in ("tokens", "labels")}
        trees = {c: bridge.params_from_numpy(unflatten(dict(np.load(
            os.path.join(work, f"params_{c}.npz")))), device="cpu")
            for c in cfgs}
        for name, (cname, shape, ep) in SCENARIOS.items():
            scenario(out, name, cfgs[cname], trees[cname], batch, shape, ep)
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
