"""One rank of the port's MoE-on-a-mesh checks over gloo on the CPU.

    python tests/_torch_moe_ep_worker.py <rank> <world> <dir>

``tests/test_torch_moe_ep.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params_<config>
.npz``, ``inputs.npz``).  For each scenario of
``_torch_moe_ep_jax.SCENARIOS`` the rank lays the whole parameters out by
``param_pspecs`` of ``ParallelPlan(mode="dsp", ep=, zero=)`` and keeps its
slices, then writes to ``dir/rank<r>.npz``: its coordinate; its
``forward(sharder=)`` shard with each MoE call's experts for its tokens
and its share of the dropped pairs (``chip_smoke.moe_calls``); the shapes
of one period's expert leaves as ``Sharder.whole`` gives them;
``lm_loss(sharder=)`` with remat on its batch shard, its dropped share,
the loss and grads summed by ``allreduce_grads`` and the clip's norm,
each grad slice with its place in the whole leaf; and the
``torch.distributed`` calls and bytes of that step.  Every rank waits at
a barrier, then leaves the group, before it exits."""
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
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.lm import tree_map  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs, shard_params,
    slice_index, tree_map_with_path)
from repro_torch.train.trainer import allreduce_grads, slices_norm  # noqa

from chip_smoke import moe_calls  # noqa: E402
from _torch_dsp_jax import unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_moe_ep_jax import BATCH, SCENARIOS, SEQ, configs  # noqa: E402


def plan_of(ep: bool, zero: bool) -> ParallelPlan:
    return ParallelPlan(mode="dsp", ep=ep, zero=zero)


def counts(out, name):
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{name}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    dsp.reset_calls()


def scenario(out, name, cfg, params_np, batch, shape, plan):
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    whole = bridge.params_from_numpy(params_np, device="cpu")
    specs = param_pspecs(whole, plan, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, plan, schedule=TL.dsp_schedule(
        cfg, shape[1], seq=SEQ, batch=BATCH, joint=True), param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([sharder.dp_index, sharder.sp_index])
    moe_key = next(k for k, v in params["periods"].items() if "moe" in v)
    one = TL.unstack(params["periods"], cfg.n_periods)[0]
    read = sharder.whole(one, "periods")[moe_key]["moe"]
    out[f"{name}/expert_shape"] = np.array(read["wi"].shape)
    dsp.reset_calls()
    with torch.no_grad(), moe_calls() as calls:
        out[f"{name}/out"] = TL.forward(params, local["tokens"], cfg,
                                        sharder=sharder, remat=False)[0]
    for i, call in enumerate(calls):
        out[f"{name}/route{i}/experts"] = call["experts"]
        out[f"{name}/route{i}/dropped"] = np.float64(call["dropped"])
    dsp.reset_calls()
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss, metrics = TL.lm_loss(leaves, local, cfg, sharder=sharder)
    grads = iter(torch.autograd.grad(loss, TL.tree_leaves(leaves)))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    norm = slices_norm(gtree, specs, ctx)
    counts(out, f"{name}/step")
    out[f"{name}/loss"] = total
    out[f"{name}/norm"] = norm
    out[f"{name}/dropped"] = metrics["moe_dropped"].detach()

    def save(path, g, spec):
        key = "/".join(path)
        out[f"{name}/grad/{key}"] = g
        out[f"{name}/index/{key}"] = np.array(
            slice_index(_shape(whole, path), spec, ctx))
    tree_map_with_path(save, gtree, specs)


def _shape(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree.shape)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        cfgs = configs(TL, TSSM, torch.float32)
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        batch = {k: torch.from_numpy(raw[k]).long()
                 for k in ("tokens", "labels")}
        for name, (cname, shape, (ep, zero)) in SCENARIOS.items():
            params_np = unflatten(dict(np.load(os.path.join(
                work, f"params_{cname}.npz"))))
            scenario(out, name, cfgs[cname], params_np, batch, shape,
                     plan_of(ep, zero))
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
