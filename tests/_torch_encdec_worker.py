"""One rank of the port's enc-dec-on-a-mesh checks over gloo on the CPU.

    python tests/_torch_encdec_worker.py <rank> <world> <dir>

``tests/test_torch_encdec_dsp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params_<config>
.npz``, ``inputs.npz``).  For each scenario of
``_torch_encdec_jax.SCENARIOS`` the rank lays the whole parameters out by
``param_pspecs`` of
``ParallelPlan(mode="dsp", zero=True)`` (seamless-m4t-large-v2's plan),
keeps its slices, and runs ``encdec_loss(sharder=)`` with remat on its
shard of the batch (``lm.shard_lm_batch``) under the joint
``dsp_schedule``, then writes to ``dir/rank<r>.npz``: its coordinate,
the loss and grads summed by ``allreduce_grads`` and the clip's norm,
each grad slice with its place in the whole leaf, and the
``torch.distributed`` calls and bytes of that step.  Every rank waits at
a barrier, then leaves the group, before it exits."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    shard_lm_batch, tree_leaves, tree_map)
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs,
    shard_params, slice_index, tree_map_with_path)
from repro_torch.train.trainer import allreduce_grads, slices_norm  # noqa

from _torch_dsp_jax import unflatten  # noqa: E402
from _torch_encdec_jax import (BATCH, S_DEC, S_ENC, SCENARIOS,  # noqa: E402
                               config)
from _torch_lmdsp_worker import KINDS  # noqa: E402

PLAN = ParallelPlan(mode="dsp", zero=True)


def scenario(out, name, cfg, params_np, batch, shape):
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    whole = bridge.params_from_numpy(params_np, device="cpu")
    specs = param_pspecs(whole, PLAN, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, PLAN, schedule=ED.dsp_schedule(
        cfg, shape[1], s_enc=S_ENC, s_dec=S_DEC, batch=BATCH, joint=True),
        param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([sharder.dp_index, sharder.sp_index])
    out[f"{name}/local_shapes"] = np.array(
        [local["feats"].shape[1], local["tokens"].shape[1]])
    dsp.reset_calls()
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = ED.encdec_loss(leaves, local, cfg, sharder=sharder,
                             backend="ref")
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    norm = slices_norm(gtree, specs, ctx)
    out[f"{name}/step/calls"] = np.array([dsp.calls.get(k, 0)
                                          for k in KINDS])
    out[f"{name}/step/bytes"] = np.array([dsp.volume.get(k, 0)
                                          for k in KINDS])
    dsp.reset_calls()
    out[f"{name}/loss"] = total
    out[f"{name}/norm"] = norm

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
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        for name, (cname, shape) in SCENARIOS.items():
            cfg = config(ED, cname, torch.float32)
            batch = {k: torch.from_numpy(raw[f"{cname}/{k}"])
                     for k in ("feats", "tokens", "labels")}
            batch["tokens"] = batch["tokens"].long()
            batch["labels"] = batch["labels"].long()
            params_np = unflatten(dict(np.load(os.path.join(
                work, f"params_{cname}.npz"))))
            scenario(out, name, cfg, params_np, batch, shape)
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
