"""One rank of the port's VLM checks on a mesh over gloo on the CPU.

    python tests/_torch_vlm_worker.py <rank> <world> <dir>

``tests/test_torch_vlm.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, beside ``params.npz`` and ``inputs.npz``.  On
each mesh of ``_torch_vlm_jax.MESHES`` the rank lays pixtral-12b's SMOKE
parameters out by ``param_pspecs`` of its spec's plan (``dsp`` +
ZeRO-3), keeps its slices, takes its shard of the batch
(``lm.shard_lm_batch``: its batch slice of the patch embeddings whole,
its sequence chunk of the tokens), and writes to ``dir/rank<r>.npz``:
its coordinate, its ``forward(sharder=, extra=)`` shard, and
``lm_loss(sharder=)`` with remat, the loss and grads summed by
``allreduce_grads`` and the clip's norm (``slices_norm``), the grads
gathered whole (``unshard_params``), with
the calls and bytes of that step beside its contract
(``lm.remat_step`` of ``collective_contract`` plus
``lm.param_contract(patches=True)``)."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import pixtral_12b as TP  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    make_sharder, mesh_sizes, param_pspecs, shard_params, unshard_params)
from repro_torch.train.trainer import (  # noqa: E402
    allreduce_grads, slices_norm)

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_vlm_jax import BATCH, MESHES, SEQ  # noqa: E402


def scenario(out, name, shape, whole, batch):
    cfg, plan = TP.SMOKE, TP.SPEC.plan
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    sizes = mesh_sizes(ctx)
    specs = param_pspecs(whole, plan, axis_sizes=sizes)
    sharder = make_sharder(mesh, plan, schedule=TL.dsp_schedule(
        cfg, shape[1], seq=SEQ, batch=BATCH, joint=True), param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
    hooks = TL.remat_step(TL.collective_contract(
        cfg, shape[1], *local["tokens"].shape))
    layout = TL.param_contract(cfg, whole, plan, sizes, patches=True)
    for part in ("calls", "bytes"):
        out[f"{name}/contract_{part}"] = np.array(
            [hooks[part].get(k, 0) + layout[part].get(k, 0) for k in KINDS])
    with torch.no_grad():
        out[f"{name}/out"] = TL.forward(
            params, local["tokens"], cfg, sharder=sharder, remat=False,
            extra=local["extra"])[0].numpy()
    dsp.reset_calls()
    flat = [p.requires_grad_(True) for p in TL.tree_leaves(params)]
    loss, _ = TL.lm_loss(params, local, cfg, sharder=sharder)
    grads = iter(torch.autograd.grad(loss, flat))
    total, gtree = allreduce_grads(loss.detach(), TL.tree_map(
        lambda p: next(grads), params), specs, ctx)
    slices_norm(gtree, specs, ctx)
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{name}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    out[f"{name}/loss"] = total.numpy()
    for path, g in flatten(unshard_params(gtree, specs, ctx)).items():
        out[f"{name}/grad/{path}"] = g.numpy()
    dsp.reset_calls()


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        batch = {k: torch.from_numpy(raw[k]).long()
                 for k in ("tokens", "labels")}
        batch["extra"] = {"patch_embeds": torch.from_numpy(
            raw["patch_embeds"])}
        whole = bridge.params_from_numpy(unflatten(dict(np.load(
            os.path.join(work, "params.npz")))), device="cpu")
        for name, shape in MESHES.items():
            scenario(out, name, shape, whole, batch)
    finally:
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
