"""One rank of the port's LM-under-DSP checks over gloo on the CPU.

    python tests/_torch_lmdsp_worker.py <rank> <world> <dir>

``tests/test_torch_lm_dsp.py`` starts ``world`` (8) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params_<config>
.npz``, ``inputs.npz``).  Each rank first runs the scenarios of
``_torch_lmdsp_jax.SCENARIOS`` whose mesh spans all 8 ranks, then ranks
0-3 open a world of 4 for the (1, 4) ones.  Per scenario it writes to
``dir/rank<r>.npz`` its coordinate, its forward shard, its loss and
grads summed over the world (``allreduce_grads``), and the
``torch.distributed`` calls and bytes of each (``core.dsp``'s counters)
beside ``lm.collective_contract``'s for one forward."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder)
from repro_torch.train.trainer import allreduce_grads  # noqa: E402

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_jax import BATCH, SCENARIOS, SEQ, configs  # noqa: E402

KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
         "collective-permute")
PLAN = ParallelPlan(mode="dsp", zero=False, shard_vocab=False)


def counted(out, name):
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{name}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    dsp.reset_calls()


def scenario(out, name, cfg, params_np, batch, shape, fused):
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    sharder = make_sharder(mesh, PLAN, schedule=TL.dsp_schedule(
        cfg, shape[1], seq=SEQ, batch=BATCH, joint=True))
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([sharder.dp_index, sharder.sp_index])
    contract = TL.collective_contract(cfg, shape[1], *local["tokens"].shape,
                                      fused_switch=fused)
    out[f"{name}/contract"] = np.array([contract["calls"].get(k, 0)
                                        for k in KINDS])
    out[f"{name}/contract_bytes"] = np.array([contract["bytes"].get(k, 0)
                                              for k in KINDS])
    params = bridge.params_from_numpy(params_np, device="cpu")
    dsp.reset_calls()
    with torch.no_grad():
        out[f"{name}/out"] = TL.forward(params, local["tokens"], cfg,
                                        sharder=sharder, remat=False,
                                        fused_switch=fused)[0]
    counted(out, f"{name}/fwd")
    flat = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = TL.lm_loss(params, local, cfg, sharder=sharder, remat=True,
                         fused_switch=fused)
    grads = iter(torch.autograd.grad(loss, flat))
    total, gtree = allreduce_grads(loss.detach(),
                                   tree_map(lambda p: next(grads), params))
    counted(out, f"{name}/grad")
    out[f"{name}/loss"] = total
    for path, g in flatten(gtree).items():
        out[f"{name}/grad/{path}"] = g


def run_world(rank, world, work, store, out):
    """The scenarios whose mesh spans ``world`` ranks, in a gloo world of
    ``world`` on the FileStore ``store``."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, store), world),
        rank=rank, world_size=world)
    try:
        cfgs = configs(TL, TSSM, torch.float32)
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        batch = {k: torch.from_numpy(raw[k]).long()
                 for k in ("tokens", "labels")}
        for name, (cname, shape, fused) in SCENARIOS.items():
            if shape[0] * shape[1] != world:
                continue
            params_np = unflatten(dict(np.load(os.path.join(
                work, f"params_{cname}.npz"))))
            scenario(out, name, cfgs[cname], params_np, batch, shape, fused)
    finally:
        dist.destroy_process_group()


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    out = {}
    run_world(rank, world, work, "store8", out)
    if rank < 4:
        run_world(rank, 4, work, "store4", out)
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
