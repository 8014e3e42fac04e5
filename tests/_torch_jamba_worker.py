"""One rank of the port's jamba-1.5-large-398b checks on a mesh over gloo
on the CPU.

    python tests/_torch_jamba_worker.py <rank> <world> <dir>

``tests/test_torch_jamba_dsp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, beside ``params.npz`` (JAX's init of jamba's
SMOKE config) and ``inputs.npz``.  On each mesh of
``_torch_jamba_jax.MESHES`` the rank writes to ``dir/rank<r>.npz``:

* under the spec's plan (``dsp`` + ``ep`` + ZeRO-3): its coordinate; the
  shapes of one period's expert leaves as ``Sharder.whole`` reads them;
  its ``forward(sharder=)`` shard with each MoE call's experts for its
  tokens (``chip_smoke.moe_calls``); ``lm_loss(sharder=)`` with remat and
  without the load-balance aux (JAX's side is the cross-entropy), the
  loss and grads summed by ``allreduce_grads`` and the clip's norm
  (``slices_norm``), each grad slice with its place in the whole leaf;
  and the calls and bytes of that step;
* under ``dsp`` + ``ep`` with ZeRO off (the serving plan): the prefill's
  logits (the rank's vocab chunk) with its calls and bytes and each MoE
  call's experts for its tokens, one decode step's logits with its calls
  and bytes beside ``lm.serve_contract``, and ``generate``'s tokens.

Every rank waits at a barrier, then leaves the group, before it exits."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import jamba_1_5_large_398b as TJ  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models.lm import tree_map  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs, shard_params,
    slice_index, tree_map_with_path)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.train.trainer import allreduce_grads, slices_norm  # noqa

from chip_smoke import moe_calls  # noqa: E402
from _torch_dsp_jax import unflatten  # noqa: E402
from _torch_jamba_jax import (BATCH, MAX_LEN, MESHES, NEW,  # noqa: E402
                              PROMPT, SEQ, SERVE_PLAN, TRAIN_PLAN)
from _torch_moe_serve_worker import contract, counts  # noqa: E402


def plan_of(mode_ep_zero) -> ParallelPlan:
    mode, ep, zero = mode_ep_zero
    return ParallelPlan(mode=mode, ep=ep, zero=zero)


def _shape(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree.shape)


def train(out, name, cfg, whole, batch, shape):
    plan = plan_of(TRAIN_PLAN)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    specs = param_pspecs(whole, plan, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, plan, schedule=TL.dsp_schedule(
        cfg, shape[1], seq=SEQ, batch=BATCH, joint=True), param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
    moe_key = next(k for k, v in params["periods"].items() if "moe" in v)
    one = TL.unstack(params["periods"], cfg.n_periods)[0]
    read = sharder.whole(one, "periods")[moe_key]["moe"]
    out[f"{name}/expert_shape"] = np.array(read["wi"].shape)
    with torch.no_grad(), moe_calls() as calls:
        out[f"{name}/out"] = TL.forward(params, local["tokens"], cfg,
                                        sharder=sharder, remat=False)[0]
    for i, call in enumerate(calls):
        out[f"{name}/route{i}/experts"] = call["experts"]
    dsp.reset_calls()
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = TL.lm_loss(leaves, local, cfg, sharder=sharder,
                         aux_weight=0.0)
    grads = iter(torch.autograd.grad(loss, TL.tree_leaves(leaves)))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    slices_norm(gtree, specs, ctx)                  # the clip's all-reduce
    out[f"{name}/step"] = counts()
    out[f"{name}/loss"] = total

    def save(path, g, spec):
        key = "/".join(path)
        out[f"{name}/grad/{key}"] = g
        out[f"{name}/index/{key}"] = np.array(
            slice_index(_shape(whole, path), spec, ctx))
    tree_map_with_path(save, gtree, specs)


def serve(out, name, cfg, whole, prompts, shape):
    plan = plan_of(SERVE_PLAN)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    eng = ServingEngine(whole, cfg, max_len=MAX_LEN, mesh=mesh, plan=plan,
                        device="cpu")
    key = f"{name}/serve"
    out[f"{key}/coord"] = np.array([eng.sharder.dp_index,
                                    eng.sharder.sp_index])
    dsp.reset_calls()
    with moe_calls() as calls:
        logits, caches = eng._prefill(prompts[:, :PROMPT])
    eng.next_tokens(logits)
    out[f"{key}/prefill"] = logits
    out[f"{key}/prefill_counts"] = counts()
    for i, call in enumerate(calls):
        out[f"{key}/route{i}/experts"] = call["experts"]
    logits, _ = eng._decode(prompts[:, PROMPT:PROMPT + 1], caches)
    eng.next_tokens(logits)
    out[f"{key}/decode"] = logits
    out[f"{key}/decode_counts"] = counts()
    out[f"{key}/decode_contract"] = contract(TL.serve_contract(
        cfg, shape[1], whole, plan, dp=shape[0], decode=BATCH))
    out[f"{key}/generate"] = eng.generate(prompts[:, :PROMPT], NEW,
                                          check_sharding=True)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        cfg = TJ.SMOKE
        raw = {k: torch.from_numpy(v).long() for k, v in
               np.load(os.path.join(work, "inputs.npz")).items()}
        batch = {k: raw[k] for k in ("tokens", "labels")}
        whole = bridge.params_from_numpy(unflatten(dict(np.load(
            os.path.join(work, "params.npz")))), device="cpu")
        for name, shape in MESHES.items():
            train(out, name, cfg, whole, batch, shape)
            serve(out, name, cfg, whole, raw["prompts"], shape)
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
