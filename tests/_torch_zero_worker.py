"""One rank of the port's parameter-layout checks (ZeRO-3, the vocab ring)
over gloo on the CPU.

    python tests/_torch_zero_worker.py <rank> <world> <dir>

``tests/test_torch_param_layouts.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params_<config>
.npz``, ``inputs.npz``).  For each scenario of
``_torch_zero_jax.SCENARIOS`` the rank lays out the whole parameters by
``param_pspecs`` of the scenario's plan and keeps its slices
(``shard_params``), then writes to ``dir/rank<r>.npz``: its coordinate;
its ``forward(sharder=)`` shard; ``lm_loss(sharder=)`` on its batch shard
with remat, the loss and grads summed by ``allreduce_grads`` and the
clip's norm (``slices_norm``), the grads gathered whole
(``unshard_params``); and the ``torch.distributed`` calls and bytes of
that step beside its contract (``lm.remat_step`` of
``collective_contract`` plus ``lm.param_contract``).  Then ``TRAIN``:
``TRAIN_STEPS`` steps of the ``Trainer`` with the slices, each step's
loss and grad norm, and the parameters gathered whole after them."""
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
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, make_sharder, mesh_sizes, param_pspecs, shard_params,
    unshard_params)
from repro_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig, allreduce_grads, slices_norm)

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_jax import BATCH, SEQ, VOCAB, configs  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_zero_jax import PLANS, SCENARIOS  # noqa: E402

# the Trainer check: the hybrid config on a (2, 2) mesh under ZeRO-3 and
# the vocab ring, against one rank's plan-none Trainer.  AdamW's eps is
# 1e-3: at 1e-8 its first updates divide grads near 1e-8 by themselves,
# which turns the f32 summation-order noise between 4 ranks and one into
# gaps of 1e-5 to 1e-4 of a leaf after 3 steps (lr 1e-2: the wv weights,
# the zero-initialised conv bias and dt bias)
TRAIN = ("hybrid", (2, 2), "zero_vocab")
TRAIN_STEPS = 3
TRAIN_OPT = OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                      eps=1e-3)


def plan_of(pname: str) -> ParallelPlan:
    zero, vocab = PLANS[pname]
    return ParallelPlan(mode="dsp", zero=zero, shard_vocab=vocab)


def train_batch(step: int):
    """The global batch of Trainer step ``step``: seeded tokens and
    labels, the same on every rank and in the test."""
    rng = np.random.RandomState(100 + step)
    return {k: torch.from_numpy(rng.randint(0, VOCAB, (BATCH, SEQ))).long()
            for k in ("tokens", "labels")}


def counts(out, name):
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{name}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    dsp.reset_calls()


def setup(cfg, params_np, shape, plan):
    """(mesh context, specs, the rank's slices, the sharder)."""
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    whole = bridge.params_from_numpy(params_np, device="cpu")
    specs = param_pspecs(whole, plan, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, plan, schedule=TL.dsp_schedule(
        cfg, shape[1], seq=SEQ, batch=BATCH, joint=True), param_specs=specs)
    return ctx, specs, whole, shard_params(whole, specs, ctx), sharder


def scenario(out, name, cfg, params_np, batch, shape, plan):
    ctx, specs, whole, params, sharder = setup(cfg, params_np, shape, plan)
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{name}/coord"] = np.array([sharder.dp_index, sharder.sp_index])
    hooks = TL.remat_step(TL.collective_contract(
        cfg, shape[1], *local["tokens"].shape))
    layout = TL.param_contract(cfg, whole, plan, mesh_sizes(ctx))
    for part in ("calls", "bytes"):
        out[f"{name}/contract_{part}"] = np.array(
            [hooks[part].get(k, 0) + layout[part].get(k, 0) for k in KINDS])
    with torch.no_grad():
        out[f"{name}/out"] = TL.forward(params, local["tokens"], cfg,
                                        sharder=sharder, remat=False)[0]
    dsp.reset_calls()
    flat = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = TL.lm_loss(params, local, cfg, sharder=sharder)
    grads = iter(torch.autograd.grad(loss, flat))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    norm = slices_norm(gtree, specs, ctx)
    counts(out, f"{name}/step")
    out[f"{name}/loss"] = total
    out[f"{name}/norm"] = norm
    for path, g in flatten(unshard_params(gtree, specs, ctx)).items():
        out[f"{name}/grad/{path}"] = g
    dsp.reset_calls()


def train(out, cfg, params_np):
    _, shape, pname = TRAIN
    ctx, specs, _, params, sharder = setup(cfg, params_np, shape,
                                           plan_of(pname))
    trainer = Trainer(
        loss_fn=lambda p, b: TL.lm_loss(p, b, cfg, sharder=sharder),
        params=params, opt_cfg=TRAIN_OPT,
        cfg=TrainerConfig(total_steps=TRAIN_STEPS, log_every=1),
        data_fn=lambda s: TL.shard_lm_batch(train_batch(s), sharder),
        device="cpu", sharder=sharder)
    metrics = []
    inner = trainer.step_fn

    def step(*args):
        res = inner(*args)
        metrics.append([float(res[2]["loss"]), float(res[2]["grad_norm"])])
        return res
    trainer.step_fn = step
    trainer.run()
    out["train/metrics"] = np.array(metrics)
    for path, p in flatten(unshard_params(trainer.params, specs,
                                          ctx)).items():
        out[f"train/param/{path}"] = p


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

        def params_np(cname):
            return unflatten(dict(np.load(os.path.join(
                work, f"params_{cname}.npz"))))
        for name, (cname, shape, pname) in SCENARIOS.items():
            scenario(out, name, cfgs[cname], params_np(cname), batch, shape,
                     plan_of(pname))
        train(out, cfgs[TRAIN[0]], params_np(TRAIN[0]))
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
