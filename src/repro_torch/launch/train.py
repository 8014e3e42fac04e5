"""Training CLI: ``python -m repro_torch.launch.train --arch <id>``.

Trains the architecture's SMOKE config (``--full``: the published config)
from random weights drawn from a seed, through the port's ``Trainer`` with
AdamW, on one device: the LM family on the ``lm_shift`` task, the 2D DiT
(t2d family) on ``video`` batches of 8 frames of ``--seq // 8`` patches
(16 when that is 0), as the JAX CLI does.  Flash attention and
the SSD scan run as the CUDA kernels on the card (``backend="kernel"``;
the JAX CLI uses "ref" because it runs on a CPU), each with its backward
recomputed through a plain reference; with ``--device cpu`` the kernels'
plain versions stand in.  ``--grad-accum N`` splits each batch of ``--batch``
sequences into N microbatches.

``--mesh dp,mp`` trains under DSP on a ``("data", "model")`` process
mesh, one rank per process under ``torchrun`` (NCCL on the card, gloo
with ``--device cpu``):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch transformer2d-720m --mesh 1,4

Every rank draws the same global batch and trains on its shard (batch
over ``data``; frames, or an LM's tokens, over ``model``) with the joint
plan of the family's ``dsp_schedule``, under its spec's own plan
(``param_pspecs``, ``shard_params``): ZeRO-3 splits each weight over
``("data", "model")``, each rank holding its slices and their AdamW
state, and the ``Trainer`` sums each grad over the dims its leaf is not
split over.  The LM family runs ``lm_loss(sharder=...)``, with
``shard_vocab`` splitting the embedding tables over ``model`` (the vocab
ring); the 2D DiT runs ``t2d_loss(mesh=..., param_specs=...)``, each
group of block pairs gathering its weights inside its checkpoint:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch transformer2d-720m --mesh 2,2
    ... plan ParallelPlan(mode='dsp', ep=False, zero=True, shard_vocab=False)

The summary prints the plan run.  The plan is priced in bytes
(``topology=None``): the JAX CLI prices it on its TPU link constants,
which the port does not carry.

``--ckpt-dir`` checkpoints every ``--steps // 4`` steps and at the end
(each rank its slices), ``--resume`` continues from the latest
checkpoint, resharded onto this run's mesh (a DiT run saved at ``--mesh
2,2`` resumes at ``--mesh 1,4``), and ``--replan N`` then resizes the LM
family's run onto the first N ranks (re-solving the plan; the ranks past
N leave with no steps):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-14b --mesh 2,2 --ckpt-dir ck --steps 40
    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen3-14b --mesh 2,2 --ckpt-dir ck --steps 80 --resume \
        --replan 2

``--backend gloo`` lets several ranks share one card (NCCL takes one rank
a card).  MoE (qwen2-moe-a2.7b) trains under its spec's plan, ``ep`` with
ZeRO-3: each rank runs its block of experts on the tokens the dispatch
brings it.  mistral-large-123b trains under its spec's ``tp`` with ZeRO-3
over ``data``: each rank runs its heads and hidden columns over the
whole sequence, gathered into each block and reduce-scattered out of it
(no switching schedule):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch mistral-large-123b --mesh 1,4
    ... plan ParallelPlan(mode='tp', ep=False, zero=True, shard_vocab=True)

arctic-480b trains under its spec's ``tp`` with ``ep`` and ZeRO-3:
attention and the dense residual MLP tensor-parallel, the 128 routed
experts split over the same ``model`` ranks, each rank running its
experts on the tokens the dispatch brings it from its sequence shard:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch arctic-480b --mesh 1,4
    ... plan ParallelPlan(mode='tp', ep=True, zero=True, shard_vocab=True)

seamless-m4t-large-v2 (the enc-dec family) trains on ``encdec``
batches of ``--seq`` audio frames and ``--seq // 2`` decoder tokens, as
the JAX CLI does, and under ``--mesh`` its spec's plan (``dsp`` with
ZeRO-3: each rank its shard of both sequences, cross-attention switching
the decoder's shard to heads beside the encoder K/V's own switch):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch seamless-m4t-large-v2 --mesh 1,4
    ... plan ParallelPlan(mode='dsp', ep=False, zero=True, shard_vocab=True)

It takes no ``--replan``: JAX's train CLI builds its elastic spec for the
LM family alone, so ``Trainer.replan`` has no enc-dec counterpart there
either (ROADMAP, standing notes).

``--grad-compress`` runs the summed grads through error-feedback int8
compression.  ``--device`` defaults to ``cuda``.  The JAX CLI's
``--devices`` (simulated host devices) has no counterpart: ``torchrun
--nproc-per-node`` starts the ranks.
"""
import argparse
import os
import sys

NOT_PORTED = ("devices",)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu for tests)")
    ap.add_argument("--mesh", default=None,
                    help="dp,mp: DSP over a (data, model) process mesh "
                         "(under torchrun)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend of --mesh (default: the "
                         "device's)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--replan", type=int, default=0,
                    help="elastic resize onto the first N ranks after "
                         "resume (the LM family)")
    ap.add_argument("--grad-compress", action="store_true")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help="not yet ported")
    args = ap.parse_args(argv)
    if args.devices is not None:
        raise SystemExit("--devices: not yet ported; torchrun "
                         "--nproc-per-node N starts the port's N ranks")
    if args.grad_accum < 1 or args.batch % args.grad_accum:
        raise SystemExit(f"--batch {args.batch} does not split into "
                         f"--grad-accum {args.grad_accum} microbatches")

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer2d as t2d
    from repro_torch.models.lm import init_lm, lm_loss, shard_lm_batch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.partition import (mesh_sizes, param_pspecs,
                                                shard_params)
    from repro_torch.train.trainer import ElasticSpec, Trainer, TrainerConfig

    spec = configs.get(args.arch)
    cfg = spec.config if args.full else spec.smoke
    device = resolve_device(args.device)
    mesh = ctx = None
    ran = "none (one rank)"
    if args.mesh is not None:
        from repro_torch.core.layout import from_mesh
        from repro_torch.launch.mesh import make_mesh
        dp, mp = (int(a) for a in args.mesh.split(","))
        if device.type == "cuda":
            import torch
            # a rank a card, or (gloo) ranks sharing the cards there are
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        mesh = make_mesh((dp, mp), ("data", "model"), device.type,
                         backend=args.backend)
        ctx = from_mesh(mesh)
        ran = f"{spec.plan}"
    sharder = elastic = param_specs = psched = None
    if spec.family == "encdec" and args.replan:
        raise SystemExit("--replan: the enc-dec family has no elastic "
                         "resize, as in JAX's train CLI (ROADMAP, standing "
                         "notes)")
    if spec.family == "encdec":
        from repro_torch.models import encdec as ED
        from repro_torch.parallel.partition import make_sharder
        params = ED.init_encdec(0, cfg, device=device)
        s_enc, s_dec = args.seq, args.seq // 2
        if mesh is not None:
            specs = param_pspecs(params, spec.plan,
                                 axis_sizes=mesh_sizes(ctx))
            params = shard_params(params, specs, ctx)
            sharder = make_sharder(mesh, spec.plan, schedule=ED.dsp_schedule(
                cfg, mp, s_enc=s_enc, s_dec=s_dec, batch=args.batch,
                joint=True), param_specs=specs)
        dcfg = DataConfig(task="encdec", vocab=cfg.vocab, seq=s_dec,
                          enc_seq=s_enc, batch=args.batch,
                          frontend_dim=cfg.frontend_dim)

        def loss_fn(p, b):
            if sharder is None:
                return ED.encdec_loss(p, b, cfg, backend="kernel")
            return ED.encdec_loss(p, shard_lm_batch(b, sharder), cfg,
                                  sharder=sharder, backend="kernel")

        def make(step):
            return make_batch(dcfg, step, device=device)
    elif spec.family == "t2d":
        spatial = args.seq // 8 or 16
        params = t2d.init_t2d(0, cfg, device=device)
        if mesh is not None:
            psched = t2d.dsp_schedule(cfg, mp, t_len=8, s_len=spatial,
                                      batch=args.batch, topology=None,
                                      joint=True)
            param_specs = param_pspecs(params, spec.plan,
                                       axis_sizes=mesh_sizes(ctx))
            params = shard_params(params, param_specs, ctx)
        dcfg = DataConfig(task="video", batch=args.batch, temporal=8,
                          spatial=spatial, in_dim=cfg.in_dim)

        def loss_fn(p, b):
            return t2d.t2d_loss(p, b, cfg, backend="kernel", mesh=mesh,
                                schedule=psched, param_specs=param_specs)

        def make(step):
            batch = t2d.model_dtype_batch(make_batch(dcfg, step,
                                                     device=device), cfg)
            return batch if mesh is None else t2d.shard_video_batch(batch,
                                                                    mesh)
    else:
        from repro_torch.models.lm import dsp_schedule
        params = init_lm(0, cfg, device=device)

        def solve_schedule(sp):
            return dsp_schedule(cfg, sp, seq=args.seq, batch=args.batch,
                                joint=True)
        if spec.plan.mode == "tp":
            solve_schedule = None       # tp's blocks switch nothing

        # the loss cuts the rank's shard of the global batch, so that
        # --replan rebuilds it for the resized mesh
        def make_loss(m, sh, sched):
            if sh is None:
                return lambda p, b: lm_loss(p, b, cfg, backend="kernel")
            return lambda p, b: lm_loss(p, shard_lm_batch(b, sh), cfg,
                                        sharder=sh, backend="kernel")
        elastic = ElasticSpec(make_loss=make_loss,
                              solve_schedule=solve_schedule, plan=spec.plan)
        if mesh is not None:
            from repro_torch.parallel.partition import make_sharder
            specs = param_pspecs(params, spec.plan,
                                 axis_sizes=mesh_sizes(ctx))
            params = shard_params(params, specs, ctx)
            sharder = make_sharder(
                mesh, spec.plan, schedule=None if solve_schedule is None
                else solve_schedule(mp), param_specs=specs)
        dcfg = DataConfig(task="lm_shift", vocab=cfg.vocab, seq=args.seq,
                          batch=args.batch)
        loss_fn = make_loss(mesh, sharder, None)

        def make(step):
            return make_batch(dcfg, step, device=device)

    def data_fn(step):
        batch = make(step)
        if args.grad_accum > 1:
            batch = {k: v.reshape(args.grad_accum, -1, *v.shape[1:])
                     for k, v in batch.items()}
        return batch

    trainer = Trainer(
        loss_fn=loss_fn, params=params,
        opt_cfg=OptConfig(peak_lr=args.lr,
                          warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        cfg=TrainerConfig(total_steps=args.steps, grad_accum=args.grad_accum,
                          log_every=max(args.steps // 10, 1),
                          ckpt_every=max(args.steps // 4, 1) if args.ckpt_dir
                          else 0, grad_compress=args.grad_compress),
        data_fn=data_fn, ckpt_dir=args.ckpt_dir, device=device,
        mesh=mesh if sharder is None else None, sharder=sharder,
        param_specs=param_specs,
        schedule=None if psched is None else psched.schedule,
        elastic=elastic)
    if args.resume:
        trainer.try_resume()
    if args.replan:
        trainer.replan(args.replan)
    out = trainer.run()
    first = out["history"][0][1] if out["history"] else float("nan")
    last = out["history"][-1][1] if out["history"] else float("nan")
    # one write: the ranks under torchrun share the stream, and a write of
    # under PIPE_BUF bytes is not interleaved with another rank's
    sys.stdout.write(f"history: {out['history']}\n"
                     f"stragglers: {out['stragglers']}\n"
                     f"plan {ran}\n"
                     f"loss {first:.4f} -> {last:.4f}\n")
    sys.stdout.flush()
    return out


if __name__ == "__main__":
    import logging
    from repro_torch.launch.mesh import close_world
    logging.basicConfig(level=logging.INFO)
    main()
    close_world()
