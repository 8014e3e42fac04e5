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

``--mesh dp,mp`` trains the t2d family under DSP on a ``("data",
"model")`` process mesh, one rank per process under ``torchrun`` (NCCL on
the card, gloo with ``--device cpu``):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch transformer2d-720m --mesh 1,4

Every rank draws the same global batch and trains on its shard (batch
over ``data``, frames over ``model``) with the joint plan of
``dsp_schedule`` through ``t2d_loss(mesh=...)``; the ``Trainer`` sums the
grads over the world.  The plan is priced in bytes (``topology=None``):
the JAX CLI prices it on its TPU link constants, which the port does not
carry.

``--device`` defaults to ``cuda``.  The JAX CLI's checkpoint, elastic,
device-count and compression flags, and ``--mesh`` for the LM family, are
not ported yet and exit with a message.
"""
import argparse
import sys

NOT_PORTED = ("ckpt_dir", "replan", "devices")
NOT_PORTED_SWITCHES = ("resume", "grad_compress")


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
                         "(t2d family, under torchrun)")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help="not yet ported")
    for flag in NOT_PORTED_SWITCHES:
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help="not yet ported")
    args = ap.parse_args(argv)
    for flag in NOT_PORTED + NOT_PORTED_SWITCHES:
        if getattr(args, flag) not in (None, False):
            raise SystemExit(f"--{flag.replace('_', '-')}: not yet ported")
    if args.grad_accum < 1 or args.batch % args.grad_accum:
        raise SystemExit(f"--batch {args.batch} does not split into "
                         f"--grad-accum {args.grad_accum} microbatches")

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer2d as t2d
    from repro_torch.models.lm import init_lm, lm_loss
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    spec = configs.get(args.arch)
    cfg = spec.config if args.full else spec.smoke
    if args.mesh is not None and spec.family != "t2d":
        raise SystemExit(f"--mesh for the {spec.family} family: not yet "
                         f"ported")
    device = resolve_device(args.device)
    mesh = None
    if spec.family == "t2d":
        spatial = args.seq // 8 or 16
        psched = None
        if args.mesh is not None:
            from repro_torch.launch.mesh import make_mesh
            dp, mp = (int(a) for a in args.mesh.split(","))
            mesh = make_mesh((dp, mp), ("data", "model"), device.type)
            psched = t2d.dsp_schedule(cfg, mp, t_len=8, s_len=spatial,
                                      batch=args.batch, topology=None,
                                      joint=True)
        params = t2d.init_t2d(0, cfg, device=device)
        dcfg = DataConfig(task="video", batch=args.batch, temporal=8,
                          spatial=spatial, in_dim=cfg.in_dim)

        def loss_fn(p, b):
            return t2d.t2d_loss(p, b, cfg, backend="kernel", mesh=mesh,
                                schedule=psched)

        def make(step):
            batch = t2d.model_dtype_batch(make_batch(dcfg, step,
                                                     device=device), cfg)
            return batch if mesh is None else t2d.shard_video_batch(batch,
                                                                    mesh)
    else:
        params = init_lm(0, cfg, device=device)
        dcfg = DataConfig(task="lm_shift", vocab=cfg.vocab, seq=args.seq,
                          batch=args.batch)

        def loss_fn(p, b):
            return lm_loss(p, b, cfg, backend="kernel")

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
                          log_every=max(args.steps // 10, 1)),
        data_fn=data_fn, device=device, mesh=mesh)
    out = trainer.run()
    first = out["history"][0][1] if out["history"] else float("nan")
    last = out["history"][-1][1] if out["history"] else float("nan")
    # one write: the ranks under torchrun share the stream, and a write of
    # under PIPE_BUF bytes is not interleaved with another rank's
    sys.stdout.write(f"history: {out['history']}\n"
                     f"stragglers: {out['stragglers']}\n"
                     f"loss {first:.4f} -> {last:.4f}\n")
    sys.stdout.flush()
    return out


if __name__ == "__main__":
    import logging
    logging.basicConfig(level=logging.INFO)
    main()
