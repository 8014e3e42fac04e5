"""Training loop (counterpart of ``repro.train.trainer``).

``make_train_step`` builds the (params, opt_state, batch) -> ... update:
loss and grads through ``torch.autograd``, optional gradient accumulation
over a leading microbatch dim, then AdamW.  With a mesh, each rank's loss
and grads are its shard's share of the global mean's (``t2d_loss`` with
``mesh=``, ``lm_loss`` with a sharder), and all-reduces of flattened f32
buckets sum them over the mesh before clipping and AdamW
(``allreduce_grads``: over the whole world, or, under a sharder's
parameter layout, each leaf over the dims it is not split over), so the
clip (``clip_scale``, with ``slices_norm`` under a layout) sees the
global gradient and the logged loss is the global one.  ``Trainer`` owns
the host loop: deterministic data from a step-indexed ``data_fn``, a
step-time EMA watchdog that flags stragglers, and the loss history.

Checkpointing, elastic ``replan``, gradient compression and the retry
loop come with their slices.  A CUDA fault leaves the context
unusable, so a failed step raises rather than retrying.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.core import dsp
from repro_torch.device import resolve_device
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.optim.adamw import OptConfig, apply_adamw, init_opt_state
from repro_torch.parallel.partition import param_copies, reduce_axes

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0      # step slower than 3x EMA => flagged
    grad_compress: bool = False        # int8 EF compression: not yet ported


def allreduce_grads(loss: torch.Tensor, grads, specs=None, ctx=None):
    """Sum the loss and each rank's partial grads over the mesh, in one
    all-reduce of one flattened f32 bucket per group, each grad copied
    into its slice (no f32 copy of the tree beside it).  Without ``specs``
    every grad is summed over the whole world, with the loss.  With
    ``specs`` (``param_pspecs`` of the global tree) and the mesh's
    ``ctx``, each grad is summed over the dims its leaf is not split over
    (``reduce_axes``), one bucket per set of them in the order the leaves
    first name it, the loss in the world's: a leaf split over every dim
    (ZeRO) was summed by its reduce-scatter and is left as it is, a table
    split over ``model`` is summed over ``data``, a whole leaf over the
    world.  Returns (loss, grads), the summed grads f32 views of their
    bucket."""
    leaves = tree_leaves(grads)
    if specs is None:
        keys, world = [None] * len(leaves), None
    else:
        world = tuple(ctx.mesh.mesh_dim_names)
        keys = [reduce_axes(s, world) for s in tree_leaves(specs)]
    buckets: Dict[Any, list] = {}
    for i, key in enumerate(keys):
        if key != ():
            buckets.setdefault(key, []).append(i)
    buckets.setdefault(world, [])
    out = list(leaves)
    for key, idx in buckets.items():
        parts = [leaves[i] for i in idx]
        if key == world:
            parts.append(loss.reshape(1))
        sizes = [g.numel() for g in parts]
        bucket = torch.empty(sum(sizes), dtype=torch.float32,
                             device=loss.device)
        for part, g in zip(bucket.split(sizes), parts):
            part.copy_(g.reshape(-1))
        dsp.all_reduce(bucket, None if key is None else ctx.axes_group(key))
        views = bucket.split(sizes)
        for i, v in zip(idx, views):
            out[i] = v.view(leaves[i].shape)
        if key == world:
            loss = views[-1][0]
    it = iter(out)
    return loss, tree_map(lambda g: next(it), grads)


def slices_norm(grads, specs, ctx) -> torch.Tensor:
    """The norm of the whole gradient from this rank's slices of it
    (``specs`` their layout, ``param_pspecs`` of the global tree, summed
    by ``allreduce_grads``): each leaf's sum of squares over the number of
    ranks that hold its slice (``param_copies``), summed and all-reduced
    over the world as one scalar."""
    total = sum(torch.sum(torch.square(g.float())) / c
                for g, c in zip(tree_leaves(grads),
                                tree_leaves(param_copies(specs, ctx))))
    total = total.reshape(1)
    dsp.all_reduce(total, ctx.axes_group(tuple(ctx.mesh.mesh_dim_names)))
    return torch.sqrt(total[0])


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig, *,
                    grad_accum: int = 1, mesh=None, sharder=None):
    """loss_fn(params, batch) -> (scalar, metrics dict).

    With grad_accum > 1, ``batch`` leaves carry a leading (grad_accum,
    micro...) dim; gradients are summed in f32 over the microbatches, one
    after another, and averaged.  With ``mesh``, the loss and the grads are
    then summed over the world (``allreduce_grads``).  A ``sharder`` (the
    one ``loss_fn`` runs under) gives the mesh in its place, and with it
    the layout of the rank's ``params`` (``Sharder.param_specs``): each
    grad is then summed over the dims its leaf is not split over, and the
    clip takes the whole gradient's norm (``slices_norm``).
    """
    ctx = specs = None
    if sharder is not None and sharder.ctx is not None:
        if mesh is not None:
            raise ValueError("pass mesh= or sharder=, not both: the "
                             "sharder's mesh is the one trained on")
        ctx, specs, mesh = sharder.ctx, sharder.param_specs, sharder.ctx.mesh

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

        def grad(p):
            g = next(grads)
            return torch.zeros_like(p) if g is None else g
        return loss.detach(), metrics, tree_map(grad, leaves)

    def step(params, opt_state, batch):
        if grad_accum > 1:
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
            loss = 0.0
            for i in range(grad_accum):
                mb = tree_map(lambda t: t[i], batch)
                l_i, _, g = grads_of(params, mb)
                tree_map(lambda acc, gi: acc.add_(gi), gsum, g)
                loss = loss + l_i
            grads = tree_map(lambda g: g / grad_accum, gsum)
            loss = loss / grad_accum
            metrics: Dict[str, Any] = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if mesh is not None:
            loss, grads = allreduce_grads(loss, grads, specs, ctx)
        norm = None
        if specs is not None and opt_cfg.grad_clip is not None:
            norm = slices_norm(grads, specs, ctx)
        params, opt_state, om = apply_adamw(params, grads, opt_state, opt_cfg,
                                            norm=norm)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step


class Trainer:
    """The host loop on ``device`` (default the card; raises when CUDA is
    missing unless given ``device="cpu"``).  ``params`` must lie there.
    With ``mesh`` (or the ``sharder`` of ``loss_fn``, on a mesh),
    ``data_fn`` gives the rank's shard and ``loss_fn`` its share of the
    global loss (``make_train_step``); under the sharder's
    ``param_specs``, ``params`` are the rank's slices (``shard_params``),
    and so is the AdamW state made from them."""

    def __init__(self, *, loss_fn, params, opt_cfg: OptConfig,
                 cfg: TrainerConfig, data_fn: Callable[[int], Any],
                 ckpt_dir: Optional[str] = None, device="cuda", mesh=None,
                 sharder=None):
        if ckpt_dir is not None:
            raise NotImplementedError("checkpointing: not yet ported")
        if cfg.grad_compress:
            raise NotImplementedError("grad_compress: not yet ported")
        self.device = resolve_device(device)
        for p in tree_leaves(params):
            if p.device.type != self.device.type:
                raise ValueError(f"params lie on {p.device}, the trainer "
                                 f"runs on {self.device}")
        self.cfg = cfg
        self.data_fn = data_fn
        self.params = params
        self.opt_cfg = opt_cfg
        self.opt_state = init_opt_state(params, opt_cfg)
        self.step_fn = make_train_step(loss_fn, opt_cfg,
                                       grad_accum=cfg.grad_accum, mesh=mesh,
                                       sharder=sharder)
        self.straggler_events = []
        self.metrics_history = []

    def run(self) -> Dict[str, Any]:
        ema = None
        step = 0
        while step < self.cfg.total_steps:
            batch = self.data_fn(step)
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])      # waits for the step's work
            dt = time.monotonic() - t0
            if ema is None:
                ema = dt
            if (dt > self.cfg.straggler_factor * ema
                    and step > 2):
                self.straggler_events.append((step, dt, ema))
                log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                            step, dt, ema)
            ema = 0.9 * ema + 0.1 * dt
            step += 1
            if step % self.cfg.log_every == 0:
                self.metrics_history.append((step, loss))
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
        return {"final_step": step,
                "history": self.metrics_history,
                "stragglers": self.straggler_events}
