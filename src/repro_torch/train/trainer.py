"""Training loop (counterpart of ``repro.train.trainer``).

``make_train_step`` builds the (params, opt_state, batch) -> ... update:
loss and grads through ``torch.autograd``, optional gradient accumulation
over a leading microbatch dim, then AdamW.  With a mesh, each rank's loss
and grads are its shard's share of the global mean's (``t2d_loss`` with
``mesh=``), and one all-reduce of one flattened f32 bucket sums them over
the whole world before clipping and AdamW, so the clip (``clip_scale``)
sees the global gradient and the logged loss is the global one.  ``Trainer``
owns the host loop: deterministic data from a step-indexed ``data_fn``, a
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

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0      # step slower than 3x EMA => flagged
    grad_compress: bool = False        # int8 EF compression: not yet ported


def allreduce_grads(loss: torch.Tensor, grads):
    """Sum the loss and every gradient over the whole world in one
    all-reduce of one flattened f32 bucket, each grad copied into its
    slice (no f32 copy of the tree beside it); returns (loss, grads) with
    the grads as f32 views of the bucket."""
    leaves = tree_leaves(grads) + [loss.reshape(1)]
    sizes = [g.numel() for g in leaves]
    bucket = torch.empty(sum(sizes), dtype=torch.float32, device=loss.device)
    for part, g in zip(bucket.split(sizes), leaves):
        part.copy_(g.reshape(-1))
    dsp.all_reduce(bucket)
    parts = iter(bucket.split(sizes))
    grads = tree_map(lambda g: next(parts).view(g.shape), grads)
    return next(parts)[0], grads


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig, *,
                    grad_accum: int = 1, mesh=None):
    """loss_fn(params, batch) -> (scalar, metrics dict).

    With grad_accum > 1, ``batch`` leaves carry a leading (grad_accum,
    micro...) dim; gradients are summed in f32 over the microbatches, one
    after another, and averaged.  With ``mesh``, the loss and the grads are
    then summed over the world (``allreduce_grads``).
    """

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
            loss, grads = allreduce_grads(loss, grads)
        params, opt_state, om = apply_adamw(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return step


class Trainer:
    """The host loop on ``device`` (default the card; raises when CUDA is
    missing unless given ``device="cpu"``).  ``params`` must lie there.
    With ``mesh``, ``data_fn`` gives the rank's shard and ``loss_fn`` its
    share of the global loss (``make_train_step``)."""

    def __init__(self, *, loss_fn, params, opt_cfg: OptConfig,
                 cfg: TrainerConfig, data_fn: Callable[[int], Any],
                 ckpt_dir: Optional[str] = None, device="cuda", mesh=None):
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
                                       grad_accum=cfg.grad_accum, mesh=mesh)
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
