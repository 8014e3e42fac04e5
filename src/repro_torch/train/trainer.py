"""Training loop (counterpart of ``repro.train.trainer``).

``make_train_step`` builds the (params, opt_state, batch) -> ... update:
loss and grads through ``torch.autograd``, optional gradient accumulation
over a leading microbatch dim, then AdamW.  With a mesh, each rank's loss
and grads are its shard's share of the global mean's (``t2d_loss`` with
``mesh=``, ``lm_loss`` with a sharder), and all-reduces of flattened f32
buckets sum them over the mesh before clipping and AdamW
(``allreduce_grads``: over the whole world, or, under a parameter
layout, a sharder's or one given as ``param_specs``, each leaf over the
dims it is not split over), so the clip (``clip_scale``, with
``slices_norm`` under a layout) sees the global gradient and the logged
loss is the global one.  ``Trainer`` owns
the host loop: deterministic data from a step-indexed ``data_fn``, a
step-time EMA watchdog that flags stragglers, the loss history,
plan-aware checkpoints every ``ckpt_every`` steps and at the end
(``train.checkpoint``: each rank writes its slices, restore reshards
them), resume from the latest, error-feedback int8 compression of the
summed grads (``optim.compress``), and ``replan``: the elastic resize
onto fewer ranks, which re-solves the schedule and migrates the live
state (``ElasticSpec``).

JAX's retry loop around the device step is not ported: a CUDA fault
leaves the context unusable, so a failed step raises rather than
retrying.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core import dsp
from repro_torch.core.layout import from_mesh
from repro_torch.core.plan import JointPlan, StrategyPlan
from repro_torch.device import resolve_device
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.optim.adamw import OptConfig, apply_adamw, init_opt_state
from repro_torch.optim.compress import compress_with_feedback, init_residuals
from repro_torch.parallel.partition import (
    ParallelPlan, global_shape, make_sharder, mesh_sizes, null_sharder,
    param_copies, param_pspecs, reduce_axes, reshard, tree_map_with_path)
from repro_torch.train.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """How to rebuild the training computation on a resized mesh
    (``Trainer.replan``), as JAX's: ``make_loss(mesh, sharder, schedule)
    -> loss_fn`` rebuilds the loss for the new mesh (None at one rank),
    taking the GLOBAL batch the ``data_fn`` gives and cutting its rank's
    shard itself (``models.lm.shard_lm_batch``); ``solve_schedule(sp) ->
    Schedule`` re-solves the switching plan at the new SP degree (called
    for sp > 1; None: no schedule); ``plan`` is the ``ParallelPlan`` the
    parameters are laid out by on every mesh.  JAX's ``solve_schedule``
    also takes the resized ``Topology``: the port's LM plans are priced in
    bytes, with none."""

    make_loss: Callable[..., Callable]
    solve_schedule: Optional[Callable] = None
    plan: Any = None


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    grad_accum: int = 1
    log_every: int = 10
    ckpt_every: int = 50
    straggler_factor: float = 3.0      # step slower than 3x EMA => flagged
    grad_compress: bool = False        # int8 EF compression of the grads


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
                    grad_accum: int = 1, mesh=None, sharder=None,
                    param_specs=None, grad_compress: bool = False):
    """loss_fn(params, batch) -> (scalar, metrics dict).

    With grad_accum > 1, ``batch`` leaves carry a leading (grad_accum,
    micro...) dim; gradients are summed in f32 over the microbatches, one
    after another, and averaged.  With ``mesh``, the loss and the grads are
    then summed over the world (``allreduce_grads``).  A ``sharder`` (the
    one ``loss_fn`` runs under) gives the mesh in its place, and with it
    the layout of the rank's ``params`` (``Sharder.param_specs``): each
    grad is then summed over the dims its leaf is not split over, and the
    clip takes the whole gradient's norm (``slices_norm``).  A loss with
    no sharder (the 2D DiT's ``t2d_loss(param_specs=)``) gives the layout
    as ``param_specs`` beside ``mesh``; a sharder and ``param_specs``
    together raise.  With
    ``grad_compress`` the summed grads go through
    ``compress_with_feedback`` (each slice at its whole leaf's scale)
    before the clip, and the step takes and returns the residuals:
    (params, opt_state, batch, residuals) -> (params, opt_state,
    residuals, metrics).
    """
    ctx = specs = None
    if sharder is not None and param_specs is not None:
        raise ValueError("pass sharder= or param_specs=, not both: the "
                         "sharder's specs are the layout trained on")
    if sharder is not None and sharder.ctx is not None:
        if mesh is not None:
            raise ValueError("pass mesh= or sharder=, not both: the "
                             "sharder's mesh is the one trained on")
        ctx, specs, mesh = sharder.ctx, sharder.param_specs, sharder.ctx.mesh
    elif param_specs is not None:
        if mesh is None:
            raise ValueError("param_specs lay the parameters out on a mesh: "
                             "pass mesh= too")
        ctx, specs = from_mesh(mesh), param_specs

    def grads_of(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))

        def grad(p):
            g = next(grads)
            return torch.zeros_like(p) if g is None else g
        return loss.detach(), metrics, tree_map(grad, leaves)

    def step(params, opt_state, batch, residuals=None):
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
        if grad_compress:
            grads, residuals = compress_with_feedback(grads, residuals,
                                                      specs=specs, ctx=ctx)
        norm = None
        if specs is not None and opt_cfg.grad_clip is not None:
            norm = slices_norm(grads, specs, ctx)
        params, opt_state, om = apply_adamw(params, grads, opt_state, opt_cfg,
                                            norm=norm)
        out = {"loss": loss, **metrics, **om}
        if grad_compress:
            return params, opt_state, residuals, out
        return params, opt_state, out

    return step


class Trainer:
    """The host loop on ``device`` (default the card; raises when CUDA is
    missing unless given ``device="cpu"``).  ``params`` must lie there.
    With ``mesh`` (or the ``sharder`` of ``loss_fn``, on a mesh),
    ``data_fn`` gives the rank's shard and ``loss_fn`` its share of the
    global loss (``make_train_step``); under the sharder's
    ``param_specs``, or the ``param_specs`` given beside ``mesh`` (a loss
    with no sharder, the 2D DiT's), ``params`` are the rank's slices
    (``shard_params``), and so are the AdamW state and the residuals made
    from them.

    With ``ckpt_dir`` every rank of the world constructs the trainer
    (the ``CheckpointManager``'s group), saves its slices every
    ``cfg.ckpt_every`` steps (async) and at the end (blocking), and
    ``try_resume`` restores the latest step resharded onto this
    trainer's layout.  ``schedule`` (default the sharder's) goes into the
    manifest; ``elastic`` (``ElasticSpec``) makes ``replan`` possible."""

    def __init__(self, *, loss_fn, params, opt_cfg: OptConfig,
                 cfg: TrainerConfig, data_fn: Callable[[int], Any],
                 ckpt_dir: Optional[str] = None, device="cuda", mesh=None,
                 sharder=None, param_specs=None, schedule=None,
                 elastic: Optional[ElasticSpec] = None):
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
        self.residuals = (init_residuals(params) if cfg.grad_compress
                          else None)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.step_fn = make_train_step(loss_fn, opt_cfg,
                                       grad_accum=cfg.grad_accum, mesh=mesh,
                                       sharder=sharder,
                                       param_specs=param_specs,
                                       grad_compress=cfg.grad_compress)
        # the layout of the live state: the mesh, its context and the
        # specs of the rank's slices (None: every leaf whole)
        if sharder is not None and sharder.ctx is not None:
            mesh = sharder.ctx.mesh
        self.mesh = mesh
        self.ctx = from_mesh(mesh) if mesh is not None else None
        self.specs = (sharder.param_specs if sharder is not None
                      else param_specs)
        self.schedule = (schedule if schedule is not None
                         else getattr(sharder, "schedule", None))
        self.elastic = elastic
        self._data_axis = (self.ctx.size("data") if self.ctx is not None
                           and "data" in mesh.mesh_dim_names else 1)
        self.active = True       # False on a rank that ``replan`` dropped
        self.start_step = 0
        self.straggler_events = []
        self.metrics_history = []

    # -- the state and its layout -------------------------------------------
    def _state(self) -> Dict[str, Any]:
        tree = {"params": self.params, "opt": self.opt_state}
        if self.residuals is not None:
            tree["residuals"] = self.residuals
        return tree

    def _state_specs(self, specs=None):
        """The specs of ``_state()`` with the parameters laid out by
        ``specs`` (default: the live layout; None: every leaf whole).
        AdamW's moments and master copy and the residuals are laid out as
        their parameters (``param_pspecs`` gives the leaf names under
        ``m/``, ``v/`` and ``master/`` the parameters' specs, as JAX's
        ``_place_tree`` reads them), the step count whole."""
        specs = self.specs if specs is None else specs
        if specs is None:
            return None
        out = {"params": specs,
               "opt": {k: (() if k == "step" else specs)
                       for k in self.opt_state}}
        if self.residuals is not None:
            out["residuals"] = specs
        return out

    def _template(self):
        """``_state()`` as meta tensors of the GLOBAL shapes (ints stay):
        the template ``restore`` fills, which ``param_pspecs`` reads on a
        resize."""
        specs = self._state_specs()
        if specs is None:
            specs = tree_map_with_path(lambda *_: None, self._state())
        return tree_map_with_path(
            lambda _, t, s: t if isinstance(t, int) else torch.empty(
                global_shape(t.shape, s, self.ctx), dtype=t.dtype,
                device="meta"),
            self._state(), specs)

    # -- checkpoints -----------------------------------------------------------
    def try_resume(self):
        """Restore the latest checkpoint (any layout it was saved in)
        onto this trainer's, and continue from its step."""
        if self.ckpt is None:
            return
        latest = self.ckpt.latest_step()
        if latest is None:
            return
        specs = self._state_specs()
        template = self._template()
        self.params = self.opt_state = self.residuals = None   # freed first
        _, tree = self.ckpt.restore(template, latest, specs=specs,
                                    ctx=self.ctx, device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.residuals = tree.get("residuals")
        self.start_step = latest
        log.info("resumed from step %d", latest)

    def _plan_record(self):
        """The solved plan the manifest records: a ``StrategyPlan`` when
        the schedule carries strategies, a ``JointPlan`` when the backward
        was planned, the bare dim sequence otherwise (None without a
        schedule)."""
        sch = self.schedule
        if sch is None:
            return None
        if getattr(sch, "strategies", None) is not None:
            return StrategyPlan(tuple(sch.dims), tuple(sch.strategies))
        if getattr(sch, "bwd_dims", None) is not None:
            return JointPlan(tuple(sch.dims), tuple(sch.bwd_dims))
        return list(sch.dims)

    def _checkpoint(self, step: int, blocking: bool = False):
        if self.ckpt is None:
            return
        sch = self.schedule
        meta = (None if sch is None
                else {"initial": sch.initial, "final": sch.final})
        self.ckpt.save(step, self._state(), blocking=blocking,
                       plan=self._plan_record(), meta=meta,
                       specs=self._state_specs(), ctx=self.ctx)

    # -- elastic resize --------------------------------------------------------
    def replan(self, n_devices: int):
        """Re-solve and rebuild on the first ``n_devices`` ranks of the
        world: the switching plan at the new SP degree
        (``ElasticSpec.solve_schedule``), the survivor mesh
        (``launch.mesh.elastic_submesh``, keeping the data dim where it
        divides), the loss and step through the ``ElasticSpec``.  The live
        state (parameters, AdamW's moments, master copy and the residuals,
        laid out as their parameters) then moves one leaf at a time
        (``parallel.partition.reshard``): gathered whole from the old
        slices, cut to the new slice, the whole leaf dropped, so a rank
        holds its old and new slices and one whole leaf at most.  Every rank of the world calls it (it makes process
        groups, and every rank of the old mesh takes part in each
        gather); ranks past ``n_devices`` keep nothing and leave ``run()``
        with no steps.  At one device the mesh is dropped (plan
        ``none``).  JAX's ``replan`` re-solves on ``Topology.resized``
        too: the port's LM plans are priced in bytes, with no
        topology."""
        if self.elastic is None:
            raise ValueError("Trainer.replan needs an ElasticSpec "
                             "(elastic= at construction)")
        if self.ckpt is not None:
            self.ckpt.wait()      # never migrate under an in-flight save
        from repro_torch.launch.mesh import elastic_submesh
        mesh, leaving = elastic_submesh(
            n_devices, data=self._data_axis,
            held=self.ctx.world_size if self.ctx is not None else 1,
            active=self.active, device_type=self.device.type,
            regrow="restart with that many ranks and try_resume, which "
            "reshards the checkpoint")
        plan = self.elastic.plan or ParallelPlan(mode="dsp")
        rank = dist.get_rank() if dist.is_initialized() else 0
        schedule = None
        if mesh is None:
            plan = ParallelPlan(mode="none")
        else:
            sp = mesh.shape[mesh.mesh_dim_names.index("model")]
            schedule = (self.elastic.solve_schedule(sp)
                        if self.elastic.solve_schedule is not None and sp > 1
                        else None)
        if self.ckpt is not None:
            self.ckpt = CheckpointManager(
                self.ckpt.dir, keep=self.ckpt.keep,
                async_save=self.ckpt.async_save, ranks=range(n_devices))
        ctx = from_mesh(mesh) if mesh is not None and not leaving else None
        specs = None
        if ctx is not None:
            specs = param_pspecs(self._template()["params"], plan,
                                 axis_sizes=mesh_sizes(ctx))
        state, old_ctx = self._state(), self.ctx
        new_specs = None if specs is None else self._state_specs(specs)
        old_specs = self._state_specs()
        self.params = self.opt_state = self.residuals = None
        state = reshard(state, old_specs, old_ctx, new_specs, ctx,
                        leaving=leaving)
        if leaving:
            self.active = False
            self.mesh = self.ctx = self.specs = None
            log.info("replan(%d): rank %d leaves", n_devices, rank)
            return self
        sharder = (make_sharder(mesh, plan, schedule, param_specs=specs)
                   if ctx is not None else null_sharder())
        self.params, self.opt_state = state["params"], state["opt"]
        self.residuals = state.get("residuals")
        loss_fn = self.elastic.make_loss(mesh, sharder, schedule)
        self.step_fn = make_train_step(loss_fn, self.opt_cfg,
                                       grad_accum=self.cfg.grad_accum,
                                       sharder=sharder,
                                       grad_compress=self.cfg.grad_compress)
        self.mesh, self.ctx, self.specs = mesh, ctx, specs
        self.schedule = schedule
        log.info("replanned onto %d device(s)%s", n_devices,
                 "" if schedule is None else
                 f" ({schedule.n_switches()} planned switches)")
        return self

    # -- loop -------------------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        """Steps ``start_step`` to ``cfg.total_steps``; the next ``run``
        continues from where this one ends."""
        step = self.start_step
        if not self.active:
            return {"final_step": step, "history": [], "stragglers": []}
        ema = None
        saved = None
        while step < self.cfg.total_steps:
            batch = self.data_fn(step)
            t0 = time.monotonic()
            if self.cfg.grad_compress:
                (self.params, self.opt_state, self.residuals,
                 metrics) = self.step_fn(self.params, self.opt_state, batch,
                                         self.residuals)
            else:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
            loss = float(metrics["loss"])      # waits for the step's work
            dt = time.monotonic() - t0
            if ema is None:
                ema = dt
            if (dt > self.cfg.straggler_factor * ema
                    and step > self.start_step + 2):
                self.straggler_events.append((step, dt, ema))
                log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                            step, dt, ema)
            ema = 0.9 * ema + 0.1 * dt
            step += 1
            if step % self.cfg.log_every == 0:
                self.metrics_history.append((step, loss))
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if self.cfg.ckpt_every and step % self.cfg.ckpt_every == 0:
                self._checkpoint(step)
                saved = step
        if self.ckpt is not None:
            # the end's checkpoint is durable when run returns; a step just
            # saved async is waited for, not written twice
            if saved == step:
                self.ckpt.wait()
            else:
                self._checkpoint(step, blocking=True)
        self.start_step = step
        return {"final_step": step,
                "history": self.metrics_history,
                "stragglers": self.straggler_events}

