"""AdamW over a parameter tree (counterpart of ``repro.optim.adamw``):
float32 optimizer state over parameters of any dtype, global-norm
clipping, warmup then cosine schedule.

Plain tensor ops, as the JAX package leaves them to XLA.  Unlike JAX,
``apply_adamw`` updates the parameters and the state in place (no second
copy of 370M-parameter state per step) and returns the same trees.  The
step count is a Python int, so the schedule is host arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.models.lm import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    use_master: bool = True        # keep an f32 master copy of the params
    state_dtype: Any = torch.float32   # m/v dtype


def schedule(cfg: OptConfig, step: int) -> float:
    """Linear warmup then cosine decay to min_lr_ratio * peak."""
    if step < cfg.warmup_steps:
        return cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = min(max((step - cfg.warmup_steps) /
                   max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    return cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 *
                          (1 + math.cos(math.pi * frac)))


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    state: Dict[str, Any] = {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=cfg.state_dtype),
                      params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=cfg.state_dtype),
                      params),
        "step": 0}
    if cfg.use_master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads scaled to norm <= max_norm, in f32; the norm), with
    no host sync: the scale stays on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def apply_adamw(params, grads, state, cfg: OptConfig):
    """One AdamW step, in place.  Returns (params, state, metrics)."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = torch.zeros(())
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    ref = state.get("master", params)
    for p, r, g, m, v in zip(tree_leaves(params), tree_leaves(ref),
                             tree_leaves(grads), tree_leaves(state["m"]),
                             tree_leaves(state["v"])):
        g = g.float()
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        m.copy_(mf)
        v.copy_(vf)
        pf = r.float()
        pf = pf - lr * (m.float() / b1c / (torch.sqrt(v.float() / b2c)
                                           + cfg.eps) + cfg.weight_decay * pf)
        r.copy_(pf)
        if r is not p:
            p.copy_(pf)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
