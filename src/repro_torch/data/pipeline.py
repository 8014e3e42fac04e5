"""Deterministic synthetic batches (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (config, step): nothing to checkpoint,
resume is "set step and go".  Each batch is drawn from a
``torch.Generator`` seeded from (0x5eed, step) on the batch's device; the
bits cannot match ``jax.random``'s, so parity tests feed the JAX
package's batches to both.  Tasks:

* ``lm_shift``: next token = (token + 1) mod V with a small noise floor,
  learnable in a few hundred steps, so a short run shows the loss fall;
* ``lm_random``: i.i.d. tokens and labels (throughput);
* ``video``: latent video tensors and diffusion targets for transformer2d,
  x and target (batch, temporal, spatial, in_dim) from normals, t (batch,)
  from a uniform draw, all float32.

The enc-dec and VLM tasks come with their model families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device

TASKS = ("lm_shift", "lm_random", "video")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    task: str = "lm_shift"
    vocab: int = 256
    seq: int = 512
    batch: int = 8
    noise: float = 0.05
    # video
    temporal: int = 8
    spatial: int = 64
    in_dim: int = 16


def _generator(step: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((0x5eed << 32) + step)


def make_batch(cfg: DataConfig, step: int, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device``; for
    ``video``, {"x", "t", "target"}."""
    if cfg.task not in TASKS:
        raise ValueError(f"task {cfg.task!r} not in {TASKS}")
    dev = resolve_device(device)
    gen = _generator(step, dev)
    if cfg.task == "video":
        shape = (cfg.batch, cfg.temporal, cfg.spatial, cfg.in_dim)
        return {"x": torch.randn(shape, generator=gen, device=dev),
                "t": torch.rand((cfg.batch,), generator=gen, device=dev),
                "target": torch.randn(shape, generator=gen, device=dev)}
    shape = (cfg.batch, cfg.seq)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)
    if cfg.task == "lm_random":
        return {"tokens": tokens,
                "labels": torch.randint(0, cfg.vocab, shape, generator=gen,
                                        device=dev)}
    labels = (tokens + 1) % cfg.vocab
    flip = torch.rand(shape, generator=gen, device=dev) < cfg.noise
    noise_tok = torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)
    return {"tokens": tokens, "labels": torch.where(flip, noise_tok, labels)}


def batch_for_arch(spec, shape_name: str, *,
                   batch_override: Optional[int] = None,
                   seq_override: Optional[int] = None, step: int = 0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """A concrete batch for an ArchSpec x one of its shapes: ``video`` at
    the shape's temporal x spatial for the t2d family, ``lm_random`` for
    the LM family."""
    shp = spec.shapes()[shape_name]
    if spec.family == "t2d":
        cfg = DataConfig(task="video", batch=batch_override or shp["batch"],
                         temporal=shp["temporal"], spatial=shp["spatial"],
                         in_dim=spec.config.in_dim)
        return make_batch(cfg, step, device=device)
    if spec.family != "lm":
        raise NotImplementedError(f"{spec.family} batches: not yet ported")
    cfg = DataConfig(task="lm_random", vocab=spec.config.vocab,
                     seq=seq_override or shp["seq"],
                     batch=batch_override or shp["batch"])
    return make_batch(cfg, step, device=device)
