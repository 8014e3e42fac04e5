"""Deterministic synthetic LM batches (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (config, step): nothing to checkpoint,
resume is "set step and go".  Each batch is drawn from a
``torch.Generator`` seeded from (0x5eed, step) on the batch's device; the
bits cannot match ``jax.random``'s, so parity tests feed the JAX
package's batches to both.  Tasks:

* ``lm_shift``: next token = (token + 1) mod V with a small noise floor,
  learnable in a few hundred steps, so a short run shows the loss fall;
* ``lm_random``: i.i.d. tokens and labels (throughput).

The video, enc-dec and VLM tasks come with their model families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.device import resolve_device

TASKS = ("lm_shift", "lm_random")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    task: str = "lm_shift"
    vocab: int = 256
    seq: int = 512
    batch: int = 8
    noise: float = 0.05


def _generator(step: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((0x5eed << 32) + step)


def make_batch(cfg: DataConfig, step: int, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device``."""
    if cfg.task not in TASKS:
        raise ValueError(f"task {cfg.task!r} not in {TASKS}")
    dev = resolve_device(device)
    gen = _generator(step, dev)
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
