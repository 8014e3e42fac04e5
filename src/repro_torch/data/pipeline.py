"""Deterministic synthetic batches (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of (config, step): nothing to checkpoint,
resume is "set step and go".  Each batch is drawn from a
``torch.Generator`` seeded from (0x5eed, step) on the batch's device; the
bits cannot match ``jax.random``'s, so parity tests feed the JAX
package's batches to both.  Tasks:

* ``lm_shift``: next token = (token + 1) mod V with a small noise floor,
  learnable in a few hundred steps, so a short run shows the loss fall;
* ``lm_random``: i.i.d. tokens and labels (throughput); with
  ``frontend_tokens`` (a VLM config's) also ``extra["patch_embeds"]``
  (batch, frontend_tokens, in_dim) float32 from normals, drawn after the
  labels as JAX draws them from the labels' key;
* ``video``: latent video tensors and diffusion targets for transformer2d,
  x and target (batch, temporal, spatial, in_dim) from normals, t (batch,)
  from a uniform draw, all float32;
* ``encdec``: audio-frame features and transcript tokens for the enc-dec
  model, feats (batch, enc_seq, frontend_dim) float32 from normals,
  tokens (batch, seq) and labels = (tokens + 1) mod V.

JAX has no separate VLM task: a VLM batch is ``lm_random``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device

TASKS = ("lm_shift", "lm_random", "video", "encdec")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    task: str = "lm_shift"
    vocab: int = 256
    seq: int = 512
    batch: int = 8
    noise: float = 0.05
    # video; the patch width of a VLM batch
    temporal: int = 8
    spatial: int = 64
    in_dim: int = 16
    # encdec
    enc_seq: int = 512
    frontend_dim: int = 80
    # vlm
    frontend_tokens: int = 0


def _generator(step: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((0x5eed << 32) + step)


def make_batch(cfg: DataConfig, step: int, *,
               device="cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device``, and for
    ``lm_random`` with ``frontend_tokens`` {"extra": {"patch_embeds"}};
    for ``video``, {"x", "t", "target"}; for ``encdec``, {"feats",
    "tokens", "labels"}."""
    if cfg.task not in TASKS:
        raise ValueError(f"task {cfg.task!r} not in {TASKS}")
    dev = resolve_device(device)
    gen = _generator(step, dev)
    if cfg.task == "video":
        shape = (cfg.batch, cfg.temporal, cfg.spatial, cfg.in_dim)
        return {"x": torch.randn(shape, generator=gen, device=dev),
                "t": torch.rand((cfg.batch,), generator=gen, device=dev),
                "target": torch.randn(shape, generator=gen, device=dev)}
    if cfg.task == "encdec":
        feats = torch.randn((cfg.batch, cfg.enc_seq, cfg.frontend_dim),
                            generator=gen, device=dev)
        tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq),
                               generator=gen, device=dev)
        return {"feats": feats, "tokens": tokens,
                "labels": (tokens + 1) % cfg.vocab}
    shape = (cfg.batch, cfg.seq)
    tokens = torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)
    if cfg.task == "lm_random":
        out = {"tokens": tokens,
               "labels": torch.randint(0, cfg.vocab, shape, generator=gen,
                                       device=dev)}
        if cfg.frontend_tokens:
            out["extra"] = {"patch_embeds": torch.randn(
                (cfg.batch, cfg.frontend_tokens, cfg.in_dim), generator=gen,
                device=dev)}
        return out
    labels = (tokens + 1) % cfg.vocab
    flip = torch.rand(shape, generator=gen, device=dev) < cfg.noise
    noise_tok = torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)
    return {"tokens": tokens, "labels": torch.where(flip, noise_tok, labels)}


def batch_for_arch(spec, shape_name: str, *,
                   batch_override: Optional[int] = None,
                   seq_override: Optional[int] = None, step: int = 0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """A concrete batch for an ArchSpec x one of its shapes: ``video`` at
    the shape's temporal x spatial for the t2d family, ``encdec`` at
    S_enc = seq and S_dec = seq // 4 for the enc-dec family (JAX's
    budget), ``lm_random`` for the LM family (with a VLM config's patch
    embeddings, as JAX's)."""
    shp = spec.shapes()[shape_name]
    if spec.family == "t2d":
        cfg = DataConfig(task="video", batch=batch_override or shp["batch"],
                         temporal=shp["temporal"], spatial=shp["spatial"],
                         in_dim=spec.config.in_dim)
        return make_batch(cfg, step, device=device)
    seq = seq_override or shp["seq"]
    batch = batch_override or shp["batch"]
    if spec.family == "encdec":
        cfg = DataConfig(task="encdec", vocab=spec.config.vocab,
                         seq=seq // 4, enc_seq=seq, batch=batch,
                         frontend_dim=spec.config.frontend_dim)
        return make_batch(cfg, step, device=device)
    if spec.family != "lm":
        raise NotImplementedError(f"{spec.family} batches: not yet ported")
    cfg = DataConfig(task="lm_random", vocab=spec.config.vocab, seq=seq,
                     batch=batch,
                     frontend_tokens=spec.config.frontend_tokens,
                     in_dim=spec.config.frontend_dim or 16)
    return make_batch(cfg, step, device=device)
