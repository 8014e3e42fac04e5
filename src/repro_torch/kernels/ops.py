"""Dispatching wrappers around the kernels (counterpart of
``repro.kernels.ops``).

A CPU tensor, or ``backend="ref"``, goes to the kernel's plain PyTorch
version; a CUDA tensor goes to the CUDA kernel, which raises on what it
does not take.  Nothing falls back from the kernel to the plain version.
The autograd ``Function`` comes with training.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)

BACKENDS = ("kernel", "ref")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    backend: str = "kernel") -> torch.Tensor:
    """Multi-head attention; q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D).

    ``block_q``/``block_k`` keep the JAX signature; they size the TPU
    kernel's tiles, and the CUDA kernel picks its own.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, {block_k}")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if backend == "ref" or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               **kw)
