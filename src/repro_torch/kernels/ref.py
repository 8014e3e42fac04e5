"""Plain PyTorch oracle for attention (counterpart of ``repro.kernels.ref``).

``attention_ref`` has the JAX oracle's semantics: a fully masked row is a
softmax over equal ``NEG_INF`` scores, i.e. a uniform average of V.  The
flash kernel's own plain version (``kernels.flash_attention``) differs
there: it outputs 0.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.3819763e38   # close to bf16 min, matches the JAX package


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Reference multi-head attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) with Hq % Hkv == 0 (GQA).
    ``q_offset``: global position of q[..., 0, :] relative to k.
    Returns (B, Hq, Sq, D) in q's dtype; computes in float32.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)
