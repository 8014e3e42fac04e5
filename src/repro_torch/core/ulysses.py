"""DeepSpeed-Ulysses baseline over ``torch.distributed`` (counterpart of
``repro.core.ulysses``; embedded sequence parallelism).

Per attention, four all-to-alls: q, k and v each reshard seq -> heads, and
the output heads -> seq; per-rank volume (2M + kv)/n (4M/n for MHA; paper
§4.1, Table 3).  ``ulysses_attention_fused`` stacks q/k/v into one
all-to-all (2 in all, the same bytes); ``usp_attention`` is the USP hybrid
(Ulysses inside one mesh dim, a ring across the other).  Each all-to-all
is ``core.dsp.dynamic_switch`` applied to the (seq, head) dim pair, so it
is counted and differentiable as a switch is.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.dsp import dynamic_switch, per_device_bytes
from repro_torch.core.ring import ring_attention

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def attention_bytes(global_bytes: float, n: int, *, kv_bytes=None,
                    kv_heads=None) -> float:
    """Per-rank volume of one Ulysses attention, ``core.dsp
    .per_device_bytes("ulysses", ...)`` (4M/n for the MHA q/k/v/o
    all-to-alls; the GQA K/V scatter shrinks it, or degrades to
    replication when kv_heads does not divide n)."""
    return per_device_bytes("ulysses", global_bytes, n, kv_bytes=kv_bytes,
                            kv_heads=kv_heads)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      attn_fn: AttnFn, group, seq_dim: int = 1,
                      head_dim: int = 2) -> torch.Tensor:
    """q, k, v: local (B, S/n, H, D); returns local (B, S/n, H, D).  K/V
    may have fewer heads than Q (GQA) as long as kv_heads % n == 0."""
    q = dynamic_switch(q, seq_dim, head_dim, group)
    k = dynamic_switch(k, seq_dim, head_dim, group)
    v = dynamic_switch(v, seq_dim, head_dim, group)
    o = attn_fn(q, k, v)                     # (B, S, H/n, D)
    return dynamic_switch(o, head_dim, seq_dim, group)


def ulysses_attention_fused(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, attn_fn: AttnFn, group,
                            seq_dim: int = 1,
                            head_dim: int = 2) -> torch.Tensor:
    """DSP-1D: one switch on the stacked q/k/v, one on the output (2
    all-to-alls).  q/k/v must have one shape (MHA)."""
    qkv = torch.stack([q, k, v], dim=0)      # (3, B, S/n, H, D)
    qkv = dynamic_switch(qkv, seq_dim + 1, head_dim + 1, group)
    o = attn_fn(*qkv.unbind(0))
    return dynamic_switch(o, head_dim, seq_dim, group)


def usp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  inner_group, outer_group, causal: bool = False,
                  seq_dim: int = 1, head_dim: int = 2) -> torch.Tensor:
    """USP hybrid (arXiv 2405.07719): Ulysses all-to-alls inside
    ``inner_group`` composed with ring attention across ``outer_group`` —
    the executed form of the strategy DP's "hybrid" pick on a 2D SP grid
    (``launch.mesh.make_sp2d_mesh``).

    q: local (B, S/(h*p), H, D), the sequence sharded over both groups
    (outer size h major, inner size p minor); k/v may carry fewer heads
    (GQA) as long as kv_heads % p == 0.  The inner all-to-alls reshard
    seq -> heads, so each rank holds its outer slice's sequence S/h with
    H/p heads; the ring then streams K/V across the outer group only.
    Returns local (B, S/(h*p), H, D)."""
    q = dynamic_switch(q, seq_dim, head_dim, inner_group)
    k = dynamic_switch(k, seq_dim, head_dim, inner_group)
    v = dynamic_switch(v, seq_dim, head_dim, inner_group)
    o = ring_attention(q, k, v, outer_group, causal=causal)
    return dynamic_switch(o, head_dim, seq_dim, inner_group)


__all__ = ["ulysses_attention", "ulysses_attention_fused", "usp_attention",
           "attention_bytes"]
