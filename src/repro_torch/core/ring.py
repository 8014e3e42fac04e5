"""Ring-Attention baseline over ``torch.distributed`` (counterpart of
``repro.core.ring``; Li et al. 2021, Liu et al. 2023).

K/V blocks rotate around the rank ring through ``core.dsp.ppermute`` while
each rank keeps its Q shard; partial attention is merged with a
numerically stable online softmax in float32.  Per-rank volume is the full
K + V activation (kv, 2M for MHA: n hops of kv/n), the paper's Table 3
entry.  The block attention is ``torch.einsum`` in float32, as JAX's is an
``einsum`` outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.dsp import per_device_bytes
from repro_torch.core.overlap import ring_stream

NEG_INF = -1e30


def stream_bytes(global_bytes: float, n: int, *, kv_bytes=None) -> float:
    """Per-rank volume of one ring attention, ``core.dsp.per_device_bytes
    ("ring", ...)`` (the full K/V activation, kv, default 2M — n hops of
    kv/n each; Table 3)."""
    return per_device_bytes("ring", global_bytes, n, kv_bytes=kv_bytes)


def _block_attn(q, k, v, q_pos, k_pos, scale: float, causal: bool):
    """One (Q shard x K block) partial attention in float32.
    q: (B, Sq, H, D), k/v: (B, Sk, H, D); returns (o, m, l, dead) with o
    un-normalised, m the row max (0 on fully masked rows) and ``dead``
    those rows."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]          # (Sq, Sk)
        s = s.masked_fill(~mask[None, None], NEG_INF)
    m = s.amax(dim=-1)                                   # (B, H, Sq)
    dead = m <= NEG_INF / 2
    m_safe = m.masked_fill(dead, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = p.masked_fill(s <= NEG_INF / 2, 0.0)
    l = p.sum(dim=-1)                                    # (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m_safe, l, dead


def _per_row(c):
    """(B, H, Sq) -> (B, Sq, H, 1), to scale o: (B, Sq, H, D)."""
    return c.transpose(1, 2)[..., None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: local (B, S/n, H, D) sharded along the sequence over ``group``;
    k, v may carry fewer heads (B, S/n, Hkv, D) with H % Hkv == 0 — the
    ring streams the small K/V blocks and repeats them up to H locally
    after each hop.  Returns the local output shard (B, S/n, H, D) in q's
    dtype."""
    idx = dist.get_rank(group)
    b, s_local, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    pos = torch.arange(s_local, device=q.device)
    q_pos = idx * s_local + pos

    def fold(t, src, blocks, carry):
        k_blk, v_blk = blocks                 # owned by rank ``src``
        o, m, l, any_valid = carry
        rep = h // k_blk.shape[2]
        if rep > 1:
            k_blk = k_blk.repeat_interleave(rep, dim=2)
            v_blk = v_blk.repeat_interleave(rep, dim=2)
        o_b, m_b, l_b, dead = _block_attn(q, k_blk, v_blk, q_pos,
                                          src * s_local + pos, scale, causal)
        # online-softmax merge; dead rows (a fully masked block) add nothing
        m_new = torch.where(dead, m, torch.maximum(m, m_b))
        c_old = torch.exp(m - m_new)
        c_new = torch.exp(m_b - m_new).masked_fill(dead, 0.0)
        o = o * _per_row(c_old) + o_b * _per_row(c_new)
        l = l * c_old + l_b * c_new
        return o, m_new, l, any_valid | ~dead

    carry0 = (q.new_zeros((b, s_local, h, d), dtype=torch.float32),
              q.new_full((b, h, s_local), NEG_INF, dtype=torch.float32),
              q.new_zeros((b, h, s_local), dtype=torch.float32),
              torch.zeros((b, h, s_local), dtype=torch.bool,
                          device=q.device))
    o, _, l, any_valid = ring_stream((k, v), carry0, fold, group)
    l = torch.where(any_valid, l, torch.ones_like(l))
    return (o / _per_row(l)).to(q.dtype)


__all__ = ["ring_attention", "stream_bytes", "NEG_INF"]
