"""Attention: MHA / GQA / MQA with qk-norm, RoPE, sliding window, logit
soft-capping and KV-cache decode (counterpart of ``repro.models.attention``).

Tensors are (B, S, C) at the block boundary; the kernel path uses
(B, H, S, D).  Prefill goes through ``kernels.ops.flash_attention`` (the
CUDA kernel on the card); decode attends over the cache with plain
PyTorch (``_ref_decode``), as the JAX package does with jnp.

Decode writes the new K/V into the cache tensors IN PLACE (the JAX package
returns updated copies): at full width a copy of every layer's cache per
generated token would double the cache traffic.  The returned cache dict
holds the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding window (None = full)
    softcap: Optional[float] = None       # attention logit soft-cap (gemma2)
    bias: bool = False
    scale: Optional[float] = None         # override 1/sqrt(head_dim)


def init_attention(gen: torch.Generator, cfg: AttnConfig, *,
                   dtype=torch.float32):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.init_linear(gen, d, h * dh, bias=cfg.bias, dtype=dtype),
        "wk": L.init_linear(gen, d, hkv * dh, bias=cfg.bias, dtype=dtype),
        "wv": L.init_linear(gen, d, hkv * dh, bias=cfg.bias, dtype=dtype),
        "wo": L.init_linear(gen, h * dh, d, bias=cfg.bias, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_norm(dh, dtype=dtype, device=gen.device)
        p["k_norm"] = L.init_norm(dh, dtype=dtype, device=gen.device)
    return p


def init_kv_cache(batch: int, cfg: AttnConfig, max_len: int, *,
                  dtype=torch.float32, device="cpu"):
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.long, device=device)}


def _project(p, x, src, cfg: AttnConfig):
    b, s, _ = x.shape
    s_kv = src.shape[1]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.linear(p["wq"], x).reshape(b, s, h, dh)
    k = L.linear(p["wk"], src).reshape(b, s_kv, hkv, dh)
    v = L.linear(p["wv"], src).reshape(b, s_kv, hkv, dh)
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        k = L.rms_norm(p["k_norm"], k)
    return q, k, v


def attention(p, x, cfg: AttnConfig, *, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              x_kv: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, backend: str = "kernel"):
    """x: (B, S, C).  ``x_kv`` switches to cross-attention.  With ``cache``
    given, runs incremental decoding: writes K/V at cache['pos'] (a scalar,
    or a (B,) vector of per-slot positions) and attends to the prefix;
    returns (out, new_cache), else just out.  ``backend`` picks the
    flash-attention path of the no-cache branch; decode is always plain."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _project(p, x, x if x_kv is None else x_kv, cfg)

    if positions is None:
        base = (cache["pos"] if cache is not None
                else torch.zeros((), dtype=torch.long, device=x.device))
        steps = torch.arange(s, device=x.device)
        positions = base[:, None] + steps if base.dim() == 1 else base + steps
    if cfg.rope and x_kv is None:
        q = L.apply_rope(q, positions, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, theta=cfg.rope_theta)

    if cache is not None:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        steps = torch.arange(s, device=x.device)
        # the write start clamps so the update fits, as jax's
        # dynamic_update_slice does: idle pool slots keep stepping past
        # max_len on garbage that the next insert overwrites
        start = pos.long().clamp(max=ck.shape[2] - s)
        if pos.dim() == 1:
            # per-slot write positions (continuous-batching slot pool):
            # each row appends at its own sequence offset
            rows = torch.arange(b, device=x.device)[:, None]
            cols = start[:, None] + steps
            ck[rows, :, cols] = k.to(ck.dtype)        # k is (B, S, Hkv, D)
            cv[rows, :, cols] = v.to(cv.dtype)
        else:
            idx = start + steps
            ck.index_copy_(2, idx, k.transpose(1, 2).to(ck.dtype))
            cv.index_copy_(2, idx, v.transpose(1, 2).to(cv.dtype))
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        o = _ref_decode(q.transpose(1, 2), ck, cv, cfg, pos, causal)
        o = o.transpose(1, 2).reshape(b, s, h * dh)
        return L.linear(p["wo"], o), new_cache

    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal and x_kv is None,
                        window=cfg.window, softcap=cfg.softcap,
                        scale=cfg.scale, backend=backend)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return L.linear(p["wo"], o)


def _ref_decode(q, k, v, cfg: AttnConfig, pos, causal: bool):
    """Decode attention with a position offset held in a tensor: mask by
    absolute positions (cols <= pos + i, window).  q: (B, H, Sq, D), k/v
    the full cache.  ``pos`` is a scalar (static batch) or a (B,) vector
    (slot pool: each row masks against its own length)."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    scale = cfg.scale if cfg.scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if cfg.softcap is not None:
        s = cfg.softcap * torch.tanh(s / cfg.softcap)
    per_row = pos.dim() == 1
    steps = torch.arange(sq, device=q.device)
    q_pos = (pos[:, None] if per_row else pos) + steps
    k_pos = torch.arange(k.shape[2], device=q.device)
    mask = torch.ones(tuple(q_pos.shape) + (k.shape[2],), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos <= q_pos[..., None]
    if cfg.window is not None:
        mask &= k_pos > q_pos[..., None] - cfg.window
    if per_row:                               # (B, sq, skv) row-wise mask
        mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def attention_sp(p, x, cfg: AttnConfig, *, backend: str = "kernel",
                 causal: bool = True,
                 x_kv: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 return_kv: bool = False):
    """The single-device body of the JAX package's DSP attention: project,
    qk-norm, RoPE, then flash attention over the full sequence.  The
    sequence-parallel switches come with the planner.  x: (B, S, C) ->
    (B, S, C), plus the decode-cache K/V (B, Hkv, S, D) with ``return_kv``."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    q, k, v = _project(p, x, x if x_kv is None else x_kv, cfg)
    if cfg.rope and x_kv is None:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device))
        q = L.apply_rope(q, pos, theta=cfg.rope_theta)
        k = L.apply_rope(k, pos, theta=cfg.rope_theta)
    q = q.transpose(1, 2).contiguous()
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    o = flash_attention(q, k, v, causal=causal and x_kv is None,
                        window=cfg.window, softcap=cfg.softcap,
                        scale=cfg.scale, backend=backend)
    o = L.linear(p["wo"], o.transpose(1, 2).reshape(b, s, h * dh))
    if return_kv:
        return o, (k, v)
    return o
