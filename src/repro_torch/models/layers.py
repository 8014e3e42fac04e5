"""Common layers (counterpart of ``repro.models.layers``).

Every layer is an (init, apply) pair: ``init_*`` returns a parameter dict
of tensors in the JAX package's layout (a linear's ``w`` is (d_in, d_out)),
``apply`` is a plain function.  Random inits draw from the given
``torch.Generator`` on its device, with the JAX package's distributions.
Norms and softmax accumulate in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initialisation helpers
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            ).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32,
                scale: Optional[float] = None):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_norm(d: int, *, bias: bool = False, dtype=torch.float32,
              device="cpu"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def rms_norm(p, x, *, eps: float = 1e-6, upcast: bool = True,
             scale_plus_one: bool = False):
    dtype = x.dtype
    if upcast:
        x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = p["scale"].to(x.dtype)
    if scale_plus_one:                      # gemma-style (1 + scale)
        scale = 1.0 + scale
    y = x * scale
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y.to(dtype)


def layer_norm(p, x, *, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             kind: str = "silu_glu", bias: bool = False, dtype=torch.float32):
    if kind in ("silu_glu", "gelu_glu"):
        return {"wi": init_linear(gen, d_model, d_ff, bias=bias, dtype=dtype),
                "wg": init_linear(gen, d_model, d_ff, bias=bias, dtype=dtype),
                "wo": init_linear(gen, d_ff, d_model, bias=bias, dtype=dtype)}
    if kind in ("relu", "gelu"):
        return {"wi": init_linear(gen, d_model, d_ff, bias=bias, dtype=dtype),
                "wo": init_linear(gen, d_ff, d_model, bias=bias, dtype=dtype)}
    raise ValueError(kind)


def mlp(p, x, kind: str = "silu_glu"):
    if kind == "silu_glu":
        h = F.silu(linear(p["wg"], x)) * linear(p["wi"], x)
    elif kind == "gelu_glu":
        h = F.gelu(linear(p["wg"], x), approximate="tanh") * linear(p["wi"], x)
    elif kind == "relu":
        h = F.relu(linear(p["wi"], x))
    elif kind == "gelu":
        h = F.gelu(linear(p["wi"], x), approximate="tanh")
    else:
        raise ValueError(kind)
    return linear(p["wo"], h)


def mlp_param_count(d_model: int, d_ff: int, kind: str) -> int:
    return d_model * d_ff * (3 if kind.endswith("_glu") else 2)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, *, theta: float = 10000.0,
               device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) with positions (S,) or (B, S).  Rotates half-split
    pairs (x[i], x[i + D/2]) -- the 'non-interleaved' convention."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta=theta, device=x.device)          # (D/2,)
    ang = positions[..., :, None].float() * freqs                 # (S, D/2)
    cos = torch.cos(ang)[..., :, None, :]                         # (S, 1, D/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, *,
                   dtype=torch.float32):
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(p, tokens: torch.Tensor, *, scale_by_sqrt_dim: bool = False):
    y = p["table"][tokens]
    if scale_by_sqrt_dim:
        y = y * math.sqrt(p["table"].shape[-1])
    return y


def unembed(p, x: torch.Tensor, *, softcap: Optional[float] = None):
    logits = x @ p["table"].t()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def softcap_logits(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# Patch embedding (transformer2d frontend)
# ---------------------------------------------------------------------------

def init_patch_embed(gen: torch.Generator, in_channels: int, d_model: int, *,
                     dtype=torch.float32):
    """Projects precomputed per-patch features to d_model; the modality
    frontend itself (the VAE) is a stub, as in the JAX package."""
    return {"proj": init_linear(gen, in_channels, d_model, bias=True,
                                dtype=dtype)}


def patch_embed(p, x):
    return linear(p["proj"], x)


# ---------------------------------------------------------------------------
# DiT timestep modulation (transformer2d)
# ---------------------------------------------------------------------------

def init_modulation(gen: torch.Generator, d_model: int, *,
                    dtype=torch.float32):
    """adaLN-zero: the projection starts at 0, so every block starts as the
    identity."""
    return {"proj": init_linear(gen, d_model, 6 * d_model, bias=True,
                                dtype=dtype, scale=0.0)}


def modulation(p, t_emb):
    """t_emb: (B, C) -> 6 x (B, 1, C) shift/scale/gate triples (attn,
    mlp)."""
    m = linear(p["proj"], F.silu(t_emb))
    return torch.chunk(m[:, None, :], 6, dim=-1)


def timestep_embedding(t: torch.Tensor, d_model: int, *,
                       max_period: float = 10000.0) -> torch.Tensor:
    """t: (B,) -> (B, d_model) float32, cos then sin."""
    half = d_model // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
