"""Mamba-2 (SSD) block (counterpart of ``repro.models.ssm``), training path.

Structure per block: in_proj -> (z | x | B | C | dt); short causal
depthwise conv over (x|B|C); the SSD scan (``kernels.ops.ssd_scan``: the
CUDA kernel on the card, its plain version on the CPU); gated RMSNorm;
out_proj.  One device, so the JAX block's DSP switches around the scan
(plan ``none``) are no-ops and are left out.  The decode path
(``return_cache``, ``init_ssm_cache``, ``ssm_decode_step``) comes with
mamba2 serving.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_scan
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int            # = expand * d_model
    head_dim: int = 64      # P
    d_state: int = 128      # S
    n_groups: int = 1       # G
    d_conv: int = 4
    chunk: int = 128

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_inner // self.head_dim


def init_ssm(gen: torch.Generator, cfg: SSMConfig, *, dtype=torch.float32):
    """The JAX block's parameters and distributions, drawn from ``gen`` on
    its device.  ``a_log``, ``dt_bias`` and ``d_skip`` stay float32."""
    d, di, g, s, h = (cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state,
                      cfg.n_heads)
    dev = gen.device
    d_xbc = di + 2 * g * s
    return {
        # fused projection: z (di) | x (di) | B (g*s) | C (g*s) | dt (h)
        "in_proj": L.init_linear(gen, d, 2 * di + 2 * g * s + h, dtype=dtype),
        "conv_w": (torch.randn((cfg.d_conv, d_xbc), generator=gen,
                               device=dev) / math.sqrt(cfg.d_conv)).to(dtype),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": L.init_norm(di, dtype=dtype, device=dev),
        "out_proj": L.init_linear(gen, di, d, dtype=dtype),
    }


def _split_proj(cfg: SSMConfig, zxbcdt):
    di, g, s = cfg.d_inner, cfg.n_groups, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * s]
    dt = zxbcdt[..., 2 * di + 2 * g * s:]
    return z, xbc, dt


def _causal_conv(cfg: SSMConfig, p, xbc):
    """Depthwise causal conv along L.  xbc: (B, L, D_xbc)."""
    w = p["conv_w"].to(xbc.dtype)                        # (K, D)
    k = cfg.d_conv
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def ssm_block(p, x, cfg: SSMConfig, *, backend: str = "kernel"):
    """x: (B, L, d_model) -> (B, L, d_model)."""
    b, l, _ = x.shape
    di, g, s, h, ph = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.head_dim)
    zxbcdt = L.linear(p["in_proj"], x)
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(cfg, p, xbc_raw)
    xs = xbc[..., :di].reshape(b, l, h, ph)
    bmat = xbc[..., di:di + g * s].reshape(b, l, g, s)
    cmat = xbc[..., di + g * s:].reshape(b, l, g, s)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y = ssd_scan(xs, dt.to(xs.dtype), a, bmat, cmat, p["d_skip"],
                 chunk=cfg.chunk, backend=backend)
    y = y.reshape(b, l, di) * F.silu(z)
    y = L.rms_norm(p["norm"], y)
    return L.linear(p["out_proj"], y)
