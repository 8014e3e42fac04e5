"""Mamba-2 (SSD) block (counterpart of ``repro.models.ssm``).

Structure per block: in_proj -> (z | x | B | C | dt); short causal
depthwise conv over (x|B|C); the SSD scan (``kernels.ops.ssd_scan``: the
CUDA kernel on the card, its plain version on the CPU); gated RMSNorm;
out_proj.  One device, so the JAX block's DSP switches around the scan
(plan ``none``) are no-ops and are left out.

Serving: ``ssm_block(return_cache=True)`` (prefill) also returns the
decode cache {conv, state}; ``ssm_decode_step`` advances it by one token
in O(1), in plain PyTorch with an f32 state, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import ssd_scan
from repro_torch.kernels.ref import ssd_final_state
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


def ssm_block(p, x, cfg: SSMConfig, *, backend: str = "kernel",
              return_cache: bool = False):
    """x: (B, L, d_model) -> (B, L, d_model) [, cache].

    ``return_cache`` (prefill) also returns {"conv", "state"} for decode.
    JAX takes y and the state from the sequential ``ssd_ref`` there, since
    its kernel does not emit the state; here y stays on ``ops.ssd_scan``
    (the kernel on the card) and the state comes from ``ssd_final_state``,
    the same function as one contraction.  ``conv`` holds the last
    ``d_conv - 1`` conv inputs, zeros on the left of a shorter prompt: what
    decoding the prompt token by token from a zero cache leaves."""
    b, l, _ = x.shape
    di, g, s, h, ph = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.head_dim)
    zxbcdt = L.linear(p["in_proj"], x)
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(cfg, p, xbc_raw)
    xs = xbc[..., :di].reshape(b, l, h, ph)
    bmat = xbc[..., di:di + g * s].reshape(b, l, g, s)
    cmat = xbc[..., di + g * s:].reshape(b, l, g, s)
    dt = F.softplus(dt.float() + p["dt_bias"]).to(xs.dtype)
    a = -torch.exp(p["a_log"])
    y = ssd_scan(xs, dt, a, bmat, cmat, p["d_skip"], chunk=cfg.chunk,
                 backend=backend)
    y = y.reshape(b, l, di) * F.silu(z)
    y = L.rms_norm(p["norm"], y)
    out = L.linear(p["out_proj"], y)
    if not return_cache:
        return out
    k = cfg.d_conv - 1
    conv = F.pad(xbc_raw, (0, 0, max(k - l, 0), 0))[:, -k:]
    return out, {"conv": conv,
                 "state": ssd_final_state(xs, dt, a, bmat, cmat)}


# ---------------------------------------------------------------------------
# Decode (single-token) path: O(1) state update
# ---------------------------------------------------------------------------

def init_ssm_cache(batch: int, cfg: SSMConfig, *, dtype=torch.float32,
                   device="cuda"):
    """Zero decode cache: ``conv`` (B, d_conv - 1, d_xbc) in ``dtype``,
    ``state`` (B, H, P, S) in float32."""
    device = resolve_device(device)
    d_xbc = cfg.d_inner + 2 * cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_xbc), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                              cfg.d_state), dtype=torch.float32,
                             device=device),
    }


def ssm_decode_step(p, x, cfg: SSMConfig, cache):
    """x: (B, 1, d_model) -> (y, new_cache); ``cache`` is not written."""
    b = x.shape[0]
    di, g, s, h, ph = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.head_dim)
    zxbcdt = L.linear(p["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, zxbcdt)                  # (B,1,*)
    # conv: window = cached K-1 inputs + current
    win = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (B, K, D)
    w = p["conv_w"].to(xbc.dtype)
    conv_out = torch.einsum("bkd,kd->bd", win, w) + p["conv_b"].to(xbc.dtype)
    conv_out = F.silu(conv_out)[:, None, :]
    new_conv = win[:, 1:, :]

    xs = conv_out[..., :di].reshape(b, h, ph)
    bmat = conv_out[..., di:di + g * s].reshape(b, g, s)
    cmat = conv_out[..., di + g * s:].reshape(b, g, s)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])     # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dtv * a[None, :])                    # (B, H)
    rep = h // g
    bfull = torch.repeat_interleave(bmat, rep, dim=1).float()   # (B, H, S)
    cfull = torch.repeat_interleave(cmat, rep, dim=1).float()
    upd = torch.einsum("bhp,bhs->bhps", dtv[..., None] * xs.float(), bfull)
    state = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhps,bhs->bhp", state, cfull)
    y = y + p["d_skip"][None, :, None] * xs.float()
    y = y.to(x.dtype).reshape(b, 1, di) * F.silu(z)
    y = L.rms_norm(p["norm"], y)
    return L.linear(p["out_proj"], y), {"conv": new_conv, "state": state}
