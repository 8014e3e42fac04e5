"""Mamba-2 (SSD) block (counterpart of ``repro.models.ssm``).

Structure per block: in_proj -> (z | x | B | C | dt); short causal
depthwise conv over (x|B|C); the SSD scan (``kernels.ops.ssd_scan``: the
CUDA kernel on the card, its plain version on the CPU); gated RMSNorm;
out_proj.

DSP (``sharder``, a ``parallel.partition.Sharder`` on a mesh): the block
is entered sequence-sharded; the scan computes along L and is
independent across heads, so its operands switch to head-sharded (one
all-to-all each for x and dt), the B/C groups are gathered whole, and
the output switches back.  The causal conv needs the previous rank's last
``d_conv - 1`` inputs, which one permute brings (``Sharder.seq_halo``).

Serving: ``ssm_block(return_cache=True)`` (prefill) also returns the
decode cache {conv, state}; ``ssm_decode_step`` advances it by one token
in O(1), in plain PyTorch with an f32 state, as JAX's does.  Served
sharded, the state stays split by head over ``model`` (the scan's own
layout after the switch) and each decode step updates the rank's heads
and gathers y; ``conv`` is whole on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import dsp
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import ssd_scan
from repro_torch.kernels.ref import ssd_final_state
from repro_torch.models import layers as L
from repro_torch.parallel.partition import null_sharder


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


def _causal_conv(cfg: SSMConfig, p, xbc, left=None):
    """Depthwise causal conv along L.  xbc: (B, L, D_xbc); ``left`` holds
    the ``d_conv - 1`` inputs before xbc's first (zeros when None)."""
    w = p["conv_w"].to(xbc.dtype)                        # (K, D)
    k = cfg.d_conv
    pad = (F.pad(xbc, (0, 0, k - 1, 0)) if left is None
           else torch.cat([left.to(xbc.dtype), xbc], dim=1))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _local_groups(bmat, cmat, h: int, h0: int, hl: int):
    """The B/C groups (B, L, G, S) of heads ``[h0, h0 + hl)``, laid out so
    that local head j reads its global head's group, as the scan maps
    heads to groups (j // (heads / groups)): a slice of whole groups when
    the heads hold whole groups, the one group when they lie inside one,
    else one group per head."""
    hpg = h // bmat.shape[2]                 # heads per group
    if hl % hpg == 0 and h0 % hpg == 0:
        sl = slice(h0 // hpg, (h0 + hl) // hpg)
    elif hpg % hl == 0:
        sl = slice(h0 // hpg, h0 // hpg + 1)
    else:
        idx = torch.arange(h0, h0 + hl, device=bmat.device) // hpg
        return bmat[:, :, idx], cmat[:, :, idx]
    return bmat[:, :, sl], cmat[:, :, sl]


def ssm_block(p, x, cfg: SSMConfig, *, backend: str = "kernel",
              sharder=None, return_cache: bool = False,
              length: Optional[int] = None):
    """x: (B, L, d_model) -> (B, L, d_model) [, cache]; on a mesh the
    rank's sequence shard.

    Under DSP the scan runs on the rank's H/n heads: ``a_log`` and
    ``d_skip`` are sliced to them (``dt_bias`` is added before the switch,
    on every head), and K2 sees their groups (``_local_groups``).

    ``length`` (a prompt padded on the right to a multiple of the SP
    size): the global positions from ``length`` on are padding, whose dt
    is set to 0 after the softplus, so the state passes them unchanged
    (decay exp(0) = 1, update 0); causality keeps them out of the real
    positions' outputs.

    ``return_cache`` (prefill) also returns {"conv", "state"} for decode.
    JAX takes y and the state from the sequential ``ssd_ref`` there, since
    its kernel does not emit the state; here y stays on ``ops.ssd_scan``
    (the kernel on the card) and the state comes from ``ssd_final_state``,
    the same function as one contraction, on the rank's heads on a mesh:
    ``cache_pspecs``' head-sharded layout, with no move.  ``conv`` holds
    the last ``d_conv - 1`` conv inputs before ``length``, zeros on the
    left of a shorter prompt (what decoding the prompt token by token from
    a zero cache leaves), whole on every rank (``Sharder.seq_rows``)."""
    b = x.shape[0]
    di, g, s, h, ph = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.head_dim)
    sharder = sharder or null_sharder()
    zxbcdt = L.linear(p["in_proj"], x)
    z, xbc_raw, dt = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(cfg, p, xbc_raw,
                       sharder.seq_halo(xbc_raw, cfg.d_conv - 1))
    # planned DSP switch: seq-shard -> channel-shard (one all-to-all).  The
    # scan's operands are made contiguous on every path, so that a mesh of
    # one rank (whose collectives are copies) and one device give the
    # layout-sensitive f32 products of the state the same bits
    xs = sharder.mixer3(xbc[..., :di], src="resid").contiguous()
    bmat = sharder.replicated(xbc[..., di:di + g * s]).contiguous()
    cmat = sharder.replicated(xbc[..., di + g * s:]).contiguous()
    dt = sharder.mixer3(F.softplus(dt.float() + p["dt_bias"]), src="resid")
    l = xs.shape[1]
    if length is not None:
        first = (0 if sharder.ctx is None or sharder.mixer_dim == 2
                 else sharder.seq_offset(l))
        real = torch.arange(first, first + l, device=dt.device) < length
        dt = torch.where(real[:, None], dt, torch.zeros_like(dt))
    h0, hl = sharder.mixer_slice(h)
    xs = xs.reshape(b, l, hl, ph)
    dt = dt.to(xs.dtype)
    bl, cl = _local_groups(bmat.reshape(b, l, g, s), cmat.reshape(b, l, g, s),
                           h, h0, hl)
    a = -torch.exp(p["a_log"][h0:h0 + hl])
    y = ssd_scan(xs, dt, a, bl, cl, p["d_skip"][h0:h0 + hl],
                 chunk=cfg.chunk, backend=backend)
    y = sharder.mixer3(y.reshape(b, l, hl * ph), src="mixer")
    # planned DSP switch back: channel-shard -> seq-shard
    y = sharder.scan_out3(y) * F.silu(z)
    y = L.rms_norm(p["norm"], y)
    out = L.linear(p["out_proj"], y)
    if not return_cache:
        return out
    k = cfg.d_conv - 1
    end = (length if length is not None
           else xbc_raw.shape[1] * sharder.seq_shards)
    return out, {"conv": sharder.seq_rows(xbc_raw, end - k, k),
                 "state": ssd_final_state(xs, dt, a, bl, cl)}


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


def ssm_decode_step(p, x, cfg: SSMConfig, cache, sharder=None):
    """x: (B, 1, d_model) -> (y, new_cache); ``cache`` is not written.

    With ``sharder`` serving sharded, ``cache["state"]`` holds this rank's
    H/n heads (chunk ``sp_index``): the rank advances them from the whole
    x and conv window, and y is gathered over ``model`` (one all-gather in
    the model dtype) before the gated ``rms_norm``, which XLA does
    implicitly in JAX."""
    b = x.shape[0]
    di, g, s, h, ph = (cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads,
                       cfg.head_dim)
    sharded = sharder is not None and sharder.serves_sharded
    hl = h // sharder.sp_size if sharded else h
    if hl * (sharder.sp_size if sharded else 1) != h:
        raise ValueError(f"{h} SSM heads do not split over "
                         f"{sharder.sp_size} model ranks")
    h0 = sharder.sp_index * hl if sharded else 0
    zxbcdt = L.linear(p["in_proj"], x)
    z, xbc, dt = _split_proj(cfg, zxbcdt)                  # (B,1,*)
    # conv: window = cached K-1 inputs + current
    win = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)  # (B, K, D)
    w = p["conv_w"].to(xbc.dtype)
    conv_out = torch.einsum("bkd,kd->bd", win, w) + p["conv_b"].to(xbc.dtype)
    conv_out = F.silu(conv_out)[:, None, :]
    new_conv = win[:, 1:, :]

    xs = conv_out[..., :di].reshape(b, h, ph)[:, h0:h0 + hl]
    bmat = conv_out[..., di:di + g * s].reshape(b, g, s)
    cmat = conv_out[..., di + g * s:].reshape(b, g, s)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"])[:, h0:h0 + hl]
    a = -torch.exp(p["a_log"][h0:h0 + hl])
    decay = torch.exp(dtv * a[None, :])                    # (B, hl)
    # each head's B/C group (head j reads group j // (H / G))
    grp = torch.arange(h0, h0 + hl, device=x.device) // (h // g)
    bfull = bmat[:, grp].float()                           # (B, hl, S)
    cfull = cmat[:, grp].float()
    upd = torch.einsum("bhp,bhs->bhps", dtv[..., None] * xs.float(), bfull)
    state = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhps,bhs->bhp", state, cfull)
    y = y + p["d_skip"][None, h0:h0 + hl, None] * xs.float()
    y = y.to(x.dtype).reshape(b, 1, hl * ph)
    if sharded:
        # contiguous as one device's y, so that the gated norm reduces it
        # in the same order
        y = dsp.gather(y, 2, sharder.ctx.sp_group).contiguous()
    y = y * F.silu(z)
    y = L.rms_norm(p["norm"], y)
    return L.linear(p["out_proj"], y), {"conv": new_conv, "state": state}
