"""The paper's base model, the OpenSora-like 2D (spatial-temporal) DiT, on
one device (counterpart of ``repro.models.transformer2d``).

Input is a latent video tensor ``x: (B, T, S, C_in)`` (the VAE/patch
frontend is a stub) plus a diffusion timestep ``t: (B,)`` for adaLN
modulation.  Blocks alternate: a *spatial* block (attention over S,
independent across B, T) then a *temporal* block (attention over T,
independent across B, S).  ``n_layers`` counts blocks: 28 blocks at
d 1152 give the 720M model, 36 at d 2048 the 3B model (paper Table 4).

Per-pair parameters live under ``layers/{spatial,temporal}`` stacked on a
leading n_layers / 2 dim, and linears are (d_in, d_out), as in the JAX
package, so a JAX parameter tree crosses over leaf for leaf
(``repro_torch.bridge``).  Only the single-device path is ported: JAX's
``forward`` with ``mesh=None`` runs ``ScheduleExecutor.null()``, so no
planned switch is on it.  The mesh, the DSP schedule and the embedded-SP
baselines (``make_spmd_forward``, ``forward2d``) come with the planner and
the DSP primitives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.lm import tree_leaves, tree_map, unstack


@dataclasses.dataclass(frozen=True)
class T2DConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    in_dim: int = 64                  # stub latent/patch feature size
    head_dim: Optional[int] = None
    mlp_kind: str = "gelu"            # the paper's FFN: 2 layers, activation
    modulate: bool = True             # DiT adaLN-zero timestep modulation
    dtype: Any = torch.bfloat16
    n_kv_heads: Optional[int] = None  # GQA: K/V head count (None = MHA)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kvh(self) -> int:
        return self.n_kv_heads or self.n_heads


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: T2DConfig):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
    dev = gen.device
    p = {
        "ln1": L.init_norm(d, dtype=cfg.dtype, device=dev),
        "wq": L.init_linear(gen, d, h * dh, dtype=cfg.dtype),
        "wk": L.init_linear(gen, d, cfg.kvh * dh, dtype=cfg.dtype),
        "wv": L.init_linear(gen, d, cfg.kvh * dh, dtype=cfg.dtype),
        "wo": L.init_linear(gen, h * dh, d, dtype=cfg.dtype),
        "ln2": L.init_norm(d, dtype=cfg.dtype, device=dev),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, kind=cfg.mlp_kind,
                          dtype=cfg.dtype),
    }
    if cfg.modulate:
        p["mod"] = L.init_modulation(gen, d, dtype=cfg.dtype)
    return p


def init_t2d(seed: int, cfg: T2DConfig, *, device="cuda"):
    """The parameter tree, drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device``.  Each block pair is drawn and copied into the
    stacked ``layers`` in turn, so the peak is the model plus one pair's
    float32 draw."""
    if cfg.n_layers % 2:
        raise ValueError("blocks alternate spatial/temporal: n_layers "
                         f"{cfg.n_layers} is odd")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = cfg.n_layers // 2
    layers = None
    for i in range(n):
        one = {"spatial": _init_block(gen, cfg),
               "temporal": _init_block(gen, cfg)}
        if layers is None:
            layers = tree_map(
                lambda a: a.new_empty((n,) + tuple(a.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), layers, one)
    return {
        "layers": layers,
        "embed": L.init_patch_embed(gen, cfg.in_dim, cfg.d_model,
                                    dtype=cfg.dtype),
        "final_norm": L.init_norm(cfg.d_model, dtype=cfg.dtype, device=dev),
        "head": L.init_linear(gen, cfg.d_model, cfg.in_dim, bias=True,
                              dtype=cfg.dtype),
        "t_proj": L.init_linear(gen, cfg.d_model, cfg.d_model, bias=True,
                                dtype=cfg.dtype),
    }


def t2d_param_count(cfg: T2DConfig) -> int:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
    per_block = (d * h * dh * 2 + d * cfg.kvh * dh * 2
                 + L.mlp_param_count(d, cfg.d_ff, cfg.mlp_kind))
    if cfg.modulate:
        per_block += d * 6 * d
    return cfg.n_layers * per_block + 2 * cfg.in_dim * d + d * d


# ---------------------------------------------------------------------------
# Positional encoding (sinusoidal, offset-aware for sharded dims)
# ---------------------------------------------------------------------------

def _sincos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(N,) -> (N, d) float32, sin then cos (``timestep_embedding`` is cos
    then sin: both orders are the JAX package's)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def add_pos_embed(x, cfg: T2DConfig, t_offset: int = 0, s_offset: int = 0):
    """x: (B, T, S, C); the offsets give the global positions of a local
    shard."""
    _, t, s, c = x.shape
    pe_t = _sincos(t_offset + torch.arange(t, device=x.device), c)
    pe_s = _sincos(s_offset + torch.arange(s, device=x.device), c)
    return (x + pe_t[None, :, None, :].to(x.dtype)
            + pe_s[None, None, :, :].to(x.dtype))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _default_attn(backend: str):
    def impl(q, k, v):
        # q: (B', L, H, D); k/v may carry fewer (GQA) heads -> repeat them
        # up to H (the JAX kernel wants equal head counts)
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False, backend=backend)
        return o.transpose(1, 2)
    return impl


def _mod6(p, t_emb, cfg: T2DConfig):
    if not cfg.modulate or t_emb is None:
        return None
    return L.modulation(p["mod"], t_emb)     # 6 x (B, 1, C)


def _modulate(h, shift, scale):
    return h * (1.0 + scale) + shift


def t2d_block(p, x, cfg: T2DConfig, *, axis: int, t_emb=None,
              backend: str = "kernel"):
    """One transformer block computing attention along ``axis`` (1 = T,
    2 = S) of x: (B, T, S, C).  The other sequence dim folds into the batch
    as the minor factor of (B * other).  JAX's ``attn_impl``,
    ``fold_hook`` and ``stage_hook`` serve the mesh path and come with
    it."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (T) or 2 (S), got {axis}")
    attn_impl = _default_attn(backend)
    b, t, s, c = x.shape
    h_heads, dh = cfg.n_heads, cfg.dh
    mod = _mod6(p, t_emb, cfg)

    def fold(y):       # (B, T, S, C) -> (B * other, L, C)
        if axis == 1:
            return y.transpose(1, 2).reshape(b * s, t, c)
        return y.reshape(b * t, s, c)

    def unfold(y):
        if axis == 1:
            return y.reshape(b, s, t, c).transpose(1, 2)
        return y.reshape(b, t, s, c)

    def bmod(m):       # (B, 1, C) -> (B, 1, 1, C)
        return m[:, :, None, :].to(x.dtype)

    h = L.rms_norm(p["ln1"], x)
    if mod is not None:
        h = _modulate(h, bmod(mod[0]), bmod(mod[1]))
    hf = fold(h)
    l = hf.shape[1]
    q = L.linear(p["wq"], hf).reshape(-1, l, h_heads, dh)
    k = L.linear(p["wk"], hf).reshape(-1, l, cfg.kvh, dh)
    v = L.linear(p["wv"], hf).reshape(-1, l, cfg.kvh, dh)
    o = attn_impl(q, k, v).reshape(-1, l, h_heads * dh)
    o = unfold(L.linear(p["wo"], o))
    if mod is not None:
        o = o * bmod(mod[2])
    x = x + o

    h = L.rms_norm(p["ln2"], x)
    if mod is not None:
        h = _modulate(h, bmod(mod[3]), bmod(mod[4]))
    h = L.mlp(p["mlp"], h, cfg.mlp_kind)
    if mod is not None:
        h = h * bmod(mod[5])
    return x + h


# ---------------------------------------------------------------------------
# Full forward, one device
# ---------------------------------------------------------------------------

def forward(params, x, t, cfg: T2DConfig, *, mesh=None, mode: str = "dsp",
            backend: str = "kernel", remat: bool = True, remat_group: int = 2,
            t_offset: int = 0, s_offset: int = 0, topology=None,
            joint: bool = False, schedule=None, overlap: Optional[str] = None):
    """x: (B, T, S, C_in) in the model dtype, t: (B,) or None ->
    (B, T, S, C_in).  Pairs of blocks (spatial, then temporal) in order;
    with ``remat`` each group of ``remat_group`` pairs (1 when the pair
    count is not a multiple) is checkpointed and recomputed in the
    backward, JAX's hierarchical remat.  The mesh path's arguments raise:
    the planner and the DSP switches are not ported yet."""
    given = {"mesh": mesh is not None, "mode": mode != "dsp",
             "topology": topology is not None, "joint": joint,
             "schedule": schedule is not None, "overlap": overlap is not None}
    bad = sorted(k for k, v in given.items() if v)
    if bad:
        raise NotImplementedError(f"transformer2d {', '.join(bad)}: not yet "
                                  f"ported (only mesh=None runs)")
    x = L.patch_embed(params["embed"], x)
    x = add_pos_embed(x, cfg, t_offset, s_offset)
    t_emb = None
    if cfg.modulate and t is not None:
        t_emb = L.linear(params["t_proj"],
                         L.timestep_embedding(t, cfg.d_model).to(x.dtype))

    layers = params["layers"]
    n = tree_leaves(layers)[0].shape[0]
    pairs = unstack(layers, n)
    g = remat_group if (remat and n % remat_group == 0) else 1

    def group_body(xc, te, *group):
        for lp in group:
            xc = t2d_block(lp["spatial"], xc, cfg, axis=2, t_emb=te,
                           backend=backend)
            xc = t2d_block(lp["temporal"], xc, cfg, axis=1, t_emb=te,
                           backend=backend)
        return xc

    for i in range(0, n, g):
        group = pairs[i:i + g]
        if remat:
            x = checkpoint(group_body, x, t_emb, *group, use_reentrant=False)
        else:
            x = group_body(x, t_emb, *group)
    x = L.rms_norm(params["final_norm"], x)
    return L.linear(params["head"], x)


def model_dtype_batch(batch: Dict[str, torch.Tensor], cfg: T2DConfig):
    """A video batch with x and target in the model dtype and t as it is,
    as the JAX package's training cell declares them: a float32 batch
    (``data.pipeline``'s) with bfloat16 weights would not multiply."""
    return {k: v if k == "t" else v.to(cfg.dtype) for k, v in batch.items()}


def t2d_loss(params, batch: Dict[str, torch.Tensor], cfg: T2DConfig, **kw):
    """Diffusion-style MSE against the target latents, in float32."""
    pred = forward(params, batch["x"], batch.get("t"), cfg, **kw)
    err = (pred.float() - batch["target"].float()) ** 2
    return torch.mean(err), {}
