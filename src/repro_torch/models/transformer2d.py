"""The paper's base model, the OpenSora-like 2D (spatial-temporal) DiT
(counterpart of ``repro.models.transformer2d``).

Input is a latent video tensor ``x: (B, T, S, C_in)`` (the VAE/patch
frontend is a stub) plus a diffusion timestep ``t: (B,)`` for adaLN
modulation.  Blocks alternate: a *spatial* block (attention over S,
independent across B, T) then a *temporal* block (attention over T,
independent across B, S).  ``n_layers`` counts blocks: 28 blocks at
d 1152 give the 720M model, 36 at d 2048 the 3B model (paper Table 4).

Per-pair parameters live under ``layers/{spatial,temporal}`` stacked on a
leading n_layers / 2 dim, and linears are (d_in, d_out), as in the JAX
package, so a JAX parameter tree crosses over leaf for leaf
(``repro_torch.bridge``).

DSP (paper §4): on a ``("data", "model")`` process mesh the sequence
enters sharded on T over ``model`` and the batch over ``data``.  The
model declares its stages (``stages``), the planner solves where the
shard sits at each (``dsp_schedule``), and the explicit
``core.schedule.ScheduleExecutor`` issues the switches: one all-to-all
T -> S before each temporal block and one S -> T after it, 2 per layer
pair.  This module never issues a switch itself.  ``forward`` and
``t2d_loss`` take the rank's local shard; ``make_spmd_forward`` takes the
global batch on every rank, as the paper's ``dsp_dataloader`` does.  The
embedded-SP baselines (``ulysses``, ``ring``, ``megatron``, ``hybrid``),
overlapped switches and the 2D layouts (``forward2d``) are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core import dsp
from repro_torch.core.layout import from_mesh
from repro_torch.core.plan import Stage
from repro_torch.core.schedule import (ScheduleExecutor, UnrolledSchedule,
                                       plan_joint_schedule, plan_schedule)
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
# DSP stage declaration + planned switching schedule
# ---------------------------------------------------------------------------

def stages(cfg: T2DConfig, *, t_len: Optional[int] = None,
           s_len: Optional[int] = None, batch: Optional[int] = None,
           grad_dtype_bytes: Optional[int] = None):
    """Declare the model's stage sequence for the switching planner, in
    EXECUTION order: per layer one spatial block (computes along S = dim 2,
    so the shard must sit on T) then one temporal block (computes along
    T = dim 1).  Tensors are (B, T, S, C); with extents given, each stage
    carries the global activation shape so the planner prices transitions in
    paper-Table-2 bytes.  ``grad_dtype_bytes`` declares the width of the
    gradients crossing the same boundaries backward (joint fwd+bwd
    planning; defaults to the activation dtype)."""
    shape = None
    kv = None
    if None not in (t_len, s_len, batch):
        shape = (batch, t_len, s_len, cfg.d_model)
        # K + V activations of one attention (the payload embedded
        # strategies stream or head-scatter; GQA shrinks it)
        kv = 2.0 * batch * t_len * s_len * cfg.kvh * cfg.dh
    db = cfg.dtype.itemsize
    out = []
    for i in range(cfg.n_layers // 2):
        out.append(Stage(frozenset({2}), f"layer{i}.spatial", shape, db,
                         bwd_dtype_bytes=grad_dtype_bytes,
                         kv_bytes=None if kv is None else kv * db,
                         kv_heads=cfg.kvh))
        out.append(Stage(frozenset({1}), f"layer{i}.temporal", shape, db,
                         bwd_dtype_bytes=grad_dtype_bytes,
                         kv_bytes=None if kv is None else kv * db,
                         kv_heads=cfg.kvh))
    return out


def dsp_schedule(cfg: T2DConfig, n: int, *, t_len: Optional[int] = None,
                 s_len: Optional[int] = None, batch: Optional[int] = None,
                 initial: int = 1, topology=None, joint: bool = False,
                 grad_dtype_bytes: Optional[int] = None,
                 overlap: Optional[str] = None):
    """Solve the switching plan for this model (enter sharded on T, return
    to T for the loss/head).  Returns the scan-body ``PeriodicSchedule``
    when the plan repeats with the 2-stage layer period, else the
    ``UnrolledSchedule`` view (``forward`` addresses its boundaries by
    absolute index).

    ``joint=True`` additionally plans the backward pass as its own stage
    graph (``core.plan.plan_joint``): the schedule carries ``bwd_dims``
    when a non-mirrored round trip is strictly cheaper, priced in seconds
    on ``topology`` when one is given (the explicit executor then rejects
    it).  Both dims stay candidates regardless of divisibility: with only
    two sequence dims and each stage forbidding one, excluding either
    leaves some stage infeasible; ``dynamic_switch`` rejects non-divisible
    extents.  ``overlap`` is not ported yet (it needs ``core/overlap.py``
    and the roofline's per-stage compute estimates)."""
    if overlap is not None:
        raise NotImplementedError(f"overlap {overlap!r}: not yet ported")
    st = stages(cfg, t_len=t_len, s_len=s_len, batch=batch,
                grad_dtype_bytes=grad_dtype_bytes)
    solve = plan_joint_schedule if joint else plan_schedule
    sched = solve(st, [1, 2], n=max(n, 1), initial=initial, final=initial,
                  topology=topology)
    try:
        return sched.periodic(2)
    except ValueError:
        return sched.unrolled()


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
    ``fold_hook`` and ``stage_hook`` serve its compiler path and the
    embedded-SP baselines, which are not ported."""
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
# Full forward: one device, or the rank's shard on a DSP mesh
# ---------------------------------------------------------------------------

def forward(params, x, t, cfg: T2DConfig, *, mesh=None, mode: str = "dsp",
            backend: str = "kernel", remat: bool = True, remat_group: int = 2,
            t_offset: int = 0, s_offset: int = 0, topology=None,
            joint: bool = False, schedule=None, overlap: Optional[str] = None):
    """x: (B, T, S, C_in) in the model dtype, t: (B,) or None ->
    (B, T, S, C_in).  Pairs of blocks (spatial, then temporal) in order;
    with ``remat`` each group of ``remat_group`` pairs (1 when the pair
    count is not a multiple, or the plan is not periodic) is checkpointed
    and recomputed whole in the backward, its switches included, JAX's
    hierarchical remat.

    With ``mesh`` (a ``DeviceMesh`` with dims ``("data", "model")``), x
    and t are this rank's shard: its
    batch slice, and on x its slice of T over ``model``.  The planned
    schedule (``dsp_schedule``, or ``schedule``) runs through the explicit
    executor, and the output is the rank's shard in the same layout.
    ``topology``, ``joint`` and ``schedule`` act only with a mesh, as in
    JAX.  Modes other than "dsp" and ``overlap`` are not ported yet."""
    if mode != "dsp":
        raise NotImplementedError(f"transformer2d mode {mode!r}: not yet "
                                  f"ported (only dsp runs)")
    if overlap is not None:
        raise NotImplementedError(f"overlap {overlap!r}: not yet ported")
    ex = ScheduleExecutor.null()
    psched = None
    if mesh is not None:
        ctx = from_mesh(mesh)
        n, t_loc = ctx.sp_size, x.shape[1]
        t_offset = t_offset + ctx.sp_index * t_loc
        psched = schedule if schedule is not None else dsp_schedule(
            cfg, n, t_len=t_loc * n, s_len=x.shape[2],
            batch=x.shape[0] * ctx.dp_size, topology=topology, joint=joint)
        ex = ScheduleExecutor(psched, backend="explicit", ctx=ctx)
    unrolled = isinstance(psched, UnrolledSchedule)

    x = L.patch_embed(params["embed"], x)
    x = add_pos_embed(x, cfg, t_offset, s_offset)
    x = ex.enter(x)                   # planned entry (dataloader split on T)
    t_emb = None
    if cfg.modulate and t is not None:
        t_emb = L.linear(params["t_proj"],
                         L.timestep_embedding(t, cfg.d_model).to(x.dtype))

    layers = params["layers"]
    n_pairs = tree_leaves(layers)[0].shape[0]
    pairs = unstack(layers, n_pairs)
    g = (remat_group if (remat and n_pairs % remat_group == 0
                         and not unrolled) else 1)

    def pair_body(xc, te, i, lp):
        xc = t2d_block(lp["spatial"], xc, cfg, axis=2, t_emb=te,
                       backend=backend)
        # planned boundary: dynamic switch T -> S (one all-to-all)
        xc = ex.boundary(xc, 2 * i + 1 if unrolled else 1)
        xc = t2d_block(lp["temporal"], xc, cfg, axis=1, t_emb=te,
                       backend=backend)
        if not unrolled:
            return ex.wrap(xc)        # planned wrap-around: switch S -> T
        if 2 * i + 2 < psched.n_stages:
            return ex.boundary(xc, 2 * i + 2)
        return xc

    def group_body(i0, xc, te, *group):
        for j, lp in enumerate(group):
            xc = pair_body(xc, te, i0 + j, lp)
        return xc

    for i in range(0, n_pairs, g):
        body = functools.partial(group_body, i)
        group = pairs[i:i + g]
        if remat:
            # no early stop: the recompute reissues every switch of the
            # group, the last one too, on every rank alike
            with set_checkpoint_early_stop(False):
                x = checkpoint(body, x, t_emb, *group, use_reentrant=False)
        else:
            x = body(x, t_emb, *group)
    x = ex.exit(x)                    # planned final layout (loss/head on T)
    x = L.rms_norm(params["final_norm"], x)
    return L.linear(params["head"], x)


def model_dtype_batch(batch: Dict[str, torch.Tensor], cfg: T2DConfig):
    """A video batch with x and target in the model dtype and t as it is,
    as the JAX package's training cell declares them: a float32 batch
    (``data.pipeline``'s) with bfloat16 weights would not multiply."""
    return {k: v if k == "t" else v.to(cfg.dtype) for k, v in batch.items()}


def t2d_loss(params, batch: Dict[str, torch.Tensor], cfg: T2DConfig, *,
             mesh=None, **kw):
    """Diffusion-style MSE against the target latents, in float32.  With
    ``mesh``, ``batch`` is the rank's shard (``shard_video_batch``) and the
    loss is its squared-error sum over the global element count: the ranks'
    losses sum to the global mean, and their gradients, summed over the
    world, to its gradient."""
    pred = forward(params, batch["x"], batch.get("t"), cfg, mesh=mesh, **kw)
    err = (pred.float() - batch["target"].float()) ** 2
    if mesh is None:
        return torch.mean(err), {}
    return err.sum() / (err.numel() * from_mesh(mesh).world_size), {}


def shard_video_batch(batch: Dict[str, torch.Tensor], mesh):
    """The rank's shard of a global video batch held whole by every rank
    (the paper's ``dsp_dataloader``): the batch dim sliced over ``data``,
    and x and target sliced along T over ``model``."""
    ctx = from_mesh(mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % ctx.dp_size:
            raise ValueError(f"batch {v.shape[0]} not divisible by the "
                             f"{ctx.dp_size} data-parallel ranks")
        b_loc = v.shape[0] // ctx.dp_size
        v = v.narrow(0, ctx.dp_index * b_loc, b_loc)
        out[k] = v if v.dim() == 1 else dsp.split(v, 1, ctx.sp_group)
    return out


def make_spmd_forward(cfg: T2DConfig, mesh, *, mode: str = "dsp",
                      backend: str = "kernel", remat: bool = False,
                      overlap: Optional[str] = None):
    """``fwd(params, x, t)`` where x: (B, T, S, C_in) and t: (B,) are the
    global batch, the same on every rank; returns the rank's shard of the
    output, (B / data, T / model, S, C_in).  Batch over ``data``, T over
    ``model`` on entry, positions offset by the rank's T slice, and the
    planned switches through the explicit executor (``forward`` with the
    mesh).  Only ``mode="dsp"`` is ported; the baselines and ``overlap``
    raise."""
    if mode != "dsp":
        raise NotImplementedError(f"transformer2d mode {mode!r}: not yet "
                                  f"ported (only dsp runs)")
    if overlap is not None:
        raise NotImplementedError(f"overlap {overlap!r}: not yet ported")
    from_mesh(mesh)                   # a DeviceMesh, or raise now

    def fwd(params, x, t):
        batch = {"x": x} if t is None else {"x": x, "t": t}
        local = shard_video_batch(batch, mesh)
        return forward(params, local["x"], local.get("t"), cfg, mesh=mesh,
                       backend=backend, remat=remat)

    return fwd
