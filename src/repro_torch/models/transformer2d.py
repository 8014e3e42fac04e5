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
pair (with ``overlap``, each switch as n - 1 per-shard permutes).  This
module never issues a switch itself.

The embedded-SP baselines the paper compares DSP with (Table 3) keep T
sharded throughout and communicate inside the blocks (``MODES``):
``ulysses`` all-to-alls q/k/v/o of each temporal attention between seq
and heads (``ulysses_fused`` stacks q/k/v into one), ``ring`` streams
K/V around the ranks, ``megatron`` all-gathers T into each block and
reduce-scatters its tensor-parallel output, and ``hybrid`` (USP, on the
``("sp_out", "sp_in")`` grid of ``launch.mesh.make_sp2d_mesh``)
all-to-alls inside ``sp_in`` and rings across ``sp_out``.

The 2D layouts (``forward2d``, JAX's TSP fold) run on the ``("sp_out",
"sp_in")`` grid: a layout is a dim PAIR, component k sharding one tensor
dim over grid axis k, so the planner (``stages2d``, ``dsp2d_schedule``)
can put the sequence on one axis and the heads on the other, and each
boundary pays one all-to-all over just the axis it changes.  The explicit
``core.schedule.ScheduleExecutor2D`` issues them.  ``topology=None``
plans in bytes; JAX's ICI/DCN presets (``sp2d_topology``,
``mesh_topology``) describe TPU links and are not ported.

``forward``, ``forward2d`` and ``t2d_loss`` take the rank's local shard;
``make_spmd_forward`` and ``make_spmd_forward2d`` take the global batch on
every rank, as the paper's ``dsp_dataloader`` does.

ZeRO-3 (the specs' own plan, ``zero=True``): with ``param_specs``
(``parallel.partition.param_pspecs`` of the global tree) ``forward`` and
``t2d_loss`` take each rank's slices of the parameters
(``shard_params``: every block weight split on its first dim after the
stack over ``("data", "model")`` flattened, the scales and biases whole,
as JAX's ``build_t2d_cell`` places them) and gather them where they are
read, each checkpointed group of pairs inside its checkpoint;
``param_contract`` counts the calls and bytes that adds to a step, and
``step_contract`` the whole step's with the mode's own.  The
``("sp_out", "sp_in")`` grid (``hybrid``, ``forward2d``) has no ZeRO.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.analysis.roofline import attach_compute_seconds
from repro_torch.core import dsp, megatron_sp, ring, ulysses
from repro_torch.core.layout import SP2D_AXES, from_mesh
from repro_torch.core.overlap import OVERLAP_MODES
from repro_torch.core.plan import (Stage, _as_pair, pair_placement_equal,
                                   plan_switches_2d)
from repro_torch.core.schedule import (Schedule2D, ScheduleExecutor,
                                       ScheduleExecutor2D, UnrolledSchedule,
                                       plan_joint_schedule, plan_schedule,
                                       plan_strategy_schedule)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.lm import remat_step, tree_leaves, tree_map, unstack
from repro_torch.parallel.partition import (param_pspecs, store_contract,
                                            whole_params)


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
    extents.

    ``overlap`` ("chunked" | "double_buffer") attaches per-stage compute
    estimates (``analysis.roofline.attach_compute_seconds``), has the
    solver price switches at their exposed seconds (on ``topology``), and
    stamps the mode on the schedule, so the explicit executor decomposes
    each planned switch into per-shard permutes."""
    st = stages(cfg, t_len=t_len, s_len=s_len, batch=batch,
                grad_dtype_bytes=grad_dtype_bytes)
    if overlap is not None:
        st = attach_compute_seconds(
            st, cfg, topology if topology is not None else max(n, 1))
    solve = plan_joint_schedule if joint else plan_schedule
    sched = solve(st, [1, 2], n=max(n, 1), initial=initial, final=initial,
                  topology=topology, overlap=overlap)
    return _execution_view(sched)


def strategy_schedule(cfg: T2DConfig, n: int, *, t_len: Optional[int] = None,
                      s_len: Optional[int] = None, batch: Optional[int] = None,
                      initial: int = 1, topology=None,
                      overlap: Optional[str] = None):
    """Solve the unified (stage, dim, strategy) plan for this model
    (``core.schedule.plan_strategy_schedule``): on a uniform or absent
    topology it is ``dsp_schedule``'s plan (all "dsp"); on a tiered fabric
    stages may come back with embedded strategies.  The periodic view when
    the plan repeats with the 2-stage layer period, else the unrolled
    one."""
    st = stages(cfg, t_len=t_len, s_len=s_len, batch=batch)
    if overlap is not None:
        st = attach_compute_seconds(
            st, cfg, topology if topology is not None else max(n, 1))
    sched = plan_strategy_schedule(st, [1, 2], n=max(n, 1), initial=initial,
                                   final=initial, topology=topology,
                                   overlap=overlap)
    return _execution_view(sched)


def _execution_view(sched):
    try:
        return sched.periodic(2)
    except ValueError:
        return sched.unrolled()


# ---------------------------------------------------------------------------
# 2D (TSP-fold) stage declaration + planned schedule: layouts are dim PAIRS
# on an ("sp_out", "sp_in") mesh (launch.mesh.make_sp2d_mesh)
# ---------------------------------------------------------------------------

# stage-view (B, T, S, C) dim -> tensor dim of the execution tensors the
# planned boundaries act on (ScheduleExecutor2D ``dims`` maps):
_QKV_DIMS = {1: 2, 2: 3, 3: 4}     # stacked qkv (3, B, T, S, H, dh): the
                                   # stage view's C lands on the HEAD axis
_O_DIMS = {1: 1, 2: 2, 3: 3}       # attention out (B, T, S, H, dh)
# the dataloader's pair layout: T over sp_out, S over sp_in
INITIAL2D = (1, 2)


def stages2d(cfg: T2DConfig, *, t_len: Optional[int] = None,
             s_len: Optional[int] = None, batch: Optional[int] = None):
    """Declare the FOUR stages per layer pair the 2D planner consumes:
    each attention core split out from its projection/norm/MLP region.  A
    core is head-independent, so C (dim 3) is a legal shard BY HEAD for it
    (``Stage.extents`` gives dim 3 the unit ``n_heads``); the regions
    around it compute along C (``compute_dims={3}``), so every collective
    lands on a planned boundary."""
    shape = ext = None
    if None not in (t_len, s_len, batch):
        shape = (batch, t_len, s_len, cfg.d_model)
        ext = (batch, t_len, s_len, cfg.n_heads)
    db = cfg.dtype.itemsize
    out = []
    for i in range(cfg.n_layers // 2):
        out.append(Stage(frozenset({2}), f"layer{i}.sp_attn", shape, db,
                         extents=ext))
        out.append(Stage(frozenset({3}), f"layer{i}.sp_mlp", shape, db,
                         extents=ext))
        out.append(Stage(frozenset({1}), f"layer{i}.t_attn", shape, db,
                         extents=ext))
        out.append(Stage(frozenset({3}), f"layer{i}.t_mlp", shape, db,
                         extents=ext))
    return out


def dsp2d_schedule(cfg: T2DConfig, grid, *, t_len: Optional[int] = None,
                   s_len: Optional[int] = None, batch: Optional[int] = None,
                   initial=INITIAL2D, topology=None):
    """Solve the 2D switching plan (enter and exit at ``initial``, T over
    sp_out and S over sp_in by default) and return the period-4
    ``PeriodicSchedule2D``.  One period is solved with entry = exit = the
    carried layout and tiled, which is the steady state (every stage holds
    the same activation shape).  On a degenerate ``(n, 1)``/``(1, n)``
    grid the planner delegates to the 1D DP."""
    st = stages2d(cfg, t_len=t_len, s_len=s_len, batch=batch)
    body = plan_switches_2d(st[:4], [1, 2, 3], grid=tuple(grid),
                            initial=initial, final=initial,
                            topology=topology)
    sched = Schedule2D(tuple(st), tuple(body) * (len(st) // 4),
                       grid=tuple(grid), initial=initial, final=initial,
                       topology=topology)
    return sched.periodic(4)


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
              attn_impl=None, backend: str = "kernel"):
    """One transformer block computing attention along ``axis`` (1 = T,
    2 = S) of x: (B, T, S, C).  The other sequence dim folds into the batch
    as the minor factor of (B * other).  ``attn_impl(q, k, v)`` on
    (B', L, H, D) replaces K1 (the embedded-SP baselines' temporal
    attention).  JAX's ``fold_hook`` and ``stage_hook`` serve its compiler
    path, which PyTorch lacks."""
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (T) or 2 (S), got {axis}")
    attn_impl = attn_impl or _default_attn(backend)
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


def _megatron_block(p, x, cfg: T2DConfig, *, axis: int, ctx, t_emb=None,
                    backend: str = "kernel"):
    """Megatron-SP layout: x arrives sharded along T (dim 1) over the
    ``model`` group.  All-gather the sequence, compute attention and MLP
    with the rank's slice of the heads and of the hidden dim (tensor
    parallel: q/k/v and the MLP's up projection sliced by column, the
    output projections by row), reduce-scatter the partial outputs back:
    4 collectives, 4M per block (8M per layer pair).  Like JAX's, it reads
    only the weights (the DiT's linears have no bias), and it serves the
    ``gelu`` MLP only (``_check_mode``)."""
    group, n, idx = ctx.sp_group, ctx.sp_size, ctx.sp_index
    b, _, s, _ = x.shape
    h_loc, dh = cfg.n_heads // n, cfg.dh
    mod = _mod6(p, t_emb, cfg)

    def bmod(m):
        return m[:, :, None, :].to(x.dtype)

    def cols(w):       # column-parallel slice of (d_in, d_out)
        size = w.shape[1] // n
        return w.narrow(1, idx * size, size)

    def rows(w):
        size = w.shape[0] // n
        return w.narrow(0, idx * size, size)

    # ---- attention: AG -> TP attention -> RS
    h = L.rms_norm(p["ln1"], x)
    if mod is not None:
        h = _modulate(h, bmod(mod[0]), bmod(mod[1]))
    hg = megatron_sp.allgather_seq(h, 1, group)
    t = hg.shape[1]

    def fold(y):
        if axis == 1:
            return y.transpose(1, 2).reshape(b * s, t, -1)
        return y.reshape(b * t, s, -1)

    def unfold(y):
        if axis == 1:
            return y.reshape(b, s, t, -1).transpose(1, 2)
        return y.reshape(b, t, s, -1)

    hf = fold(hg)
    l = hf.shape[1]
    q = (hf @ cols(p["wq"]["w"])).reshape(-1, l, h_loc, dh)
    k = (hf @ cols(p["wk"]["w"])).reshape(-1, l, h_loc, dh)
    v = (hf @ cols(p["wv"]["w"])).reshape(-1, l, h_loc, dh)
    o = _default_attn(backend)(q, k, v).reshape(-1, l, h_loc * dh)
    o = megatron_sp.reduce_scatter_seq(unfold(o @ rows(p["wo"]["w"])), 1,
                                       group)
    if mod is not None:
        o = o * bmod(mod[2])
    x = x + o

    # ---- MLP: AG -> TP MLP -> RS
    h = L.rms_norm(p["ln2"], x)
    if mod is not None:
        h = _modulate(h, bmod(mod[3]), bmod(mod[4]))
    hg = megatron_sp.allgather_seq(h, 1, group)
    hh = F.gelu(hg @ cols(p["mlp"]["wi"]["w"]), approximate="tanh")
    hh = megatron_sp.reduce_scatter_seq(hh @ rows(p["mlp"]["wo"]["w"]), 1,
                                        group)
    if mod is not None:
        hh = hh * bmod(mod[5])
    return x + hh


# ---------------------------------------------------------------------------
# Full forward: one device, or the rank's shard on a mesh under a mode
# ---------------------------------------------------------------------------

# the paper's DSP and the embedded-SP baselines it compares with (Table 3)
MODES = ("dsp", "ulysses", "ulysses_fused", "ring", "megatron", "hybrid")

# why the ("sp_out", "sp_in") grid refuses ``param_specs``
_NO_GRID_ZERO = (
    "{what} with param_specs: ZeRO on the ('sp_out', 'sp_in') grid is not "
    "ported. The JAX package's training cells place the DiT's parameters "
    "on no such grid, and param_pspecs names the 'data' and 'model' dims, "
    "which it lacks (ROADMAP queue 1 item 3.4)")


def _check_mode(cfg: T2DConfig, mesh, mode: str, overlap: Optional[str]):
    """The mesh's context, once ``mode`` and ``overlap`` are known to run
    ``cfg`` on ``mesh``; raises ValueError where they cannot (JAX's checks
    in ``make_spmd_forward``, and the port's own: ``overlap`` only with
    ``dsp``, ``megatron`` only with the ``gelu`` MLP, whose activation
    JAX's block hard-codes)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if overlap not in OVERLAP_MODES:
        raise ValueError(f"overlap {overlap!r} not in {OVERLAP_MODES}")
    if overlap is not None and mode != "dsp":
        raise ValueError(f"overlap decomposes DSP's planned switches; mode "
                         f"{mode!r} has none")
    if mode == "megatron" and cfg.kvh != cfg.n_heads:
        raise ValueError("megatron mode TP-slices wq/wk/wv uniformly and "
                         "assumes MHA (n_kv_heads == n_heads)")
    if mode == "megatron" and cfg.mlp_kind != "gelu":
        raise ValueError(f"megatron mode runs the gelu MLP only, not "
                         f"{cfg.mlp_kind!r}")
    if mode == "ulysses_fused" and cfg.kvh != cfg.n_heads:
        raise ValueError("ulysses_fused stacks q/k/v and needs equal "
                         "shapes (MHA); use mode='ulysses' for GQA")
    ctx = from_mesh(mesh)
    names = tuple(mesh.mesh_dim_names)
    if mode == "hybrid":
        missing = [a for a in SP2D_AXES if a not in names]
        if missing:
            raise ValueError(
                f"hybrid mode needs a 2D SP mesh with dims {SP2D_AXES} "
                f"(launch.mesh.make_sp2d_mesh); missing {missing}")
        p_in = ctx.size("sp_in")
        if cfg.n_heads % p_in or cfg.kvh % p_in:
            raise ValueError(
                f"hybrid mode all-to-alls heads over sp_in: n_heads "
                f"{cfg.n_heads} and kv_heads {cfg.kvh} must divide by "
                f"sp_in={p_in}")
        return ctx
    if "model" not in names:
        raise ValueError(f"mode {mode!r} shards T over a 'model' mesh dim; "
                         f"the mesh has {names}")
    n = ctx.sp_size
    if mode == "megatron" and cfg.n_heads % n:
        raise ValueError(f"megatron mode slices {cfg.n_heads} heads over "
                         f"{n} ranks")
    if mode == "ulysses" and cfg.kvh != cfg.n_heads and cfg.kvh % n:
        raise ValueError(
            f"ulysses mode all-to-alls K/V heads over the SP dim: kv_heads "
            f"{cfg.kvh} must divide by n={n} (or use MHA)")
    return ctx


def _mode_block(cfg: T2DConfig, mode: str, ctx, backend: str):
    """``block(p, x, axis=, t_emb=)`` running one block of an embedded-SP
    ``mode`` on the rank's T shard: the spatial blocks attend locally
    through K1, the temporal ones through the mode's distributed
    attention (megatron wraps both)."""
    if mode == "megatron":
        return functools.partial(_megatron_block, cfg=cfg, ctx=ctx,
                                 backend=backend)
    if mode in ("ulysses", "ulysses_fused"):
        ua = (ulysses.ulysses_attention if mode == "ulysses"
              else ulysses.ulysses_attention_fused)
        inner = _default_attn(backend)

        def temporal(q, k, v):
            return ua(q, k, v, inner, ctx.sp_group)
    elif mode == "ring":
        def temporal(q, k, v):
            return ring.ring_attention(q, k, v, ctx.sp_group, causal=False)
    else:
        def temporal(q, k, v):
            return ulysses.usp_attention(q, k, v, ctx.group("sp_in"),
                                         ctx.group("sp_out"), causal=False)

    def block(p, x, *, axis, t_emb):
        return t2d_block(p, x, cfg, axis=axis, t_emb=t_emb, backend=backend,
                         attn_impl=temporal if axis == 1 else None)
    return block


def forward(params, x, t, cfg: T2DConfig, *, mesh=None, mode: str = "dsp",
            backend: str = "kernel", remat: bool = True, remat_group: int = 2,
            t_offset: int = 0, s_offset: int = 0, topology=None,
            joint: bool = False, schedule=None, overlap: Optional[str] = None,
            param_specs=None):
    """x: (B, T, S, C_in) in the model dtype, t: (B,) or None ->
    (B, T, S, C_in).  Pairs of blocks (spatial, then temporal) in order;
    with ``remat`` each group of ``remat_group`` pairs (1 when the pair
    count is not a multiple, or the plan is not periodic) is checkpointed
    and recomputed whole in the backward, its collectives included, JAX's
    hierarchical remat.

    With ``mesh`` (a ``DeviceMesh``: ``("data", "model")``, or the
    ``("sp_out", "sp_in")`` grid for ``hybrid``), x and t are this rank's
    shard: its batch slice, and on x its slice of T over the SP dims; the
    output is the rank's shard in the same layout.  ``mode`` (``MODES``)
    says how the ranks share the blocks: ``dsp`` runs the planned schedule
    (``dsp_schedule``, or ``schedule``) through the explicit executor,
    with ``overlap`` its switches as per-shard permutes; the baselines run
    their own collectives inside the blocks.  ``topology``, ``joint`` and
    ``schedule`` act only with a mesh and ``dsp``, as in JAX.  Without a
    mesh there are no ranks to share the work, so ``mode`` must be
    ``dsp`` and ``overlap`` None.

    With a mesh and ``param_specs`` (``param_pspecs`` of the global tree
    at the mesh's sizes), ``params`` are this rank's slices
    (``shard_params``).  Each checkpointed group gathers its pairs' split
    leaves at the top of its body, inside the checkpoint, so that no
    gathered weight lives from the forward to the backward: the recompute
    gathers them again (without ``remat`` each group gathers once).
    ``embed``, ``t_proj``, ``final_norm`` and ``head`` are gathered where
    they are read.  Each gather's backward reduce-scatters the gradient in
    float32 (``core.dsp.gather_param``).  The gather sits at the group
    boundary, so every mode on a ``("data", "model")`` mesh runs it;
    ``hybrid`` raises ``NotImplementedError`` (``_NO_GRID_ZERO``)."""
    ex = ScheduleExecutor.null()
    psched = None
    ctx = None

    def block(p, xc, *, axis, t_emb):
        return t2d_block(p, xc, cfg, axis=axis, t_emb=t_emb, backend=backend)

    if mesh is None:
        if mode != "dsp" or overlap is not None:
            raise ValueError(f"mode {mode!r} and overlap {overlap!r} share "
                             f"the work over a mesh: pass mesh=")
    else:
        ctx = _check_mode(cfg, mesh, mode, overlap)
        if param_specs is not None and mode == "hybrid":
            raise NotImplementedError(_NO_GRID_ZERO.format(
                what="mode 'hybrid'"))
        n, t_loc = ctx.sp_size, x.shape[1]
        t_offset = t_offset + ctx.sp_index * t_loc
        if mode == "dsp":
            psched = schedule if schedule is not None else dsp_schedule(
                cfg, n, t_len=t_loc * n, s_len=x.shape[2],
                batch=x.shape[0] * ctx.dp_size, topology=topology,
                joint=joint, overlap=overlap)
            ex = ScheduleExecutor(psched, backend="explicit", ctx=ctx,
                                  overlap=overlap)
        else:
            block = _mode_block(cfg, mode, ctx, backend)
    unrolled = isinstance(psched, UnrolledSchedule)

    def whole(key):                   # a leaf group outside the pairs
        return whole_params(params[key], None if param_specs is None
                            else param_specs[key], ctx)

    x = L.patch_embed(whole("embed"), x)
    x = add_pos_embed(x, cfg, t_offset, s_offset)
    x = ex.enter(x)                   # planned entry (dataloader split on T)
    t_emb = None
    if cfg.modulate and t is not None:
        t_emb = L.linear(whole("t_proj"),
                         L.timestep_embedding(t, cfg.d_model).to(x.dtype))

    layers = params["layers"]
    layer_specs = None if param_specs is None else param_specs["layers"]
    n_pairs = tree_leaves(layers)[0].shape[0]
    pairs = unstack(layers, n_pairs)
    g = (remat_group if (remat and n_pairs % remat_group == 0
                         and not unrolled) else 1)

    def pair_body(xc, te, i, lp):
        xc = block(lp["spatial"], xc, axis=2, t_emb=te)
        # planned boundary: dynamic switch T -> S (one all-to-all)
        xc = ex.boundary(xc, 2 * i + 1 if unrolled else 1)
        xc = block(lp["temporal"], xc, axis=1, t_emb=te)
        if not unrolled:
            return ex.wrap(xc)        # planned wrap-around: switch S -> T
        if 2 * i + 2 < psched.n_stages:
            return ex.boundary(xc, 2 * i + 2)
        return xc

    def group_body(i0, xc, te, *group):
        for j, lp in enumerate(group):
            lp = whole_params(lp, layer_specs, ctx, stacked=True)
            xc = pair_body(xc, te, i0 + j, lp)
        return xc

    for i in range(0, n_pairs, g):
        body = functools.partial(group_body, i)
        group = pairs[i:i + g]
        if remat:
            # no early stop: the recompute reissues every collective of the
            # group, the last one too, on every rank alike
            with set_checkpoint_early_stop(False):
                x = checkpoint(body, x, t_emb, *group, use_reentrant=False)
        else:
            x = body(x, t_emb, *group)
    x = ex.exit(x)                    # planned final layout (loss/head on T)
    x = L.rms_norm(whole("final_norm"), x)
    return L.linear(whole("head"), x)


def param_contract(cfg: T2DConfig, params, plan,
                   sizes: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls and bytes, by kind (``core.dsp``'s
    rule), that the parameter layouts of ``plan`` add per rank to one
    training step of ``t2d_loss`` with ``remat`` (``param_specs=``, the
    batch carrying t) on a mesh of ``sizes`` (``mesh_sizes``), beside the
    mode's own collectives (``step_contract`` adds them).  Derived from
    ``param_pspecs`` of ``params``, the GLOBAL tree (meta tensors will
    do), each leaf read as ``forward`` reads it
    (``parallel.partition.store_contract``, which adds the trainer's
    all-reduces):

      each pair leaf a spec splits: per pair, 2 all-gathers of the whole
        leaf (the forward's and the recompute's) and 1 reduce-scatter of
        its float32 gradient, whatever ``remat_group``: each group gathers
        its own pairs;
      ``embed``, ``final_norm``, ``head`` and, where ``cfg`` modulates,
        ``t_proj``: 1 all-gather and 1 reduce-scatter of each leaf a spec
        splits.

    An entry naming only dims of size 1 is still issued (at one rank each
    is a copy)."""
    def reads(path):
        if path[0] == "layers":
            return 2, 1
        if path[0] == "t_proj" and not cfg.modulate:
            return 0, 0
        return 1, 1
    return store_contract(params, param_pspecs(params, plan,
                                               axis_sizes=sizes),
                          sizes, reads)


def step_contract(cfg: T2DConfig, params, plan, sizes: Dict[str, int], *,
                  batch: int, frames: int, patches: int, mode: str = "dsp",
                  schedule=None) -> Dict[str, Dict[str, int]]:
    """{"calls": {kind: n}, "bytes": {kind: n}} per rank of one training
    step of ``t2d_loss`` with ``remat`` under ``mode`` and
    ``param_specs=`` on a ``sizes`` mesh, at a global ``batch`` x
    ``frames`` x ``patches``: the mode's collectives in one forward
    (``dsp``: the switches of ``schedule``, by default ``forward``'s own
    ``dsp_schedule``, each the rank's stream; ``ulysses``: a temporal
    block's all-to-alls of the rank's q, k, v and o) three times over
    (forward, recompute, backward: ``lm.remat_step``), plus
    ``param_contract`` (the gathers, their reduce-scatters, the trainer's
    all-reduces)."""
    dp, mp = sizes["data"], sizes["model"]
    pairs = cfg.n_layers // 2
    stream = (batch // dp * frames // mp * patches * cfg.d_model
              * cfg.dtype.itemsize)
    if mode == "dsp":
        psched = schedule if schedule is not None else dsp_schedule(
            cfg, mp, t_len=frames, s_len=patches, batch=batch)
        n = ScheduleExecutor(psched, backend="explicit").expected_collectives(
            pairs).get("all-to-all", 0)
        moved = n * stream
    elif mode == "ulysses":
        n = 4 * pairs
        moved = pairs * 2 * stream * (cfg.n_heads + cfg.kvh) // cfg.n_heads
    else:
        raise ValueError(f"step_contract counts modes 'dsp' and 'ulysses'; "
                         f"got {mode!r}")
    step = remat_step({"calls": {"all-to-all": n},
                       "bytes": {"all-to-all": moved}})
    layout = param_contract(cfg, params, plan, sizes)
    return {part: {k: step[part].get(k, 0) + layout[part].get(k, 0)
                   for k in {*step[part], *layout[part]}}
            for part in ("calls", "bytes")}


def _check_2d(cfg: T2DConfig, mesh):
    """The mesh's context, once ``cfg`` and ``mesh`` can run ``forward2d``
    (JAX's checks and messages)."""
    if cfg.kvh != cfg.n_heads:
        raise ValueError("forward2d stacks q/k/v for the fused planned "
                         "switch and needs MHA (n_kv_heads == n_heads)")
    ctx = from_mesh(mesh)
    missing = [a for a in SP2D_AXES if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(
            f"forward2d needs the 2D SP mesh of launch.mesh.make_sp2d_mesh "
            f"(axes ('sp_out', 'sp_in')); missing {missing}")
    return ctx


def forward2d(params, x, t, cfg: T2DConfig, *, mesh, backend: str = "kernel",
              remat: bool = True, schedule=None, param_specs=None):
    """The 2D-layout forward on an ``("sp_out", "sp_in")`` mesh.

    x: (B, T, S, C_in) and t: (B,), this rank's shard at the plan's
    ``initial`` pair layout (``shard_video_batch2d``; T over sp_out and S
    over sp_in for (1, 2)) -> the rank's shard at ``final``.  The planned
    ``Schedule2D`` (``dsp2d_schedule``, or ``schedule``) drives every
    boundary through the explicit ``ScheduleExecutor2D``, which issues
    exactly ``expected_carry_collectives``.  The residual is carried at
    the last in-period layout and the attention-core layouts live inside
    each block.  A core that shards C (by head) takes its switch in on the
    stacked (3, B, T, S, H, dh) q/k/v of one fused projection (so MHA is
    required) and its switch out on the attention output before ``wo``,
    as JAX's does; the residual skips it, so the plan must hold it alike
    after both blocks.  A core that keeps C whole takes both switches on
    the stream itself, before the block's norm and after its attention
    residual add, which moves the residual with it: JAX switches q/k/v
    there too and leaves the residual to XLA, whose reshards its
    accounting does not count (PERF.md §6).  K1 runs every core, on the
    heads the layout leaves the rank.  With ``remat`` each layer pair is
    checkpointed, its collectives included.  Gradients flow through the
    switches' transposes; no 2D backward is planned.  ``param_specs``
    raises ``NotImplementedError``: the grid has no ZeRO
    (``_NO_GRID_ZERO``)."""
    if param_specs is not None:
        raise NotImplementedError(_NO_GRID_ZERO.format(what="forward2d"))
    ctx = _check_2d(cfg, mesh)
    grid = (ctx.size("sp_out"), ctx.size("sp_in"))
    initial = (schedule.schedule.initial if schedule is not None
               else INITIAL2D)
    nt, it = ctx.pair_index(_as_pair(initial), 1)
    ns, is_ = ctx.pair_index(_as_pair(initial), 2)
    psched = schedule if schedule is not None else dsp2d_schedule(
        cfg, grid, t_len=x.shape[1] * nt, s_len=x.shape[2] * ns,
        batch=x.shape[0] * ctx.dp_size)
    ex = ScheduleExecutor2D(psched, backend="explicit", ctx=ctx)
    lay = psched.layouts
    if not pair_placement_equal(lay[-1], initial, grid):
        raise ValueError(
            f"forward2d carries the residual at the last in-period layout "
            f"and enters at the schedule's initial; the plan ends its "
            f"period at {lay[-1]} but enters at {initial} — "
            f"pass initial equal to the steady-state mlp layout")
    # a core that shards C (by head) takes its switches on the stacked
    # q/k/v and on the attention output, and the residual skips it
    heads = tuple(3 in lay[i] for i in (0, 2))
    if any(heads) and not ex.same_placement(1, 3):
        raise ValueError(
            f"a head-sharded core leaves the residual unswitched, but the "
            f"plan holds it at {lay[1]} after the spatial block and at "
            f"{lay[3]} after the temporal one")

    x = L.patch_embed(params["embed"], x)
    x = add_pos_embed(x, cfg, it * x.shape[1], is_ * x.shape[2])
    x = ex.carry_enter(x)               # initial -> the carried layout
    t_emb = None
    if cfg.modulate and t is not None:
        t_emb = L.linear(params["t_proj"],
                         L.timestep_embedding(t, cfg.d_model).to(x.dtype))
    attn = _default_attn(backend)

    def half_block(p, xc, te, *, axis, core):
        # one block, from the carried layout to stage core + 1's.  The
        # switch into the core (the wrap for the spatial one, boundary 2
        # for the temporal) and the one out of it act on the stacked q/k/v
        # and the attention output when the core shards C, else on the
        # stream itself, which then carries the residual along
        def enter(y, **kw):
            return (ex.wrap(y, **kw) if core == 0
                    else ex.boundary(y, core, **kw))

        by_head = heads[core // 2]
        if not by_head:
            xc = enter(xc)
        b, t_, s_, _ = xc.shape
        hh, dh = cfg.n_heads, cfg.dh
        mod = _mod6(p, te, cfg)

        def bmod(m):
            return m[:, :, None, :].to(xc.dtype)

        h = L.rms_norm(p["ln1"], xc)
        if mod is not None:
            h = _modulate(h, bmod(mod[0]), bmod(mod[1]))
        # ONE fused projection, so one switch moves q, k and v
        wqkv = torch.cat([p["wq"]["w"], p["wk"]["w"], p["wv"]["w"]], dim=1)
        qkv = h @ wqkv
        if "b" in p["wq"]:
            qkv = qkv + torch.cat([p["wq"]["b"], p["wk"]["b"], p["wv"]["b"]])
        qkv = qkv.reshape(b, t_, s_, 3, hh, dh).permute(3, 0, 1, 2, 4, 5)
        if by_head:
            qkv = enter(qkv, dims=_QKV_DIMS, batch_dim=1)
        q, k, v = qkv.unbind(0)
        # fold the other sequence dim into the attention batch, its factor
        # major (JAX's order), at the core's local shape
        _, tc, sc, hc, _ = q.shape
        if axis == 1:      # temporal: attend over T, batch (S, B)
            fold_dims = {2: 0, 1: 1, 3: 2}

            def fold(y):
                y = y.permute(2, 0, 1, 3, 4).reshape(sc * b, tc, hc, dh)
                return ex.fold_anchor(y, core, dims=fold_dims)

            def unfold(y):
                return y.reshape(sc, b, tc, hc, dh).permute(1, 2, 0, 3, 4)
        else:              # spatial: attend over S, batch (T, B)
            fold_dims = {1: 0, 2: 1, 3: 2}

            def fold(y):
                y = y.permute(1, 0, 2, 3, 4).reshape(tc * b, sc, hc, dh)
                return ex.fold_anchor(y, core, dims=fold_dims)

            def unfold(y):
                return y.reshape(tc, b, sc, hc, dh).permute(1, 0, 2, 3, 4)
        o = unfold(attn(fold(q), fold(k), fold(v)))
        if by_head:
            o = ex.boundary(o, core + 1, dims=_O_DIMS)
        o = L.linear(p["wo"], o.flatten(3))
        if mod is not None:
            o = o * bmod(mod[2])
        xc = xc + o
        if not by_head:
            xc = ex.boundary(xc, core + 1)
        xc = ex.anchor(xc, core + 1)
        h = L.rms_norm(p["ln2"], xc)
        if mod is not None:
            h = _modulate(h, bmod(mod[3]), bmod(mod[4]))
        h = L.mlp(p["mlp"], h, cfg.mlp_kind)
        if mod is not None:
            h = h * bmod(mod[5])
        return ex.anchor(xc + h, core + 1)

    def pair_body(xc, te, lp):
        xc = half_block(lp["spatial"], xc, te, axis=2, core=0)
        return half_block(lp["temporal"], xc, te, axis=1, core=2)

    layers = params["layers"]
    for lp in unstack(layers, tree_leaves(layers)[0].shape[0]):
        if remat:
            # no early stop: the recompute reissues every collective of the
            # pair on every rank alike
            with set_checkpoint_early_stop(False):
                x = checkpoint(pair_body, x, t_emb, lp, use_reentrant=False)
        else:
            x = pair_body(x, t_emb, lp)
    x = ex.carry_exit(x)                # the carried layout -> final
    x = L.rms_norm(params["final_norm"], x)
    return L.linear(params["head"], x)


def shard_video_batch2d(batch: Dict[str, torch.Tensor], mesh):
    """The rank's shard of a global video batch held whole by every rank,
    at ``forward2d``'s entry layout (1, 2): the batch dim sliced over the
    data dims, T over sp_out and S over sp_in, on every tensor that has
    them."""
    ctx = from_mesh(mesh)
    out = {}
    for k, v in batch.items():
        v = dsp.shard(v, 0, ctx.dp_size, ctx.dp_index)
        for ax, d in zip(SP2D_AXES, INITIAL2D):
            if d < v.dim():
                v = dsp.shard(v, d, ctx.size(ax), ctx.index(ax))
        out[k] = v
    return out


def gather_video2d(y: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of ``shard_video_batch2d`` over the SP dims: T and S
    whole (the batch stays sliced over the data dims), by one all-gather
    per grid axis."""
    ctx = from_mesh(mesh)
    for ax, d in zip(SP2D_AXES, INITIAL2D):
        y = dsp.gather(y, d, ctx.group(ax))
    return y


def make_spmd_forward2d(cfg: T2DConfig, mesh, *, backend: str = "kernel"):
    """``fwd(params, x, t)`` where x: (B, T, S, C_in) and t: (B,) are the
    global batch, the same on every rank; returns the rank's shard of the
    output at the plan's final pair layout, which is its initial (1, 2)
    (``gather_video2d`` makes it whole).  Batch over the data dims, T over
    sp_out and S over sp_in on entry, positions offset by the rank's grid
    coordinates, then ``forward2d`` without remat.  Raises ValueError
    where ``forward2d`` cannot run ``cfg`` on ``mesh``, as JAX's does."""
    _check_2d(cfg, mesh)

    def fwd(params, x, t):
        batch = {"x": x} if t is None else {"x": x, "t": t}
        local = shard_video_batch2d(batch, mesh)
        return forward2d(params, local["x"], local.get("t"), cfg, mesh=mesh,
                         backend=backend, remat=False)

    return fwd


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
    world, to its gradient.  ``kw`` go to ``forward``; with
    ``param_specs`` ``params`` are the rank's slices, and their gradients
    the rank's slices of the gradient, summed over the dims each leaf is
    split over (``train.trainer.allreduce_grads`` sums the rest)."""
    pred = forward(params, batch["x"], batch.get("t"), cfg, mesh=mesh, **kw)
    err = (pred.float() - batch["target"].float()) ** 2
    if mesh is None:
        return torch.mean(err), {}
    return err.sum() / (err.numel() * from_mesh(mesh).world_size), {}


def shard_video_batch(batch: Dict[str, torch.Tensor], mesh):
    """The rank's shard of a global video batch held whole by every rank
    (the paper's ``dsp_dataloader``): the batch dim sliced over the data
    dims, and x and target sliced along T over the SP dims (``sp_out``
    major on a 2D SP grid)."""
    ctx = from_mesh(mesh)
    out = {}
    for k, v in batch.items():
        v = dsp.shard(v, 0, ctx.dp_size, ctx.dp_index)
        if v.dim() > 1:
            v = dsp.shard(v, 1, ctx.sp_size, ctx.sp_index)
        out[k] = v
    return out


def make_spmd_forward(cfg: T2DConfig, mesh, *, mode: str = "dsp",
                      backend: str = "kernel", remat: bool = False,
                      overlap: Optional[str] = None):
    """``fwd(params, x, t)`` where x: (B, T, S, C_in) and t: (B,) are the
    global batch, the same on every rank; returns the rank's shard of the
    output, (B / data, T / SP, S, C_in).  Batch over the data dims, T over
    the SP dims on entry, positions offset by the rank's T slice, and the
    blocks shared under ``mode`` (``forward`` with the mesh): ``dsp`` (the
    planned switches, with ``overlap`` as per-shard permutes),
    ``ulysses``, ``ulysses_fused``, ``ring``, ``megatron``, or ``hybrid``
    (USP) on a ``make_sp2d_mesh`` grid.  Per-rank collectives and bytes
    follow paper Table 3 (``core.dsp.calls`` and ``volume``).  Raises
    ValueError where the mode cannot run ``cfg`` on ``mesh``, as JAX's
    does."""
    _check_mode(cfg, mesh, mode, overlap)

    def fwd(params, x, t):
        batch = {"x": x} if t is None else {"x": x, "t": t}
        local = shard_video_batch(batch, mesh)
        return forward(params, local["x"], local.get("t"), cfg, mesh=mesh,
                       mode=mode, backend=backend, remat=remat,
                       overlap=overlap)

    return fwd
