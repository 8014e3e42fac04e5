"""Decoder-only LM assembled from per-layer block specs (counterpart of
``repro.models.lm``): init, the training forward and loss, and the serving
path (prefill, decode, logits).

Per-period layer parameters live under ``periods`` stacked on a leading
``n_periods`` dim, as in the JAX package, so a JAX parameter tree crosses
over with no transpose (``repro_torch.bridge``).  The JAX ``lax.scan`` over
periods is a Python loop here.  Attention, MLP, MoE (``models.moe``, the
gather dispatch on every path, as JAX's) and SSM layers are ported; the
training forward returns MoE's load-balance aux beside the hidden states,
and ``lm_loss`` adds it as JAX's does.

Training runs under DSP through a ``parallel.partition.Sharder``
(``forward``/``lm_loss(sharder=...)``): the model calls the sharder's
hooks at its stage boundaries, and WHICH dim each stage shards comes from
the planned switching schedule (``stages``/``dsp_schedule`` ->
``core.plan`` solver), attached to the sharder at the top of each forward.
On a ``("data", "model")`` mesh the rank holds its batch slice and its
sequence shard (``shard_lm_batch``); the residual stream stays
sequence-sharded, each attention core and SSD scan runs on the rank's
heads after one switch and switches back (``collective_contract`` counts
what a forward issues).  Under the specs' own plans the parameters are
the rank's slices (``parallel.partition.shard_params``: ZeRO-3 over
``("data", "model")``, the embedding tables over ``model``), gathered
whole where the model reads them (``Sharder.whole``), the embedding
through JAX's vocab ring (``sharded_embed``; ``param_contract`` counts
what the layouts add to a step).  Serving runs sharded the same way
(``forward_prefill``/``forward_decode(sharder=)``): the prefill as the
training forward, decode with the KV cache sequence-sharded and the SSM
state head-sharded over ``model`` (``serve_contract`` counts what it
issues).  MoE trains and serves on the mesh with ``ep`` or without
(``Sharder.moe_experts``, ``moe_block``): the training forward and the
prefill route the rank's sequence shard (a padded prefill's padding
takes no expert slot), and a serving step routes its tokens, whole on
every rank, on each rank.

Under plan ``tp`` (``check_tp``: attention, dense MLP and MoE layers, the
q heads divided by the ranks) each attention and MLP block gathers the
whole sequence, runs the rank's heads or hidden columns and
reduce-scatters the rows' partial outputs back
(``attention.attention_sp``, ``tp_mlp``); a MoE layer runs its experts
as under DSP with ``ep``, else the rank's hidden columns of every expert
inside such a block (``moe_block``); serving decodes with the step's
q/k/v heads gathered and one all-reduce a block;
``collective_contract(tp=True)``, ``param_contract`` and
``serve_contract`` count it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core import dsp
from repro_torch.core.overlap import ring_stream
from repro_torch.core.plan import Stage
from repro_torch.core.schedule import (Schedule, plan_joint_schedule,
                                       plan_schedule)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.parallel.partition import (
    ParallelPlan, Sharder, cache_pspecs, gathered_numels, null_sharder,
    param_pspecs, read_numels, read_specs, slice_index, store_contract,
    tree_map_with_path)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"                  # "attn" | "ssm"
    ffn: str = "mlp"                     # "mlp" | "moe" | "none"
    window: Optional[int] = None         # sliding window for this layer


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention variants
    mlp_kind: str = "silu_glu"
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_bias: bool = False
    embed_scale: bool = False
    norm_kind: str = "rms"               # "rms" | "layer"
    post_norm: bool = False              # gemma2-style post-block norms
    tie_embeddings: bool = True
    # layer pattern (period definition)
    window: Optional[int] = None
    window_pattern: Optional[str] = None  # "local_global"
    ssm_every: Optional[int] = None       # jamba: attn at i%ssm_every==offset
    ssm_attn_offset: int = 3
    pure_ssm: bool = False                # mamba2
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                    # moe at i % moe_every == moe_offset
    moe_offset: int = 0
    n_shared: int = 0
    shared_ff: Optional[int] = None
    dense_ff: Optional[int] = None        # arctic parallel-dense residual
    norm_topk: bool = True
    ep_pad: Optional[int] = None          # pad experts for EP divisibility
    # ssm geometry (models.ssm.SSMConfig)
    ssm_cfg: Any = None
    # frontend stub (vlm): precomputed patch embeddings merged into sequence
    frontend_dim: Optional[int] = None
    frontend_tokens: int = 0
    dtype: Any = torch.bfloat16
    # KV cache dtype (None = dtype)
    cache_dtype: Any = None

    # -- derived -------------------------------------------------------------
    def attn_cfg(self, window: Optional[int]) -> A.AttnConfig:
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            qk_norm=self.qk_norm, rope=True, rope_theta=self.rope_theta,
            window=window, softcap=self.attn_softcap, bias=self.attn_bias)

    def period_specs(self) -> List[LayerSpec]:
        if self.pure_ssm:
            return [LayerSpec(mixer="ssm", ffn="none")]
        if self.ssm_every:                              # hybrid (jamba)
            out = []
            for i in range(self.ssm_every):
                mixer = "attn" if i == self.ssm_attn_offset else "ssm"
                ffn = ("moe" if self.n_experts and
                       i % self.moe_every == self.moe_offset else "mlp")
                out.append(LayerSpec(mixer=mixer, ffn=ffn, window=None))
            return out
        if self.window_pattern == "local_global":
            return [LayerSpec(ffn=self._ffn(0), window=self.window),
                    LayerSpec(ffn=self._ffn(1), window=None)]
        if self.n_experts and self.moe_every > 1:
            return [LayerSpec(ffn=self._ffn(i), window=self.window)
                    for i in range(self.moe_every)]
        return [LayerSpec(ffn=self._ffn(0), window=self.window)]

    def _ffn(self, i: int) -> str:
        if self.n_experts and i % self.moe_every == self.moe_offset:
            return "moe"
        return "mlp"

    @property
    def n_periods(self) -> int:
        period = len(self.period_specs())
        if self.n_layers % period:
            raise ValueError(f"{self.n_layers} layers not a multiple of the "
                             f"period {period}")
        return self.n_layers // period


# ---------------------------------------------------------------------------
# Parameter trees (nested dicts of tensors)
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leafwise over dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts, in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def _period(tree, i: int):
    """Period ``i`` of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def unstack(tree, n: int) -> List[Any]:
    """All ``n`` periods of a stacked tree, as views from one ``unbind``
    per leaf: the backward stacks each leaf's period grads once, where
    ``n`` separate selects would each add a zero-filled full-size grad."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


# ---------------------------------------------------------------------------
# DSP stage declaration + planned switching schedule
# ---------------------------------------------------------------------------

def stages(cfg: LMConfig, *, seq: Optional[int] = None,
           batch: Optional[int] = None) -> List[Stage]:
    """Declare the model's stage sequence on the logical (B, S, H·Dh) view
    for the switching planner: channel-wise stages (projections, norms,
    FFN) compute along dim 2, the mixer cores (attention softmax / SSD
    scan) along dim 1 — DSP-1D, where the "second sequence dim" is the
    head or channel axis.  With extents given, stages carry global shapes
    so the planner prices transitions in bytes; the gradients crossing the
    boundaries backward are priced at the activation dtype (JAX's
    ``grad_dtype_bytes``, which no caller sets, is not ported)."""
    specs = cfg.period_specs()
    shape = (batch, seq, cfg.d_model) if None not in (seq, batch) else None
    db = cfg.dtype.itemsize
    out: List[Stage] = []
    for layer in range(cfg.n_layers):
        spec = specs[layer % len(specs)]
        out.append(Stage(frozenset({2}), f"L{layer}.proj", shape, db))
        out.append(Stage(frozenset({1}), f"L{layer}.{spec.mixer}", shape, db))
        if spec.ffn != "none":
            out.append(Stage(frozenset({2}), f"L{layer}.{spec.ffn}", shape,
                             db))
    return out


def stage_period(cfg: LMConfig) -> int:
    """Stages per layer period."""
    return sum(2 if s.ffn == "none" else 3 for s in cfg.period_specs())


def dsp_schedule(cfg: LMConfig, n: int, *, seq: Optional[int] = None,
                 batch: Optional[int] = None, topology=None,
                 joint: bool = False, bwd_dims=None) -> Schedule:
    """Solve the switching plan (enter sequence-sharded from the dataloader
    split, return to it for the loss) and validate it is periodic with the
    layer period.  ``topology`` (``core.topology.Topology``) prices the plan
    in seconds on its links; None prices it in bytes (JAX's TPU link
    presets are not ported).  ``joint=True`` plans the backward too
    (``core.plan.plan_joint``), falling back to the mirrored plan when the
    joint one is not periodic.
    ``bwd_dims`` forces a backward plan (one period or every stage), as
    JAX's parity tests do; the hooks run the mirrored backward only, so
    ``make_sharder`` refuses a forced non-mirrored one.  JAX's ``overlap``
    comes with ROADMAP queue 1 item 2."""
    st = stages(cfg, seq=seq, batch=batch)
    period = stage_period(cfg)
    kw = dict(n=max(n, 1), initial=1, final=1, topology=topology)
    if joint:
        sched = plan_joint_schedule(st, (1, 2), **kw)
        try:
            sched.periodic(period)
        except ValueError:
            sched = plan_joint_schedule(st, (1, 2), require_mirrored=True,
                                        **kw)
    else:
        sched = plan_schedule(st, (1, 2), **kw)
    if bwd_dims is not None:
        bwd_dims = tuple(bwd_dims)
        if len(bwd_dims) == period:
            bwd_dims = bwd_dims * (len(st) // period)
        if len(bwd_dims) != len(st):
            raise ValueError(
                f"bwd_dims must cover one period ({period} stages) or the "
                f"full plan ({len(st)} stages); got {len(bwd_dims)}")
        sched = dataclasses.replace(sched, bwd_dims=bwd_dims)
    sched.periodic(period)     # a steady state on both legs
    return sched


def check_tp(cfg: LMConfig, n: int) -> None:
    """Raise unless plan ``tp`` runs ``cfg`` over ``n`` model ranks: its
    attention splits the q heads (``n_heads % n == 0``), and its layers
    are attention, dense MLPs and MoE."""
    specs = cfg.period_specs()
    if any(sp.mixer == "ssm" for sp in specs):
        raise NotImplementedError(
            f"{cfg.name}: plan 'tp' with SSM layers is not ported yet "
            f"(ROADMAP queue 1 item 7.9)")
    if cfg.n_heads % n:
        raise ValueError(f"{cfg.name}: plan 'tp' splits the q heads over "
                         f"the model ranks: n_heads {cfg.n_heads} % {n} "
                         f"!= 0")


def kv_whole(cfg: LMConfig, plan: ParallelPlan, n: int) -> bool:
    """Whether ``tp`` over ``n`` model ranks reads ``wk``/``wv`` whole:
    the K/V heads do not divide the ranks, so their column blocks would
    cut a head, which RoPE rotates whole (``parallel.partition
    .read_specs``)."""
    return plan.mode == "tp" and n > 1 and cfg.n_kv_heads % n != 0


def fit_sharder(sharder: Sharder, cfg: LMConfig, seq: Optional[int] = None,
                 batch: Optional[int] = None) -> Sharder:
    """The sharder as ``cfg`` runs on it.  Under DSP on a mesh with no
    schedule given (and ``seq``, ``batch`` global): the planned schedule
    attached, so that the plan, not the model, decides the stage
    layouts, priced in bytes.  Under ``tp`` on a mesh: ``check_tp``, and
    ``kv_whole`` set."""
    if sharder.ctx is None:
        return sharder
    if sharder.plan.mode == "tp":
        check_tp(cfg, sharder.sp_size)
        return dataclasses.replace(
            sharder, kv_whole=kv_whole(cfg, sharder.plan, sharder.sp_size))
    if (sharder.plan.mode != "dsp" or sharder.schedule is not None
            or seq is None):
        return sharder
    return sharder.with_schedule(
        dsp_schedule(cfg, sharder.sp_size, seq=seq, batch=batch))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_norm_kind(cfg: LMConfig, d: int, device):
    return L.init_norm(d, bias=(cfg.norm_kind == "layer"), dtype=cfg.dtype,
                       device=device)


def _apply_norm(cfg: LMConfig, p, x):
    if cfg.norm_kind == "layer":
        return L.layer_norm(p, x)
    return L.rms_norm(p, x)


def _init_layer(gen: torch.Generator, cfg: LMConfig, spec: LayerSpec):
    dev = gen.device
    p: Dict[str, Any] = {"ln1": _init_norm_kind(cfg, cfg.d_model, dev)}
    if spec.mixer == "attn":
        p["attn"] = A.init_attention(gen, cfg.attn_cfg(spec.window),
                                     dtype=cfg.dtype)
    else:
        p["ssm"] = S.init_ssm(gen, cfg.ssm_cfg, dtype=cfg.dtype)
    if cfg.post_norm:
        p["pn1"] = _init_norm_kind(cfg, cfg.d_model, dev)
    if spec.ffn != "none":
        p["ln2"] = _init_norm_kind(cfg, cfg.d_model, dev)
        if spec.ffn == "moe":
            p["moe"] = M.init_moe(
                gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                n_shared=cfg.n_shared, shared_ff=cfg.shared_ff,
                dense_ff=cfg.dense_ff, kind=cfg.mlp_kind,
                pad_experts_to=cfg.ep_pad, dtype=cfg.dtype)
        else:
            ff = cfg.d_ff if not cfg.n_experts else (cfg.dense_ff or cfg.d_ff)
            p["mlp"] = L.init_mlp(gen, cfg.d_model, ff, kind=cfg.mlp_kind,
                                  dtype=cfg.dtype)
        if cfg.post_norm:
            p["pn2"] = _init_norm_kind(cfg, cfg.d_model, dev)
    return p


def init_lm(seed: int, cfg: LMConfig, *, device="cuda"):
    """Returns the parameter tree, drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device``.  Per-period layer params live under
    ``periods`` with a stacked leading dim of n_periods; each period is
    drawn and copied in turn, so the peak is the model plus one period
    and one leaf's float32 draw.  One period is its own stack (a view of
    the draw, no copy): the peak is then the model and one leaf's draw,
    which lets a model whose one period is most of a card (jamba's) be
    drawn on it.  A config with a frontend
    (pixtral-12b's stub) draws its patch projection last, under
    ``frontend``, JAX's place in the tree."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = cfg.period_specs()
    params: Dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                  dtype=cfg.dtype)}
    n = cfg.n_periods
    periods = None
    for i in range(n):
        one = {str(j): _init_layer(gen, cfg, spec)
               for j, spec in enumerate(specs)}
        if n == 1:
            periods = tree_map(lambda a: a.unsqueeze(0), one)
            break
        if periods is None:
            periods = tree_map(
                lambda a: a.new_empty((n,) + tuple(a.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), periods, one)
        del one                  # before the next period's draw
    params["periods"] = periods
    params["final_norm"] = _init_norm_kind(cfg, cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                             dtype=cfg.dtype)
    if cfg.frontend_dim:
        params["frontend"] = L.init_patch_embed(gen, cfg.frontend_dim,
                                                cfg.d_model, dtype=cfg.dtype)
    return params


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------

def param_counts(cfg: LMConfig) -> Dict[str, int]:
    """Returns total and active (per-token) parameter counts."""
    d, dh = cfg.d_model, cfg.head_dim
    total = active = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    for spec in cfg.period_specs() * cfg.n_periods:
        if spec.mixer == "attn":
            n = d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            total += n; active += n
        else:
            sc = cfg.ssm_cfg
            n_in = d * (2 * sc.d_inner + 2 * sc.n_groups * sc.d_state +
                        sc.n_heads)
            n = n_in + sc.d_inner * d + sc.d_conv * (
                sc.d_inner + 2 * sc.n_groups * sc.d_state)
            total += n; active += n
        if spec.ffn == "mlp":
            ff = cfg.d_ff if not cfg.n_experts else (cfg.dense_ff or cfg.d_ff)
            n = L.mlp_param_count(d, ff, cfg.mlp_kind)
            total += n; active += n
        elif spec.ffn == "moe":
            per = L.mlp_param_count(d, cfg.d_ff, cfg.mlp_kind)
            total += cfg.n_experts * per
            active += cfg.top_k * per
            if cfg.n_shared:
                n = L.mlp_param_count(d, cfg.shared_ff or cfg.n_shared * cfg.d_ff,
                                      cfg.mlp_kind)
                total += n; active += n
            if cfg.dense_ff:
                n = L.mlp_param_count(d, cfg.dense_ff, cfg.mlp_kind)
                total += n; active += n
    return {"total": total, "active": active}


# ---------------------------------------------------------------------------
# Training: forward and loss
# ---------------------------------------------------------------------------

def moe_meta(cfg: LMConfig) -> M.MoEArgs:
    return M.MoEArgs(n_experts=cfg.n_experts, top_k=cfg.top_k,
                     e_phys=cfg.ep_pad or cfg.n_experts, kind=cfg.mlp_kind,
                     has_shared=cfg.n_shared > 0,
                     has_dense=cfg.dense_ff is not None)


def n_moe_layers(cfg: LMConfig) -> int:
    return sum(sp.ffn == "moe" for sp in cfg.period_specs()) * cfg.n_periods


def _apply_layer(p, x, cfg: LMConfig, spec: LayerSpec, sharder: Sharder,
                 backend: str, fused_switch: bool, place=None):
    h = _apply_norm(cfg, p["ln1"], x)
    if spec.mixer == "attn":
        h = A.attention_sp(p["attn"], h, cfg.attn_cfg(spec.window),
                           sharder=sharder, backend=backend,
                           fused_switch=fused_switch, causal=True)
    else:
        # ssm_block switches back itself: the mixer exit is a keep here
        h = sharder.mixer_exit3(
            S.ssm_block(p["ssm"], h, cfg.ssm_cfg, backend=backend,
                        sharder=sharder), src="resid")
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn1"], h)
    x, aux = _ffn_block(p, x + h, cfg, spec, sharder, place)
    # layer exit: a resid-stage boundary either way (after the FFN, or
    # after the mixer's switch back in an ffn-less layer)
    return sharder.act3(x), aux


def sharded_embed(params, tokens, cfg: LMConfig, sharder: Sharder):
    """The embedding of the rank's tokens, in their layout (the sequence
    shard on a mesh), with JAX's vocab-parallel table RING under
    ``shard_vocab``: the table is split over ``model`` by vocab row and
    the tokens are split over the same ranks by sequence, so each rank
    adds, for each table chunk it holds in turn, the lookup of its tokens
    that fall in that chunk's rows (the rest masked), while the chunks go
    round the ``model`` group (``core.overlap.ring_stream``: n permutes of
    the rank's chunk, whose backward carries each chunk's gradient home).
    Communication is the table's bytes, whatever the sequence length, and
    no reduction.  Falls back, as JAX does, to a lookup in the table
    gathered whole (``Sharder.whole``) without a mesh, at one model rank,
    when the ranks do not divide the vocab, or with ``shard_vocab``
    off."""
    n = sharder.sp_size
    if not vocab_sharded(cfg, sharder):
        return L.embed(sharder.whole(params["embed"], "embed"), tokens,
                       scale_by_sqrt_dim=cfg.embed_scale)
    table = params["embed"]["table"]
    chunk, d = table.shape
    if chunk * n != cfg.vocab:
        raise ValueError(f"the ring needs the table split over 'model' "
                         f"(param_pspecs under shard_vocab): this rank "
                         f"holds {chunk} of {cfg.vocab} rows at {n} ranks")

    def fold(_, src, blocks, acc):
        # ``src`` owns the held chunk: look up the tokens in its rows
        rel = tokens - src * chunk
        ok = (rel >= 0) & (rel < chunk)
        e = blocks[0][rel.clamp(0, chunk - 1)]
        return acc + torch.where(ok[..., None], e, 0)

    x = ring_stream((table,), table.new_zeros(tokens.shape + (d,)), fold,
                    sharder.ctx.sp_group)
    if cfg.embed_scale:
        x = x * math.sqrt(d)
    return x.to(table.dtype)


def with_patches(params, x, cfg: LMConfig, sharder: Sharder, extra,
                 length: Optional[int] = None):
    """The VLM stub frontend (JAX's ``forward``/``forward_prefill(extra=)``):
    ``extra["patch_embeds"]`` (B, frontend_tokens, frontend_dim) through
    ``params["frontend"]`` (computed in float32, as JAX's promotion of
    its float32 patches against the weights does, then cast to x's
    dtype) replace the first ``frontend_tokens`` positions of the
    embedding x (B, S, d); x itself without a frontend or patches.  On a
    mesh x is the rank's sequence chunk and ``patch_embeds`` the rank's
    batch slice whole (``shard_lm_batch``): the rank writes the patch
    rows that fall in its chunk, none or part of it or all of it.  Every
    rank reads the frontend (under ZeRO-3 a gather where it is read) and
    feeds it into its output, even with no rows, so the gradient's
    reduce-scatter runs on every rank.  A prompt (of true ``length``)
    shorter than ``frontend_tokens`` raises: JAX's concatenation would
    lengthen the sequence to ``frontend_tokens`` there."""
    if not (cfg.frontend_dim and extra and "patch_embeds" in extra):
        return x
    pe, ft = extra["patch_embeds"], cfg.frontend_tokens
    s = x.shape[1]
    length = s * sharder.seq_shards if length is None else length
    if pe.shape[1] != ft or length < ft:
        raise ValueError(
            f"{pe.shape[1]} patch rows for a {length}-token sequence: the "
            f"frontend replaces exactly the first {ft} positions of a "
            f"sequence at least that long")
    front = sharder.whole(params["frontend"], "frontend")["proj"]
    off = sharder.seq_offset(s)
    hi = max(off, min(off + s, ft))
    rows = L.linear({"w": front["w"].float(), "b": front["b"].float()},
                    pe[:, off:hi].float()).to(x.dtype)
    return torch.cat([rows, x[:, hi - off:]], dim=1)


def forward(params, tokens, cfg: LMConfig, *, sharder: Optional[Sharder] = None,
            backend: str = "kernel", remat: bool = True,
            fused_switch: bool = True, extra=None):
    """tokens: (B, S) -> (final hidden states (B, S, C), aux), aux JAX's
    {"moe_load_balance": the MoE layers' load-balance stats summed} and
    {"moe_dropped": the mean over MoE layers of the share of (token, k)
    pairs dropped past the capacity} (both 0 without MoE layers; on a
    mesh the rank's shares, ``models.moe``).  With ``sharder`` on
    a mesh both are the rank's shard (``shard_lm_batch``): its batch slice
    and sequence chunk, and ``params`` are laid out as the sharder's
    ``param_specs`` say (``parallel.partition.shard_params``).  Each
    period's split leaves are gathered at the top of its body, inside the
    checkpoint, so that no gathered weight lives from the forward to the
    backward: the recompute gathers them again.  ``remat`` checkpoints
    each period and recomputes it in the backward (JAX's
    ``remat_policy="full"``), its collectives included, so the backward
    runs every period's forward once more.  ``fused_switch`` is
    ``attention_sp``'s.  The aux sums run through each period's checkpoint
    beside x, so the recompute's routing is the forward's.  ``extra``'s
    ``patch_embeds`` replace the first ``frontend_tokens`` positions
    (``with_patches``)."""
    sharder = sharder or null_sharder()
    sharder = fit_sharder(
        sharder, cfg, seq=tokens.shape[1] * sharder.seq_shards,
        batch=tokens.shape[0] * sharder.dp_size)
    specs = cfg.period_specs()
    n_moe = n_moe_layers(cfg)
    place = sharder.moe_experts() if n_moe else None
    x = sharder.enter3(with_patches(
        params, sharded_embed(params, tokens, cfg, sharder), cfg, sharder,
        extra))

    def period_body(x, pp):
        pp = sharder.whole(pp, "periods")
        x = sharder.wrap3(x)
        lb = dropped = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, spec in enumerate(specs):
            x, aux = _apply_layer(pp[str(j)], x, cfg, spec, sharder, backend,
                                  fused_switch, place)
            if aux is not None:
                lb, dropped = lb + aux[0], dropped + aux[1]
        return x, lb, dropped

    lb = dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    for pp in unstack(params["periods"], cfg.n_periods):
        if remat:
            # no early stop: the recompute reissues every collective of the
            # period, the last one too, on every rank alike
            with set_checkpoint_early_stop(False):
                x, a, d = checkpoint(period_body, x, pp, use_reentrant=False)
        else:
            x, a, d = period_body(x, pp)
        lb, dropped = lb + a, dropped + d
    x = _apply_norm(cfg, sharder.whole(params["final_norm"], "final_norm"),
                    x)
    return x, {"moe_load_balance": lb,
               "moe_dropped": dropped / max(n_moe, 1)}


def chunked_xent(x, table, labels, cfg: LMConfig, *, chunk: int = 512,
                 sharder: Optional[Sharder] = None):
    """Mean cross-entropy without materialising (B, S, V): a loop over S
    chunks, each checkpointed so its logits are recomputed in the
    backward.  Logits are a matmul in the model dtype, upcast to f32.  On
    a mesh x and labels are the rank's shard: it sums its own tokens and
    divides by the GLOBAL token count, so the sum over ranks is the mean."""
    b, s, _ = x.shape
    n_tok = b * s
    if sharder is not None:
        x, labels = sharder.xent_chunks(x), sharder.xent_chunks(labels)
        n_tok *= sharder.dp_size * sharder.seq_shards
    chunk = min(chunk, max(s, 1))
    while s % chunk:
        chunk //= 2

    def one(xc, lc):
        logits = (xc @ table.t()).float()
        logits = L.softcap_logits(logits, cfg.final_softcap)
        lz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return torch.sum(lz - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        total = total + checkpoint(one, x[:, i:i + chunk],
                                   labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / n_tok


def lm_loss(params, batch, cfg: LMConfig, *, sharder: Optional[Sharder] = None,
            backend: str = "kernel", remat: bool = True,
            fused_switch: bool = True, aux_weight: float = 0.01):
    """batch {"tokens", "labels"}: (B, S) -> (loss, {"xent": loss}).  With
    MoE layers the loss is JAX's: the cross-entropy plus ``aux_weight``
    times the load-balance aux over the layer count, and the metrics add
    ``forward``'s aux.  With ``sharder`` on a mesh the batch is the rank's
    shard and the loss its share of the global mean: summed over the
    world (the trainer's all-reduce) it is the mean.  The unembedding
    table (the embedding's when tied) is gathered whole once, outside the
    loss's per-chunk checkpoints.  The batch's ``extra`` (a VLM batch's
    ``patch_embeds``) goes to ``forward``."""
    x, aux = forward(params, batch["tokens"], cfg, sharder=sharder,
                     backend=backend, remat=remat, fused_switch=fused_switch,
                     extra=batch.get("extra"))
    key = "embed" if cfg.tie_embeddings else "unembed"
    # gathered once, outside the chunks' checkpoints
    table = (sharder or null_sharder()).whole(params[key], key)["table"]
    loss = chunked_xent(x, table, batch["labels"], cfg, sharder=sharder)
    if not n_moe_layers(cfg):
        return loss, {"xent": loss}
    total = loss + aux_weight * aux["moe_load_balance"] / max(cfg.n_layers, 1)
    return total, {"xent": loss, **aux}


def shard_lm_batch(batch: Dict[str, torch.Tensor], sharder: Sharder):
    """The rank's shard of a global (B, S) batch, as every rank of the
    mesh draws the same one: its slice of the batch over the data dims,
    then its sequence chunk over ``model`` (``dsp.dsp_shard_batch``, the
    paper's dataloader split); the batch itself without a mesh.  An
    enc-dec batch splits the same way, each tensor on its own sequence:
    ``feats`` (B, S_enc, F) on S_enc, ``tokens`` and ``labels`` on
    S_dec.  A VLM batch's ``extra`` (``patch_embeds``) is split by batch
    alone: the rank cuts the patch rows of its chunk (``with_patches``)."""
    ctx = sharder.ctx
    if ctx is None:
        return batch
    local = {k: dsp.shard(v, 0, ctx.dp_size, ctx.dp_index)
             for k, v in batch.items() if k != "extra"}
    out = dsp.dsp_shard_batch(local, 1, ctx.sp_group)
    if "extra" in batch:
        out["extra"] = {k: dsp.shard(v, 0, ctx.dp_size, ctx.dp_index)
                        for k, v in batch["extra"].items()}
    return out


def collective_contract(cfg: LMConfig, n: int, batch: int, seq: int, *,
                        fused_switch: bool = True, dp: int = 1,
                        ep: bool = False, moe_rows=None, tp: bool = False
                        ) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls one forward issues per rank of a
    mesh with ``n`` ranks on ``model``, by kind, and their bytes
    (``core.dsp.volume``'s rule), for a local batch of ``batch`` x ``seq``
    tokens (the rank's shard), under DSP's planned layouts (resid on the
    sequence, mixer on heads/channels: what ``make_sharder`` runs):

      attention, head switch, h == hkv (after the K/V repeat): 1
        all-to-all in (stacked q/k/v) and 1 out;
      attention, head switch, GQA, fused: 2 in (q, stacked k/v) and 1 out;
      attention, head switch, unfused: 3 in and 1 out;
      attention, kv_gather (heads do not divide n): 1 all-gather;
      SSM: 1 permute (the conv's halo; none at n = 1), 2 all-gathers (B,
        C), 2 all-to-alls in (x, dt) and 1 out;
      MoE, on a mesh of ``dp`` x ``n``: 1 all-reduce over the world of the
        (dp, n, batch, E) int64 expert counts (the count exchange); under
        ``ep`` 2 all-to-alls (the dispatch and the combine, each counted
        by its result), whose bytes are the routed rows':
        ``moe_rows`` = (rows this rank receives, rows it gets back) over
        the forward's MoE layers, which follow from the routing: the kept
        pairs of its data slice's rows on its experts, and its own
        tokens' kept pairs;
      embedding, norms, MLP and the loss: none.

    Under ``tp`` (Megatron-SP, ``Sharder.tp_enter``/``tp_exit``) each
    attention and each MLP block instead issues 1 all-gather of the
    whole (batch, n·seq, d) sequence in and 1 reduce-scatter of the same
    out, and each MoE layer, beside its count exchange (``moe_block``),
    1 more such pair: without ``ep`` around the whole layer (every
    expert's and the shared and dense MLPs' partials summed in one), with
    ``ep`` around its shared and dense MLPs (none if it has neither),
    the experts' 2 all-to-alls as under DSP; ``wk``/``wv`` read whole
    under ``kv_whole`` count in ``param_contract``.

    A training step with ``remat`` issues ``remat_step`` of it, and the
    trainer adds one all-reduce."""
    calls: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    s = seq * n                                   # the whole sequence
    a_bytes = cfg.dtype.itemsize

    def add(kind, elems, width=a_bytes, times=1):
        calls[kind] = calls.get(kind, 0) + times
        nbytes[kind] = nbytes.get(kind, 0) + elems * width * times

    n_moe = n_moe_layers(cfg)
    if n_moe:
        meta = moe_meta(cfg)
        add("all-reduce", 2 * dp * n * batch * meta.e_phys, 8, n_moe)
        if ep:
            if moe_rows is None:
                raise ValueError("the dispatch's bytes follow the routing: "
                                 "pass moe_rows")
            add("all-to-all", sum(moe_rows) * cfg.d_model)
            calls["all-to-all"] += 2 * n_moe - 1
    if tp:
        check_tp(cfg, n)
        blocks = sum(1 + (sp.ffn == "mlp") for sp in cfg.period_specs())
        if n_moe and (not ep or meta.has_shared or meta.has_dense):
            blocks = blocks * cfg.n_periods + n_moe
        else:
            blocks = blocks * cfg.n_periods
        add("all-gather", batch * s * cfg.d_model, times=blocks)
        add("reduce-scatter", batch * s * cfg.d_model, times=blocks)
        return {"calls": calls, "bytes": nbytes}

    for layer in range(cfg.n_layers):
        spec = cfg.period_specs()[layer % len(cfg.period_specs())]
        if spec.mixer == "attn":
            h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            if h % n:                             # kv_gather
                add("all-gather", 2 * batch * hkv * s * dh)
                continue
            if hkv < n:
                hkv *= (n + hkv - 1) // hkv
            per_head = batch * s * dh // n         # one head's shard
            if fused_switch and h == hkv:
                add("all-to-all", 3 * h * per_head)
            elif fused_switch:
                add("all-to-all", h * per_head)
                add("all-to-all", 2 * hkv * per_head)
            else:
                add("all-to-all", h * per_head)
                add("all-to-all", hkv * per_head)
                add("all-to-all", hkv * per_head)
            add("all-to-all", h * per_head)
        else:
            sc = cfg.ssm_cfg
            d_xbc = sc.d_inner + 2 * sc.n_groups * sc.d_state
            if n > 1:
                add("collective-permute", batch * (sc.d_conv - 1) * d_xbc)
            add("all-to-all", batch * s * sc.d_inner // n)
            add("all-gather", batch * s * sc.n_groups * sc.d_state)
            add("all-gather", batch * s * sc.n_groups * sc.d_state)
            add("all-to-all", batch * s * sc.n_heads // n, width=4)
            add("all-to-all", batch * s * sc.d_inner // n)
    return {"calls": calls, "bytes": nbytes}


def remat_step(contract: Dict[str, Dict[str, int]]
               ) -> Dict[str, Dict[str, int]]:
    """One forward's ``collective_contract`` -> the calls and bytes of a
    training step's loss and grads with ``remat``: the forward's twice
    (forward, recompute) and each one's transpose once, a switch's and a
    permute's one more of their kind, a gather's a reduce-scatter of the
    same bytes and a reduce-scatter's a gather; an all-reduce (MoE's count
    exchange, which carries no gradient) has no transpose.  The trainer's
    all-reduce is not in it."""
    out = {}
    for part, fwd in contract.items():
        pair = ("all-gather", "reduce-scatter")
        step = {k: 3 * v for k, v in fwd.items()
                if k not in pair + ("all-reduce",)}
        if any(k in fwd for k in pair):
            ag, rs = (fwd.get(k, 0) for k in pair)
            step["all-gather"] = 2 * ag + rs
            step["reduce-scatter"] = ag + 2 * rs
        if "all-reduce" in fwd:
            step["all-reduce"] = 2 * fwd["all-reduce"]
        out[part] = step
    return out


def param_contract(cfg: LMConfig, params, plan: ParallelPlan,
                   sizes: Dict[str, int], *, patches: bool = False
                   ) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls and bytes, by kind (``core.dsp``'s
    rule), that the parameter layouts of ``plan`` add per rank to one
    training step with ``remat`` on a mesh of ``sizes`` (``mesh_sizes``),
    beside ``remat_step`` of ``collective_contract``.  Derived from
    ``param_pspecs`` of ``params``, the GLOBAL tree (meta tensors will
    do), each read as ``forward`` and ``lm_loss`` read it
    (``parallel.partition.store_contract``, which adds the trainer's
    all-reduces):

      each period leaf a spec splits: per period, 2 all-gathers of the
        whole leaf (the forward's and the recompute's) and 1 reduce-scatter
        of its float32 gradient;
      the embedding table on the ring (``sharded_embed``): n permutes of
        the rank's chunk forward and n - 1 backward (the last hop's chunk
        is read by nobody);
      any other leaf a spec splits, at each read outside the checkpoints
        (the table off the ring; the tied table, the unembedding table and
        the final norm in the loss): 1 all-gather and 1 reduce-scatter;
      under ``ep`` an expert leaf only over its entries other than
        ``model``, under ``tp`` a column or row leaf only over ``data``,
        ``wk``/``wv`` over ``model`` too under ``kv_whole``
        (``read_specs``);
      the VLM frontend, where a spec splits it: 1 all-gather and 1
        reduce-scatter when the step's batch has ``patches``, none when
        it is text alone (``with_patches`` does not read it).

    An entry naming only dims of size 1 is still issued (at one rank each
    is a copy)."""
    n = sizes.get("model", 1)
    ring = n > 1 and cfg.vocab % n == 0 and plan.shard_vocab
    reads = {("embed", "table"): (0 if ring else 1) + cfg.tie_embeddings,
             ("unembed", "table"): 1, ("final_norm", "scale"): 1,
             ("final_norm", "bias"): 1,
             ("frontend", "proj", "w"): int(patches),
             ("frontend", "proj", "b"): int(patches)}

    def times(path):
        if path[0] == "periods":
            return 2, 1
        return reads[path], reads[path]

    specs = param_pspecs(params, plan, axis_sizes=sizes)
    out = store_contract(params, specs, sizes, times,
                         read_specs=read_specs(
                             specs, plan, kv_whole=kv_whole(cfg, plan, n)))
    if ring:
        chunk = params["embed"]["table"]
        size, k = chunk.numel() // n * chunk.element_size(), 2 * n - 1
        out["calls"]["collective-permute"] = k
        out["bytes"]["collective-permute"] = size * k
    return out


# ---------------------------------------------------------------------------
# Serving: prefill + incremental decode
# ---------------------------------------------------------------------------

def init_caches(cfg: LMConfig, batch: int, max_len: int, *, dtype=None,
                per_slot_pos: bool = False, device="cuda", ctx=None,
                plan: Optional[ParallelPlan] = None):
    """Zero caches, stacked per period.  Attention layers carry {k, v} of
    (n_periods, B, Hkv, max_len, Dh); SSM layers carry {conv, state} of
    (n_periods, B, d_conv - 1, d_xbc) in the model dtype and (n_periods,
    B, H, P, S) in float32.  ``pos`` is the write position: one shared
    scalar for a static batch, or a (B,) vector with ``per_slot_pos``
    (continuous batching).  With ``ctx`` (a mesh's ``ParallelContext``)
    each leaf is this rank's slice of those global shapes by
    ``cache_pspecs`` under ``plan``: the KV sequence in blocks over
    ``model``, the state by head, the batch over ``data``."""
    dev = resolve_device(device)
    kv_dtype = dtype or cfg.cache_dtype or cfg.dtype
    ssm_dtype = dtype or cfg.dtype
    specs = cfg.period_specs()
    shape = (cfg.n_periods, batch, cfg.n_kv_heads, max_len, cfg.head_dim)

    def one_layer(spec: LayerSpec):
        if spec.mixer == "attn":
            return {"kv": {
                "k": torch.zeros(shape, dtype=kv_dtype, device="meta"),
                "v": torch.zeros(shape, dtype=kv_dtype, device="meta")}}
        one = S.init_ssm_cache(batch, cfg.ssm_cfg, dtype=ssm_dtype,
                               device="meta")
        return {"ssm": tree_map(
            lambda a: a.new_zeros((cfg.n_periods,) + tuple(a.shape)), one)}

    pos = torch.zeros((batch,) if per_slot_pos else (), dtype=torch.long,
                      device=dev)
    periods = {str(i): one_layer(s) for i, s in enumerate(specs)}
    cspecs = cache_pspecs(periods, plan if ctx is not None
                          else ParallelPlan(mode="none"))

    def alloc(_, a, spec):
        local = [hi - lo for lo, hi in slice_index(a.shape, spec, ctx)]
        return torch.zeros(local, dtype=a.dtype, device=dev)
    return {"pos": pos,
            "periods": tree_map_with_path(alloc, periods, cspecs)}


def init_paged_caches(cfg: LMConfig, max_batch: int, max_len: int,
                      block_size: int, n_blocks: int, *, device="cuda",
                      ctx=None, plan: Optional[ParallelPlan] = None):
    """The block pool's caches (JAX's ``BlockPool._init_caches``): per
    attention layer {k, v} of (n_periods, n_blocks, Hkv, block_size, Dh)
    in zeros (a masked column still multiplies v, and 0 x NaN is NaN),
    ``table`` (max_batch, max_len // block_size) of block ids, every entry
    the garbage block 0, and ``pos`` (max_batch,).  With ``ctx`` each KV
    leaf is this rank's within-block slice by ``cache_pspecs(paged=True)``
    under ``plan``; ``table`` and ``pos`` are whole."""
    if any(sp.mixer != "attn" for sp in cfg.period_specs()):
        raise ValueError(
            "the block pool pages KV caches only; SSM state is O(1) per "
            "request (nothing to page): serve hybrid and SSM models "
            "through the slot-based KVPool")
    dev = resolve_device(device)
    shape = (cfg.n_periods, n_blocks, cfg.n_kv_heads, block_size,
             cfg.head_dim)
    kv_dtype = cfg.cache_dtype or cfg.dtype
    periods = {str(i): {"kv": {
        "k": torch.zeros(shape, dtype=kv_dtype, device="meta"),
        "v": torch.zeros(shape, dtype=kv_dtype, device="meta")}}
        for i, _ in enumerate(cfg.period_specs())}
    cspecs = cache_pspecs(periods, plan if ctx is not None
                          else ParallelPlan(mode="none"), paged=True)

    def alloc(_, a, spec):
        local = [hi - lo for lo, hi in slice_index(a.shape, spec, ctx)]
        return torch.zeros(local, dtype=a.dtype, device=dev)
    return {"pos": torch.zeros((max_batch,), dtype=torch.long, device=dev),
            "table": torch.zeros((max_batch, max_len // block_size),
                                 dtype=torch.long, device=dev),
            "periods": tree_map_with_path(alloc, periods, cspecs)}


def vocab_sharded(cfg: LMConfig, sharder: Optional[Sharder]) -> bool:
    """Whether the embedding table is split by vocab row over ``model``
    and read there (the ring's condition, ``sharded_embed``): then the
    serving logits come out vocab-sharded and the decode embedding is a
    masked lookup plus one all-reduce."""
    return (sharder is not None and sharder.ctx is not None
            and sharder.sp_size > 1 and cfg.vocab % sharder.sp_size == 0
            and sharder.plan.shard_vocab)


def decode_embed(params, tokens, cfg: LMConfig, sharder: Sharder):
    """The embedding of tokens whole on every model rank (a decode step):
    under ``vocab_sharded`` each rank looks up the tokens its vocab chunk
    holds, zeros for the rest, and one SUM all-reduce over ``model`` gives
    every rank the rows bit for bit (one rank adds each row, the others
    0): (B, S, d) bytes where JAX's ``sharded_embed`` rings the whole
    table.  Else ``sharded_embed``'s lookup in the table gathered
    whole."""
    if not vocab_sharded(cfg, sharder):
        return sharded_embed(params, tokens, cfg, sharder)
    table = params["embed"]["table"]
    chunk = table.shape[0]
    rel = tokens - sharder.sp_index * chunk
    ok = (rel >= 0) & (rel < chunk)
    x = torch.where(ok[..., None], table[rel.clamp(0, chunk - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    dsp.all_reduce(x, sharder.ctx.sp_group)
    if cfg.embed_scale:
        x = x * math.sqrt(table.shape[1])
    return x


def logits_fn(params, x, cfg: LMConfig, sharder: Optional[Sharder] = None):
    """x (B, S, d) whole on every rank -> logits (B, S, V); under
    ``vocab_sharded`` this rank's vocab chunk (B, S, V / n), against its
    own rows of the (unembedding) table, else against the table gathered
    whole (``Sharder.whole``)."""
    key = "embed" if cfg.tie_embeddings else "unembed"
    if vocab_sharded(cfg, sharder):
        table = params[key]["table"]
    else:
        table = (sharder or null_sharder()).whole(params[key], key)["table"]
    return L.softcap_logits(x @ table.t(), cfg.final_softcap)


def sharded_argmax(logits, cfg: LMConfig,
                   sharder: Optional[Sharder] = None) -> torch.Tensor:
    """argmax over the last dim of (..., V) logits, in global vocab ids,
    ties to the lowest id (``jnp.argmax``'s rule).  Vocab-sharded logits
    (``vocab_sharded``): each rank's max and its first index, shifted to
    a global id, one all-gather over ``model`` of the stacked pairs (in
    float64, exact for both), and the first rank holding the largest max
    wins (the ranks hold the vocab in order)."""
    if not vocab_sharded(cfg, sharder):
        return torch.argmax(logits, dim=-1)
    val, idx = logits.float().max(dim=-1)
    # max(dim) returns the first index of the maximum, as argmax does
    pair = torch.stack([val.double(), (idx + sharder.sp_index
                                       * logits.shape[-1]).double()], -1)
    pairs = dsp.gather(pair[None], 0, sharder.ctx.sp_group)
    win = torch.argmax(pairs[..., 0], dim=0)
    return torch.gather(pairs[..., 1], 0, win[None])[0].long()


def tp_partial(p, x, kind: str):
    """An MLP's partial output under ``tp`` on x whole (the gathered
    sequence, or a decode step's tokens): the rank's F/n columns of
    ``wi``/``wg`` (``attention.tp_columns``), the activation, its rows of
    ``wo``, without ``wo``'s bias, which the caller adds once after the
    sum over ``model``."""
    return L.mlp({**{k: p[k] for k in ("wi", "wg") if k in p},
                  "wo": {"w": p["wo"]["w"]}}, x, kind)


def tp_mlp(p, x, kind: str, sharder: Sharder, *, step: bool):
    """The MLP under ``tp``: x the rank's sequence shard, gathered whole
    (``Sharder.tp_enter``), or a decode ``step``'s tokens, whole on every
    rank; ``tp_partial`` on it, summed over ``model``
    (``attention.tp_rows``: a reduce-scatter back onto the shard, or a
    step's all-reduce), and ``wo``'s bias."""
    cols = {k: A.tp_columns(p[k], sharder) for k in ("wi", "wg") if k in p}
    h = tp_partial({**cols, "wo": p["wo"]}, x if step
                   else sharder.tp_enter(x), kind)
    y = sharder.tp_sum(h) if step else sharder.tp_exit(h)
    return y + p["wo"]["b"] if "b" in p["wo"] else y


def moe_block(p, x, cfg: LMConfig, sharder: Sharder, place, *,
              step: bool = False, length: Optional[int] = None):
    """The MoE layer on x -> (y, aux) (``models.moe.moe``), placed by
    ``place`` (``Sharder.moe_experts``; None on one device):

      under DSP, the rank's sequence shard, the count exchange and, under
        ``ep``, the dispatch's exchanges; a serving ``step`` routes its
        tokens, whole on every rank, on each rank, and under ``ep`` each
        rank runs its block of experts and one SUM all-reduce over
        ``model`` adds the blocks, the shared and dense MLPs added once
        after it;
      under ``tp`` with ``ep``, the experts as under DSP on the shard, the
        shared and dense MLPs as ``tp_mlp`` runs (column and row blocks
        between their own gather and reduce-scatter);
      under ``tp`` without ``ep`` (or a ``tp`` step), the tokens whole
        (``tp_enter``'s sequence, or the step's), the rank's hidden
        columns of every expert (or under ``ep`` its block) and of the
        shared and dense MLPs, all partials, summed by one ``tp_exit``
        (a step's ``tp_sum``).

    The MoE MLPs carry no bias (``init_moe``).  ``length`` is the
    prefill's true length (``moe_gather``)."""
    meta = moe_meta(cfg)
    kw = dict(norm_topk=cfg.norm_topk, expert_hook=place, length=length)
    if place is None:
        return M.moe(p, x, meta, **kw)
    if sharder.tp:
        if place.whole:
            xw = x if step else sharder.tp_enter(x)
            y, aux = M.moe(p, xw, meta, shared=False, **kw)
            y = y + M.shared_and_dense(p, xw, meta, mlp=tp_partial)
            return (sharder.tp_sum(y) if step else sharder.tp_exit(y)), aux
        y, aux = M.moe(p, x, meta, shared=False, **kw)
        if "shared" in p or "dense" in p:
            y = y + sharder.tp_exit(M.shared_and_dense(
                p, sharder.tp_enter(x), meta, mlp=tp_partial))
        return y, aux
    if place.whole and place.ep:
        y, aux = M.moe(p, x, meta, shared=False, **kw)
        dsp.all_reduce(y, place.group)
        return y + M.shared_and_dense(p, x, meta), aux
    return M.moe(p, x, meta, **kw)


def _ffn_block(p, x, cfg: LMConfig, spec: LayerSpec,
               sharder: Optional[Sharder] = None, place=None, *,
               step: bool = False, length: Optional[int] = None):
    """The layer's FFN half -> (x, aux): aux the MoE layer's
    (load_balance, dropped), None for an MLP.  ``place``
    (``Sharder.moe_experts``) puts the MoE on a mesh (``moe_block``).
    ``step``: x is a decode step's, whole on every rank (``tp_mlp``).
    ``length``: a padded prefill's true length."""
    if spec.ffn == "none":
        return x, None
    h = _apply_norm(cfg, p["ln2"], x)
    aux = None
    if spec.ffn == "moe":
        h, a = moe_block(p["moe"], h, cfg, sharder or null_sharder(), place,
                         step=step, length=length)
        aux = (a["load_balance"], a["dropped"])
    elif sharder is not None and sharder.tp:
        h = tp_mlp(p["mlp"], h, cfg.mlp_kind, sharder, step=step)
    else:
        h = L.mlp(p["mlp"], h, cfg.mlp_kind)
    if sharder is not None:
        h = sharder.act3(h)
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn2"], h)
    return x + h, aux


def _decode_layer(p, x, pc, cfg: LMConfig, spec: LayerSpec, pos,
                  sharder: Optional[Sharder] = None, place=None, table=None,
                  start: Optional[int] = None):
    """One layer of incremental decode; x: (B, S, C), whole on every rank
    of a mesh.  S is 1 for a decode step, or a prefill chunk's length
    (the paged scheduler feeds prompt slices through this same layer).
    ``place`` is the step's MoE placement (``Sharder.moe_experts(step=
    True)``).  ``table`` (B, blocks_per_slot) switches attention to the
    block pool's layout, ``start`` (a host int) is a chunk's first
    position.  Writes the layer's cache ``pc`` in place and returns (x,
    pc)."""
    h = _apply_norm(cfg, p["ln1"], x)
    if spec.mixer == "attn":
        cache = {"k": pc["kv"]["k"], "v": pc["kv"]["v"], "pos": pos}
        if table is not None:
            cache.update(table=table, start=start)
        h, _ = A.attention(p["attn"], h, cfg.attn_cfg(spec.window),
                           causal=True, cache=cache, sharder=sharder)
    else:
        h, new = S.ssm_decode_step(p["ssm"], h, cfg.ssm_cfg, pc["ssm"],
                                   sharder=sharder)
        tree_map(lambda dst, src: dst.copy_(src), pc["ssm"], new)
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn1"], h)
    return _ffn_block(p, x + h, cfg, spec, sharder, place, step=True)[0], pc


def forward_decode(params, tokens, caches, cfg: LMConfig, *,
                   sharder: Optional[Sharder] = None,
                   start: Optional[int] = None):
    """tokens: (B, S) -> (logits (B, S, V), caches).  ``caches['pos']`` may
    be a scalar (static batch) or a (B,) per-slot vector (continuous
    batching).  The cache tensors are written in place; the returned dict
    holds them with ``pos`` advanced by S.  S is 1 on the decode hot
    path; the paged scheduler also pushes prefill chunks (S > 1) through
    here.  A ``caches['table']`` switches to the block pool's layout
    (``init_paged_caches``): rows write and read through their block
    table, and ``start`` (a host int, the row's ``pos``) is a one-row
    chunk's first position, K1's query offset on one device.

    With ``sharder`` serving sharded (JAX's ``forward_decode(sharder=)``)
    the tokens are whole on every model rank (the rank's batch slice over
    ``data``), ``params`` the rank's slices (each period's gathered whole
    where it is read, as in training), ``caches`` the rank's layout
    (``init_caches(sharder=)``), and the logits vocab-sharded under
    ``vocab_sharded`` (``sharded_argmax`` reads them)."""
    sharder = fit_sharder(sharder or null_sharder(), cfg)
    specs = cfg.period_specs()
    place = sharder.moe_experts(step=True) if n_moe_layers(cfg) else None
    pos = caches["pos"]
    table = caches.get("table")
    x = decode_embed(params, tokens, cfg, sharder)
    for pp, pcs in zip(unstack(params["periods"], cfg.n_periods),
                       unstack(caches["periods"], cfg.n_periods)):
        pp = sharder.whole(pp, "periods")
        for j, spec in enumerate(specs):
            x, _ = _decode_layer(pp[str(j)], x, pcs[str(j)], cfg, spec, pos,
                                 sharder, place, table=table, start=start)
    x = _apply_norm(cfg, sharder.whole(params["final_norm"], "final_norm"),
                    x)
    new = {"pos": pos + tokens.shape[1], "periods": caches["periods"]}
    if table is not None:
        new["table"] = table
    return logits_fn(params, x, cfg, sharder), new


def prefill_shard_len(cfg: LMConfig, seq: int, n: int) -> int:
    """Positions a rank holds of a ``seq``-token prompt padded on the right
    for a prefill over ``n`` model ranks: a whole share of it, and at least
    an SSM layer's ``d_conv - 1``, the conv halo one permute brings from
    the previous rank (``Sharder.seq_halo``)."""
    least = cfg.ssm_cfg.d_conv - 1 if any(
        sp.mixer == "ssm" for sp in cfg.period_specs()) else 1
    return max(-(-seq // n), least)


def forward_prefill(params, tokens, cfg: LMConfig, *,
                    sharder: Optional[Sharder] = None,
                    backend: str = "kernel", length: Optional[int] = None,
                    extra=None):
    """Full-sequence prefill: returns (logits (B, 1, V) at the prompt's
    last position, caches with pos = its length).  KV cache length ==
    prompt length, in the activation dtype as JAX's (``cache_dtype`` is
    the pools': ``init_caches``, ``init_paged_caches``); SSM layers leave
    their {conv, state} decode cache (``ssm_block(return_cache)``).

    With ``sharder`` on a mesh (JAX's ``forward_prefill(sharder=)``) the
    tokens are the rank's shard of the prompt (``shard_lm_batch``: its
    batch slice, its sequence chunk), the layers run as ``forward`` runs
    them under the planned schedule (K1 and K2 on the rank's heads), and
    the caches come in the rank's layout: K/V its sequence shard (the
    engine re-cuts them onto the cache's blocks, ``Sharder.kv_cache``),
    the SSM state its heads, ``conv`` whole.  ``length`` is the prompt's
    true global length when it was padded on the right to a multiple of
    the SP size (padding after ``length``: causal masking keeps it out of
    the real positions, and the SSM state passes it unchanged); the
    logits are taken at position ``length - 1``, whole on every rank
    (``Sharder.seq_rows``), vocab-sharded under ``vocab_sharded``.
    ``extra``'s ``patch_embeds`` replace the prompt's first
    ``frontend_tokens`` positions, as in ``forward`` (``with_patches``;
    on a mesh the rank's batch slice of them)."""
    sharder = sharder or null_sharder()
    seq = tokens.shape[1] * sharder.seq_shards
    sharder = fit_sharder(sharder, cfg, seq=seq,
                           batch=tokens.shape[0] * sharder.dp_size)
    length = seq if length is None else length
    specs = cfg.period_specs()
    place = sharder.moe_experts() if n_moe_layers(cfg) else None
    x = sharder.enter3(with_patches(
        params, sharded_embed(params, tokens, cfg, sharder), cfg, sharder,
        extra, length))
    periods = [{} for _ in specs]
    for i, pp in enumerate(unstack(params["periods"], cfg.n_periods)):
        pp = sharder.whole(pp, "periods")
        x = sharder.wrap3(x)
        for j, spec in enumerate(specs):
            p = pp[str(j)]
            h = _apply_norm(cfg, p["ln1"], x)
            if spec.mixer == "attn":
                h, (ck, cv) = A.attention_sp(
                    p["attn"], h, cfg.attn_cfg(spec.window), sharder=sharder,
                    backend=backend, causal=True, return_kv=True)
                # the activation dtype, as JAX's: a pool of ``cache_dtype``
                # rounds them where it takes them in
                pc = {"kv": {"k": ck, "v": cv}}
            else:
                h, ssm_cache = S.ssm_block(p["ssm"], h, cfg.ssm_cfg,
                                           backend=backend, sharder=sharder,
                                           return_cache=True, length=length)
                # ssm_block switches back itself: the mixer exit is a keep
                h = sharder.mixer_exit3(h, src="resid")
                pc = {"ssm": ssm_cache}
            if not periods[j]:      # stacked leaves, allocated at period 0
                periods[j] = tree_map(
                    lambda a: a.new_empty((cfg.n_periods,) + tuple(a.shape)),
                    pc)
            tree_map(lambda dst, src: dst[i].copy_(src), periods[j], pc)
            if cfg.post_norm:
                h = _apply_norm(cfg, p["pn1"], h)
            x = sharder.act3(_ffn_block(p, x + h, cfg, spec, sharder, place,
                                        length=length)[0])
    x = _apply_norm(cfg, sharder.whole(params["final_norm"], "final_norm"),
                    sharder.seq_rows(x, length - 1, 1))
    logits = logits_fn(params, x, cfg, sharder)
    return logits, {"pos": torch.tensor(length, dtype=torch.long,
                                        device=x.device),
                    "periods": {str(j): pc for j, pc in enumerate(periods)}}


def serve_contract(cfg: LMConfig, n: int, params, plan: ParallelPlan, *,
                   dp: int = 1, prefill=None, decode: Optional[int] = None,
                   chunk: Optional[int] = None, first_tokens: int = 0,
                   migrate=None, paged_migrate=None, ticks: int = 0,
                   max_len: Optional[int] = None, moe_rows=None
                   ) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls and bytes (``core.dsp``'s rule), by
    kind, that sharded serving issues per rank on a ``(dp, n)`` mesh under
    ``plan``, from ``params`` (the GLOBAL tree; meta tensors will do):

      ``prefill=(batch, seq)``: one prefill of ``batch`` prompts of
        ``seq`` tokens (padded to a multiple of n) and its argmax: the
        hooks' forward (``collective_contract`` at the rank's shard); each
        period leaf a spec splits gathered once (``gathered_numels``),
        the table read once (the ring's n permutes where ``shard_vocab``
        splits it, else a gather if split), the final norm read; one
        all-reduce of the last position (``Sharder.seq_rows``), one of
        each SSM layer's conv window; per attention layer of the period,
        one all-gather of its stacked K/V, every period's, onto the cache's
        blocks (``Sharder.kv_cache``, the re-cut); MoE layers as the
        training forward issues them (``collective_contract``, with
        ``moe_rows`` of the prefill's routing under ``ep``);
      ``decode=rows``: one decode step of ``rows`` rows and its argmax: the
        embedding's all-reduce (``decode_embed``, where the table is split
        by vocab; else its read), each period leaf gathered once, per
        attention layer one all-gather of the float32 softmax partials
        (``_sharded_decode``), per SSM layer one of y in the model dtype,
        the final norm read, and the logits' table read unless the logits
        are vocab-sharded; per MoE layer under ``ep`` one all-reduce of
        the experts' outputs (``moe_block``: each rank runs its block on
        the step's whole tokens), none without.  The block pool's decode
        step issues exactly
        these: its partials have the slot layout's shape, and its blocks'
        gather and scatter stay on the rank;
      ``chunk=c``: one paged prefill chunk of c tokens of one row (the
        paged scheduler's, on a mesh: plain partials): a decode step of
        one row with c tokens in it, without the argmax;
      ``first_tokens=k``: k argmaxes of one row outside a decode step (the
        paged scheduler takes one on a prompt's last chunk);
      each argmax: one all-gather of (max, id) pairs in float64 over
        ``model`` where the logits are vocab-sharded (``sharded_argmax``),
        one of the int64 tokens over ``data`` where dp > 1;
      ``migrate=(slots, max_len, n_new)``: one ``replan`` onto ``n_new``
        ranks: every leaf of the engine's parameters and of a pool of
        ``slots`` x ``max_len`` that a spec splits, gathered whole on this
        mesh (``reshard``: one all-gather per split entry, ``data``'s of
        size 1 too);
      ``paged_migrate=(slots, max_len, block_size, n_blocks, n_new)``:
        the same for the block pool of ``n_blocks`` blocks
        (``init_paged_caches``): the parameters and each KV leaf gathered
        whole, the table and ``pos`` not at all;
      ``ticks``: the continuous scheduler's host-loop turns, one broadcast
        of rank 0's clock each.

    Under ``tp`` a leaf is gathered only over the splits the model does
    not keep (``read_specs``); the prefill's hooks are ``tp``'s
    (``collective_contract(tp=True)``) and its K/V re-cut one all-to-all
    per attention layer of the period onto the blocks of a ``max_len``
    cache (none under ``kv_whole``); a decode step (or chunk) adds per
    attention layer one all-gather of the step's q/k/v heads (of q alone
    under ``kv_whole``) and one SUM all-reduce of the attention output,
    and per MLP or MoE layer one all-reduce (a MoE layer's, under ``ep``
    too, its only one).

    The trainer's contracts' rules: an all-gather counts its result's
    bytes, an all-reduce twice its result's."""
    sizes = {"data": dp, "model": n}
    calls: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}

    def add(kind, size, times=1):
        if times:
            calls[kind] = calls.get(kind, 0) + times
            nbytes[kind] = nbytes.get(kind, 0) + size * times

    def add_all(other):
        for kind, c in other["calls"].items():
            calls[kind] = calls.get(kind, 0) + c
            nbytes[kind] = nbytes.get(kind, 0) + other["bytes"][kind]

    specs = param_pspecs(params, plan, axis_sizes=sizes)
    tp = plan.mode == "tp"
    whole_kv = kv_whole(cfg, plan, n)
    reads = read_specs(specs, plan, kv_whole=whole_kv)
    shard_vocab = (plan.shard_vocab and n > 1 and cfg.vocab % n == 0)
    a_bytes = cfg.dtype.itemsize
    period = cfg.period_specs()
    n_attn = sum(sp.mixer == "attn" for sp in period) * cfg.n_periods
    n_ssm = sum(sp.mixer == "ssm" for sp in period) * cfg.n_periods
    key = "embed" if cfg.tie_embeddings else "unembed"

    def read(path, times=1):
        node, spec, rd = params, specs, reads
        for k in path:
            node, spec, rd = node[k], spec[k], rd[k]
        for leaf, sp, r in zip(tree_leaves(node), tree_leaves(spec),
                               tree_leaves(rd)):
            for numel in read_numels(tuple(leaf.shape), sp, r, sizes):
                add("all-gather", numel * leaf.element_size(), times)

    def periods():
        for leaf, sp, r in zip(tree_leaves(params["periods"]),
                               tree_leaves(specs["periods"]),
                               tree_leaves(reads["periods"])):
            for numel in read_numels(tuple(leaf.shape[1:]), sp[1:], r[1:],
                                     sizes):
                add("all-gather", numel * leaf.element_size(),
                    leaf.shape[0])

    def argmax(rows):
        if shard_vocab:
            add("all-gather", n * rows * 2 * 8)
        if dp > 1:
            add("all-gather", dp * rows * 8)

    if prefill is not None:
        batch, seq = prefill
        b, s = batch // dp, prefill_shard_len(cfg, seq, n)
        add_all(collective_contract(cfg, n, b, s, tp=tp, dp=dp, ep=plan.ep,
                                    moe_rows=moe_rows))
        periods()
        if shard_vocab:
            table = params["embed"]["table"]
            add("collective-permute",
                table.numel() // n * table.element_size(), n)
        else:
            read(("embed",))
        read(("final_norm",))
        if not shard_vocab:
            read((key,))
        add("all-reduce", 2 * b * cfg.d_model * a_bytes)
        if n_ssm:
            sc = cfg.ssm_cfg
            d_xbc = sc.d_inner + 2 * sc.n_groups * sc.d_state
            add("all-reduce", 2 * b * (sc.d_conv - 1) * d_xbc * a_bytes,
                n_ssm)
        for _ in range(sum(sp.mixer == "attn" for sp in period)):
            if not tp:
                add("all-gather", 2 * cfg.n_periods * b * cfg.n_kv_heads
                    * s * n * cfg.head_dim * a_bytes)
            elif not whole_kv:
                if max_len is None:
                    raise ValueError("tp's K/V re-cut moves a max_len "
                                     "cache's blocks: pass max_len")
                add("all-to-all", 2 * cfg.n_periods * b * cfg.n_kv_heads
                    * (max_len // n) * cfg.head_dim * a_bytes)
        argmax(b)
    def step(r, s, take_argmax=True):
        if shard_vocab:
            add("all-reduce", 2 * r * s * cfg.d_model * a_bytes)
        else:
            read(("embed",))
        periods()
        n_moe = n_moe_layers(cfg)
        if tp:
            heads = cfg.n_heads + (0 if whole_kv else 2 * cfg.n_kv_heads)
            add("all-gather", r * s * heads * cfg.head_dim * a_bytes, n_attn)
            add("all-reduce", 2 * r * s * cfg.d_model * a_bytes,
                n_attn + n_moe + sum(sp.ffn == "mlp" for sp in period)
                * cfg.n_periods)
        elif plan.ep:
            add("all-reduce", 2 * r * s * cfg.d_model * a_bytes, n_moe)
        add("all-gather", n * r * cfg.n_heads * s * (cfg.head_dim + 2) * 4,
            n_attn)
        if n_ssm:
            add("all-gather", r * s * cfg.ssm_cfg.d_inner * a_bytes, n_ssm)
        read(("final_norm",))
        if not shard_vocab:
            read((key,))
        if take_argmax:
            argmax(r)

    def moved(pool, cspecs):
        for leaf, sp in zip(tree_leaves(params), tree_leaves(specs)):
            for numel in gathered_numels(tuple(leaf.shape), sp, sizes):
                add("all-gather", numel * leaf.element_size())
        for leaf, sp in zip(tree_leaves(pool), tree_leaves(cspecs)):
            for numel in gathered_numels(tuple(leaf.shape), sp, sizes):
                add("all-gather", numel * leaf.element_size())

    if decode is not None:
        step(decode // dp, 1)
    if chunk is not None:
        step(1, chunk, take_argmax=False)
    for _ in range(first_tokens):
        argmax(1)
    if migrate is not None:
        slots, max_len, _ = migrate
        pool = init_caches(cfg, slots, max_len, per_slot_pos=True,
                           device="meta")
        moved(pool, cache_pspecs(pool, plan))
    if paged_migrate is not None:
        slots, max_len, block, n_blocks, _ = paged_migrate
        pool = init_paged_caches(cfg, slots, max_len, block, n_blocks,
                                 device="meta")
        moved(pool, cache_pspecs(pool, plan, paged=True))
    add("broadcast", 8, ticks)
    return {"calls": calls, "bytes": nbytes}
