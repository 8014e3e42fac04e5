"""Encoder-decoder backbone (counterpart of ``repro.models.encdec``; the
seamless-m4t-large-v2 assignment).

The audio frontend (fbank conformer feature extractor) is a stub, as in
the JAX package: the batch supplies frame embeddings (B, S_enc,
frontend_dim), projected to d_model.  Encoder layers are bidirectional
attention blocks; decoder layers are causal self-attention,
cross-attention over the encoder output and an FFN.  Every attention runs
through ``kernels.ops.flash_attention`` (K1 on the card): the encoder's
not causal, the decoder's self-attention causal, its cross-attention not
causal with S_dec queries against S_enc keys.

Per-layer parameters live under ``enc_periods`` and ``dec_periods``
stacked on a leading layer dim, as in JAX, so a JAX tree crosses over
with no transpose (``repro_torch.bridge``).  JAX's ``scan`` over layers
is a Python loop here, each layer checkpointed with ``remat``.

DSP mapping: the self-attention stages switch (seq <-> head) as the LM's
do; the cross-attention stage switches the *decoder* sequence shard to
heads while the encoder K/V, projected on the rank's shard of the
*encoder* sequence, take one stacked switch of their own
(``attention.attention_sp``): the shard moves between the two distinct
sequence dims (S_dec, S_enc), the paper's multi-dimensional setting in
its enc-dec form.  On a ``("data", "model")`` mesh (``sharder``) the rank
holds its batch slice and its shard of both sequences
(``lm.shard_lm_batch``), and under the spec's ZeRO-3 its parameter
slices, each layer gathering its weights inside its checkpoint
(``Sharder.whole``); ``collective_contract`` and ``param_contract``
count what a step issues.

Serving (``prefill``, then ``decode_step``s) runs on one device.  The
prefill returns self-attention caches with room for the decode
(``max_len``), so the first ``decode_step`` writes past the prompt; JAX's
``prefill`` returns caches of exactly the prompt's length, whose first
decode write clamps onto the prompt's last row (ROADMAP §3).  On a mesh
both raise (ROADMAP queue 1 item 3.7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core.plan import encdec_stages
from repro_torch.core.schedule import (Schedule, plan_joint_schedule,
                                       plan_schedule)
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models.lm import tree_map, unstack
from repro_torch.parallel.partition import (
    STACKED, ParallelPlan, Sharder, null_sharder, param_pspecs,
    store_contract)

SERVE_ON_MESH = ("enc-dec serving on a mesh (prefill and decode_step with "
                 "a sharder) is not ported (ROADMAP queue 1 item 3.7)")


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    frontend_dim: int = 1024       # stub audio feature width
    mlp_kind: str = "relu"
    norm_kind: str = "layer"
    dtype: Any = torch.bfloat16

    def attn_cfg(self, *, rope: bool = True) -> A.AttnConfig:
        return A.AttnConfig(d_model=self.d_model, n_heads=self.n_heads,
                            n_kv_heads=self.n_kv_heads,
                            head_dim=self.head_dim, rope=rope, bias=True)


# ---------------------------------------------------------------------------
# DSP stage declaration + planned switching schedule
# ---------------------------------------------------------------------------

def stages(cfg: EncDecConfig, *, s_enc: Optional[int] = None,
           s_dec: Optional[int] = None, batch: Optional[int] = None):
    """The enc-dec stage graph on the logical (B, S, H·Dh) view
    (``core.plan.encdec_stages``): channel-wise stages compute along dim
    2, attention cores along dim 1; encoder stages carry S_enc-sized
    tensors, decoder stages S_dec-sized.  The gradients are priced at the
    activation dtype (JAX's ``grad_dtype_bytes``, which no caller sets, is
    not ported, as in ``models.lm.stages``)."""
    return encdec_stages(cfg.n_enc_layers, cfg.n_dec_layers, s_enc=s_enc,
                         s_dec=s_dec, batch=batch, d_model=cfg.d_model,
                         dtype_bytes=cfg.dtype.itemsize)


def dsp_schedule(cfg: EncDecConfig, n: int, *, s_enc: Optional[int] = None,
                 s_dec: Optional[int] = None,
                 batch: Optional[int] = None, topology=None,
                 joint: bool = False, bwd_dims=None,
                 overlap: Optional[str] = None) -> Schedule:
    """Solve the switching plan over the whole enc-dec stage graph (enter
    sequence-sharded, leave sequence-sharded for the loss), as JAX's
    does.  ``topology`` prices it in seconds on its links (None: in
    bytes); ``joint=True`` plans the backward too (``core.plan
    .plan_joint``); ``bwd_dims`` forces a backward plan covering every
    stage, which the explicit executor rejects when it is not the mirror
    (``make_sharder``).  JAX's ``overlap`` comes with ROADMAP queue 1
    item 2."""
    if overlap is not None:
        raise NotImplementedError(
            f"overlap {overlap!r} for the enc-dec switches comes with the "
            f"overlapped switch that overlaps (ROADMAP queue 1 item 2)")
    st = stages(cfg, s_enc=s_enc, s_dec=s_dec, batch=batch)
    kw = dict(n=max(n, 1), initial=1, final=1, topology=topology)
    sched = (plan_joint_schedule(st, (1, 2), **kw) if joint
             else plan_schedule(st, (1, 2), **kw))
    if bwd_dims is not None:
        bwd_dims = tuple(bwd_dims)
        if len(bwd_dims) != len(st):
            raise ValueError(
                f"bwd_dims must cover the full stage graph ({len(st)} "
                f"stages); got {len(bwd_dims)}")
        sched = dataclasses.replace(sched, bwd_dims=bwd_dims)
    return sched


def _with_planned_schedule(sharder: Sharder, cfg: EncDecConfig,
                           s_enc: Optional[int] = None,
                           s_dec: Optional[int] = None,
                           batch: Optional[int] = None) -> Sharder:
    """The sharder with the plan attached where it has none (DSP on a
    mesh): the encoder plans on ``s_enc`` alone and the decoder on
    ``s_dec`` alone, as JAX's do; lengths and batch are global."""
    if (sharder.ctx is None or sharder.plan.mode != "dsp"
            or sharder.schedule is not None):
        return sharder
    return sharder.with_schedule(
        dsp_schedule(cfg, sharder.sp_size, s_enc=s_enc, s_dec=s_dec,
                     batch=batch))


def _norm(cfg: EncDecConfig, p, x):
    return L.layer_norm(p, x) if cfg.norm_kind == "layer" else L.rms_norm(p, x)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_norm(cfg: EncDecConfig, device):
    return L.init_norm(cfg.d_model, bias=cfg.norm_kind == "layer",
                       dtype=cfg.dtype, device=device)


def _init_enc_layer(gen: torch.Generator, cfg: EncDecConfig):
    return {"ln1": _init_norm(cfg, gen.device),
            "attn": A.init_attention(gen, cfg.attn_cfg(), dtype=cfg.dtype),
            "ln2": _init_norm(cfg, gen.device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind,
                              bias=True, dtype=cfg.dtype)}


def _init_dec_layer(gen: torch.Generator, cfg: EncDecConfig):
    return {"ln1": _init_norm(cfg, gen.device),
            "self_attn": A.init_attention(gen, cfg.attn_cfg(),
                                          dtype=cfg.dtype),
            "ln_x": _init_norm(cfg, gen.device),
            "cross_attn": A.init_attention(gen, cfg.attn_cfg(rope=False),
                                           dtype=cfg.dtype),
            "ln2": _init_norm(cfg, gen.device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, kind=cfg.mlp_kind,
                              bias=True, dtype=cfg.dtype)}


def _stacked(gen: torch.Generator, n: int, init):
    """``n`` layers drawn in turn, stacked on a leading dim: each layer is
    drawn and copied into place, so the peak is the model plus one
    layer's float32 draw."""
    out = None
    for i in range(n):
        one = init(gen)
        if out is None:
            out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), out, one)
    return out


def init_encdec(seed: int, cfg: EncDecConfig, *, device="cuda"):
    """The parameter tree in JAX's layout (``frontend``, ``embed``,
    ``enc_periods``, ``dec_periods``, ``enc_norm``, ``dec_norm``), drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "frontend": L.init_patch_embed(gen, cfg.frontend_dim, cfg.d_model,
                                       dtype=cfg.dtype),
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                  dtype=cfg.dtype),
        "enc_periods": _stacked(gen, cfg.n_enc_layers,
                                lambda g: _init_enc_layer(g, cfg)),
        "dec_periods": _stacked(gen, cfg.n_dec_layers,
                                lambda g: _init_dec_layer(g, cfg)),
        "enc_norm": _init_norm(cfg, dev),
        "dec_norm": _init_norm(cfg, dev),
    }


def encdec_param_count(cfg: EncDecConfig) -> int:
    """JAX's count: attention and MLP weights, the table and the frontend
    (biases and norms left out, as JAX leaves them)."""
    d, dh = cfg.d_model, cfg.head_dim
    attn = d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    mlp = L.mlp_param_count(d, cfg.d_ff, cfg.mlp_kind)
    enc = cfg.n_enc_layers * (attn + mlp)
    dec = cfg.n_dec_layers * (2 * attn + mlp)
    return enc + dec + cfg.vocab * d + cfg.frontend_dim * d


# ---------------------------------------------------------------------------
# Training: encode, decode, loss
# ---------------------------------------------------------------------------

def _layers(body, x, stack, n: int, remat: bool, *extra):
    """``x`` through ``body(x, layer, *extra)`` for each of the ``n``
    layers of ``stack``, each checkpointed under ``remat`` (JAX's
    ``jax.checkpoint`` per scanned layer): the recompute reissues every
    collective of the layer, so no early stop."""
    for lp in unstack(stack, n):
        if remat:
            with set_checkpoint_early_stop(False):
                x = checkpoint(body, x, lp, *extra, use_reentrant=False)
        else:
            x = body(x, lp, *extra)
    return x


def encode(params, feats, cfg: EncDecConfig, *,
           sharder: Optional[Sharder] = None, backend: str = "kernel",
           remat: bool = True, fused_switch: bool = True):
    """feats (B, S_enc, frontend_dim) -> the encoder output (B, S_enc,
    d_model); on a mesh the rank's shard of both, each layer's weights
    gathered at the top of its checkpointed body."""
    sharder = sharder or null_sharder()
    sharder = _with_planned_schedule(
        sharder, cfg, s_enc=feats.shape[1] * sharder.sp_size,
        batch=feats.shape[0] * sharder.dp_size)
    frontend = sharder.whole(params["frontend"], "frontend")
    x = sharder.enter3(L.patch_embed(frontend, feats.to(cfg.dtype)))

    def body(xc, lp):
        lp = sharder.whole(lp, "enc_periods")
        xc = sharder.wrap3(xc)
        h = _norm(cfg, lp["ln1"], xc)
        h = A.attention_sp(lp["attn"], h, cfg.attn_cfg(), sharder=sharder,
                           backend=backend, fused_switch=fused_switch,
                           causal=False)
        xc = xc + h
        h = _norm(cfg, lp["ln2"], xc)
        h = sharder.act3(L.mlp(lp["mlp"], h, cfg.mlp_kind))
        return sharder.act3(xc + h)

    x = _layers(body, x, params["enc_periods"], cfg.n_enc_layers, remat)
    return _norm(cfg, sharder.whole(params["enc_norm"], "enc_norm"), x)


def decode(params, tokens, enc_out, cfg: EncDecConfig, *,
           sharder: Optional[Sharder] = None, backend: str = "kernel",
           remat: bool = True, fused_switch: bool = True, embed=None):
    """tokens (B, S_dec) and the encoder output (B, S_enc, d_model) -> the
    final decoder hidden states (B, S_dec, d_model); on a mesh the rank's
    shards.  ``embed`` is the table's subtree as read whole
    (``Sharder.whole``; ``encdec_loss`` gathers it once for the lookup
    and the loss)."""
    sharder = sharder or null_sharder()
    sharder = _with_planned_schedule(
        sharder, cfg, s_dec=tokens.shape[1] * sharder.sp_size,
        batch=tokens.shape[0] * sharder.dp_size)
    if embed is None:
        embed = sharder.whole(params["embed"], "embed")
    x = sharder.enter3(L.embed(embed, tokens))

    def body(xc, lp, enc):
        lp = sharder.whole(lp, "dec_periods")
        xc = sharder.wrap3(xc)
        h = _norm(cfg, lp["ln1"], xc)
        h = A.attention_sp(lp["self_attn"], h, cfg.attn_cfg(),
                           sharder=sharder, backend=backend,
                           fused_switch=fused_switch, causal=True)
        xc = xc + h
        h = _norm(cfg, lp["ln_x"], xc)
        h = A.attention_sp(lp["cross_attn"], h, cfg.attn_cfg(rope=False),
                           sharder=sharder, backend=backend,
                           fused_switch=fused_switch, causal=False,
                           x_kv=enc)
        xc = xc + h
        h = _norm(cfg, lp["ln2"], xc)
        h = sharder.act3(L.mlp(lp["mlp"], h, cfg.mlp_kind))
        return sharder.act3(xc + h)

    x = _layers(body, x, params["dec_periods"], cfg.n_dec_layers, remat,
                enc_out)
    return _norm(cfg, sharder.whole(params["dec_norm"], "dec_norm"), x)


def encdec_loss(params, batch, cfg: EncDecConfig, *,
                sharder: Optional[Sharder] = None, backend: str = "kernel",
                remat: bool = True, fused_switch: bool = True):
    """batch {"feats" (B, S_enc, F), "tokens" (B, S_dec), "labels" (B,
    S_dec)} -> (loss, {"xent": loss}): the mean cross-entropy through the
    tied table (``lm.chunked_xent``).  On a mesh the batch is the rank's
    shard (``lm.shard_lm_batch``) and the loss its share of the global
    mean.  The table is gathered whole once, outside the checkpoints, for
    the decoder's lookup and the loss, whose config is JAX's shim (no
    final softcap)."""
    sharder = sharder or null_sharder()
    embed = sharder.whole(params["embed"], "embed")
    enc = encode(params, batch["feats"], cfg, sharder=sharder,
                 backend=backend, remat=remat, fused_switch=fused_switch)
    x = decode(params, batch["tokens"], enc, cfg, sharder=sharder,
               backend=backend, remat=remat, fused_switch=fused_switch,
               embed=embed)
    shim = lm.LMConfig(name="_", n_layers=1, d_model=cfg.d_model,
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab)
    loss = lm.chunked_xent(x, embed["table"], batch["labels"], shim,
                           sharder=sharder)
    return loss, {"xent": loss}


# ---------------------------------------------------------------------------
# What a step issues on a mesh
# ---------------------------------------------------------------------------

def collective_contract(cfg: EncDecConfig, n: int, batch: int, s_enc: int,
                        s_dec: int, *, fused_switch: bool = True
                        ) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls one forward issues per rank of a
    mesh with ``n`` ranks on ``model``, by kind, and their bytes
    (``core.dsp.volume``'s rule), for the rank's local batch of ``batch``
    rows, ``s_enc`` frames and ``s_dec`` tokens, under DSP's planned
    layouts (resid on the sequence, attention cores on heads):

      an attention, head switch (the q heads divide n; K/V heads repeated
        up to n): in, one all-to-all of q, k and v stacked where q and
        K/V have the rank's same length and the heads match (self
        attention, fused), else q's and the stacked K/V's (cross
        attention: S_dec queries, S_enc keys), or three unfused; out, one
        all-to-all of the output;
      an attention, kv_gather (the heads do not divide n): one
        all-gather of the stacked K/V over their whole sequence;

    so at 16 heads and fused, 2 all-to-alls an encoder layer and 5 a
    decoder layer.  Embedding, frontend, norms, MLPs and the loss issue
    none.  A step with ``remat`` issues ``lm.remat_step`` of it;
    ``param_contract`` adds the layouts' and the trainer's."""
    calls: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    width = cfg.dtype.itemsize
    h, dh = cfg.n_heads, cfg.head_dim

    def add(kind, elems):
        calls[kind] = calls.get(kind, 0) + 1
        nbytes[kind] = nbytes.get(kind, 0) + elems * width

    def attention(s_q, s_kv):
        hkv = cfg.n_kv_heads
        if h % n:                                 # kv_gather
            add("all-gather", 2 * batch * hkv * s_kv * n * dh)
            return
        if hkv < n:
            hkv *= (n + hkv - 1) // hkv
        q, kv = batch * h * s_q * dh, batch * hkv * s_kv * dh
        if fused_switch and h == hkv and s_q == s_kv:
            add("all-to-all", q + 2 * kv)
        elif fused_switch:
            add("all-to-all", q)
            add("all-to-all", 2 * kv)
        else:
            for elems in (q, kv, kv):
                add("all-to-all", elems)
        add("all-to-all", q)

    for _ in range(cfg.n_enc_layers):
        attention(s_enc, s_enc)
    for _ in range(cfg.n_dec_layers):
        attention(s_dec, s_dec)
        attention(s_dec, s_enc)
    return {"calls": calls, "bytes": nbytes}


# leaves read outside the checkpoints, and how often a step reads each
_READS = {("embed", "table"): 1, ("frontend", "proj", "w"): 1,
          ("frontend", "proj", "b"): 1, ("enc_norm", "scale"): 1,
          ("enc_norm", "bias"): 1, ("dec_norm", "scale"): 1,
          ("dec_norm", "bias"): 1}


def param_contract(cfg: EncDecConfig, params, plan: ParallelPlan,
                   sizes: Dict[str, int]) -> Dict[str, Dict[str, int]]:
    """The calls and bytes, by kind, that the parameter layouts of
    ``plan`` (``param_pspecs`` of ``params``, the GLOBAL tree; meta
    tensors will do) add per rank to one training step with ``remat`` on
    a mesh of ``sizes``, beside
    ``lm.remat_step(collective_contract(...))``
    (``parallel.partition.store_contract``, which adds the trainer's
    all-reduces):

      each layer leaf of ``enc_periods`` and ``dec_periods`` a spec
        splits: per layer 2 all-gathers of the whole leaf (the forward's
        and the recompute's, inside the layer's checkpoint) and 1
        reduce-scatter of its float32 gradient;
      the tied table (gathered once for the decoder's lookup and the
        loss), the frontend and the two final norms, where a spec splits
        them: 1 all-gather and 1 reduce-scatter each.

    The table takes no ring: under ``shard_vocab`` it is split over
    ``model`` where the ranks divide the vocab (256206 divides 2, not 4)
    and gathered whole."""
    def times(path):
        if path[0] in STACKED:
            return 2, 1
        return _READS[path], _READS[path]

    specs = param_pspecs(params, plan, axis_sizes=sizes)
    return store_contract(params, specs, sizes, times)


# ---------------------------------------------------------------------------
# Serving: self-attention KV caches + precomputed cross K/V
# ---------------------------------------------------------------------------

def init_dec_caches(cfg: EncDecConfig, batch: int, max_len: int,
                    enc_len: int, *, dtype=None, device="cuda"):
    """Zero caches: the decoder's self-attention K/V (n_dec, B, Hkv,
    max_len, D) and the cross K/V (n_dec, B, Hkv, enc_len, D), with a
    scalar ``pos``."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_dec_layers, batch, cfg.n_kv_heads)

    def zeros(length):
        return torch.zeros(shape + (length, cfg.head_dim), dtype=dtype,
                           device=dev)
    return {"pos": torch.zeros((), dtype=torch.long, device=dev),
            "periods": {"kv": {"k": zeros(max_len), "v": zeros(max_len)},
                        "cross": {"k": zeros(enc_len),
                                  "v": zeros(enc_len)}}}


def build_cross_caches(params, enc_out, cfg: EncDecConfig):
    """Every decoder layer's cross K/V from the encoder output, (n_dec, B,
    Hkv, S_enc, D) each: computed once a request, read by every decode
    step."""
    b, s_enc, _ = enc_out.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    ks, vs = [], []
    for lp in unstack(params["dec_periods"], cfg.n_dec_layers):
        for w, out in ((lp["cross_attn"]["wk"], ks),
                       (lp["cross_attn"]["wv"], vs)):
            out.append(L.linear(w, enc_out).reshape(
                b, s_enc, hkv, dh).transpose(1, 2))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _refuse_mesh(sharder: Optional[Sharder]) -> None:
    if sharder is not None and sharder.ctx is not None:
        raise NotImplementedError(SERVE_ON_MESH)


def decode_step(params, tokens, caches, cfg: EncDecConfig, *,
                sharder: Optional[Sharder] = None, backend: str = "ref"):
    """tokens (B, 1) -> (logits (B, 1, vocab), caches).  Each decoder
    layer writes the step's self-attention K/V at ``pos`` into its cache
    IN PLACE (``attention.attention``; the write clamps to the cache, as
    JAX's does, so the cache needs room) and attends its prefix; the
    cross-attention attends the static cross K/V over the whole encoder
    length through ``attention._ref_decode``, as JAX's does.  The
    returned caches hold the same tensors, ``pos`` one on."""
    _refuse_mesh(sharder)
    pos = caches["pos"]
    kv, cross = caches["periods"]["kv"], caches["periods"]["cross"]
    x = L.embed(params["embed"], tokens)
    acfg, xcfg = cfg.attn_cfg(), cfg.attn_cfg(rope=False)
    b, s, _ = x.shape
    for i, lp in enumerate(unstack(params["dec_periods"], cfg.n_dec_layers)):
        h = _norm(cfg, lp["ln1"], x)
        h, _ = A.attention(lp["self_attn"], h, acfg, causal=True,
                           cache={"k": kv["k"][i], "v": kv["v"][i],
                                  "pos": pos}, backend=backend)
        x = x + h
        h = _norm(cfg, lp["ln_x"], x)
        q = L.linear(lp["cross_attn"]["wq"], h).reshape(
            b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        o = A._ref_decode(q, cross["k"][i], cross["v"][i], xcfg, pos,
                          causal=False)
        x = x + L.linear(lp["cross_attn"]["wo"],
                         o.transpose(1, 2).reshape(b, s, -1))
        h = _norm(cfg, lp["ln2"], x)
        x = x + L.mlp(lp["mlp"], h, cfg.mlp_kind)
    x = _norm(cfg, params["dec_norm"], x)
    logits = x @ params["embed"]["table"].t()
    return logits, {"pos": pos + s, "periods": caches["periods"]}


def prefill(params, batch, cfg: EncDecConfig, *,
            sharder: Optional[Sharder] = None, backend: str = "kernel",
            fused_switch: bool = True, max_len: Optional[int] = None,
            caches=None):
    """Encode the features, run the decoder prompt, return (the last
    position's logits (B, 1, vocab), caches ready for ``decode_step``).
    The caches are ``caches`` (``init_dec_caches``' buffers, written in
    place) or new ones of ``max_len`` positions; either must hold the
    prompt and the decode's positions.  Each decoder layer's cross K/V
    are the ones its prompt's cross-attention projects (what
    ``build_cross_caches`` computes), kept as they come.  Every attention
    goes through ``flash_attention`` (K1 on the card: n_enc + 2 n_dec
    launches)."""
    _refuse_mesh(sharder)
    tokens = batch["tokens"]
    b, s_dec = tokens.shape
    s_enc = batch["feats"].shape[1]
    if caches is None:
        if max_len is None:
            raise ValueError("prefill needs caches with room for the "
                             "decode: pass max_len or init_dec_caches' "
                             "buffers")
        caches = init_dec_caches(cfg, b, max_len, s_enc,
                                 device=tokens.device)
    kv, cross = caches["periods"]["kv"], caches["periods"]["cross"]
    if kv["k"].shape[3] < s_dec or cross["k"].shape[3] != s_enc:
        raise ValueError(
            f"caches of {kv['k'].shape[3]} positions and {cross['k'].shape[3]}"
            f" frames cannot take a {s_dec}-token prompt over {s_enc} frames")
    enc = encode(params, batch["feats"], cfg, backend=backend, remat=False,
                 fused_switch=fused_switch)
    x = L.embed(params["embed"], tokens)
    acfg, xcfg = cfg.attn_cfg(), cfg.attn_cfg(rope=False)
    for i, lp in enumerate(unstack(params["dec_periods"], cfg.n_dec_layers)):
        h = _norm(cfg, lp["ln1"], x)
        h, (ck, cv) = A.attention_sp(lp["self_attn"], h, acfg,
                                     backend=backend, causal=True,
                                     return_kv=True)
        kv["k"][i, :, :, :s_dec] = ck
        kv["v"][i, :, :, :s_dec] = cv
        x = x + h
        h = _norm(cfg, lp["ln_x"], x)
        h, (ck, cv) = A.attention_sp(lp["cross_attn"], h, xcfg,
                                     backend=backend, causal=False, x_kv=enc,
                                     return_kv=True)
        cross["k"][i] = ck
        cross["v"][i] = cv
        x = x + h
        h = _norm(cfg, lp["ln2"], x)
        x = x + L.mlp(lp["mlp"], h, cfg.mlp_kind)
    x = _norm(cfg, params["dec_norm"], x)
    logits = x[:, -1:] @ params["embed"]["table"].t()
    caches["pos"] = torch.full((), s_dec, dtype=torch.long,
                               device=tokens.device)
    return logits, caches


__all__ = ["EncDecConfig", "stages", "dsp_schedule", "init_encdec",
           "encdec_param_count", "encode", "decode", "encdec_loss",
           "collective_contract", "param_contract", "init_dec_caches",
           "build_cross_caches", "decode_step", "prefill"]
