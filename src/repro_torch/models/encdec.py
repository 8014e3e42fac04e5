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

Serving (``prefill``, then ``decode_step``s) runs on one device or on
the mesh.  The prefill returns self-attention caches with room for the
decode (``max_len``), so the first ``decode_step`` writes past the
prompt; JAX's ``prefill`` returns caches of exactly the prompt's length,
whose first decode write clamps onto the prompt's last row (ROADMAP §3).
On a mesh (``sharder`` serving sharded) both caches are split by
sequence over ``model`` as JAX's ``cache_pspecs`` lays them out: the
prefill runs under the training forward's hooks, its self-attention K/V
re-cut onto the rank's block of the cache (``Sharder.kv_cache``) and the
cross K/V kept as the rank's shard of the encoder sequence; a decode step
takes its token whole on every model rank and merges each attention's
softmax partials over ``model`` (``attention._sharded_decode``).
``serve_contract`` counts what both issue.
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
    STACKED, ParallelPlan, Sharder, gathered_numels, kv_block, null_sharder,
    param_pspecs, store_contract)

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


def _shim(cfg: EncDecConfig) -> lm.LMConfig:
    """The LM config whose table rules are the decoder's (JAX's shim): the
    tied table, no embedding scale, no final softcap."""
    return lm.LMConfig(name="_", n_layers=1, d_model=cfg.d_model,
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab)


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
    loss = lm.chunked_xent(x, embed["table"], batch["labels"], _shim(cfg),
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
                    enc_len: int, *, dtype=None, device="cuda",
                    sharder: Optional[Sharder] = None):
    """Zero caches: the decoder's self-attention K/V (n_dec, B, Hkv,
    max_len, D) and the cross K/V (n_dec, B, Hkv, enc_len, D), with a
    scalar ``pos``.  With ``sharder`` serving sharded, this rank's layout
    (JAX's ``cache_pspecs``): its batch slice over ``data`` and its block
    of each sequence over ``model`` (``kv_block``)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    lengths = {"kv": max_len, "cross": enc_len}
    if sharder is not None and sharder.serves_sharded:
        batch //= sharder.dp_size
        for k, n in lengths.items():
            start, stop = kv_block(sharder.ctx, sharder.plan, n)
            lengths[k] = stop - start
    shape = (cfg.n_dec_layers, batch, cfg.n_kv_heads)

    def zeros(length):
        return torch.zeros(shape + (length, cfg.head_dim), dtype=dtype,
                           device=dev)
    return {"pos": torch.zeros((), dtype=torch.long, device=dev),
            "periods": {k: {"k": zeros(n), "v": zeros(n)}
                        for k, n in lengths.items()}}


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


def _logits(params, x, embed, cfg: EncDecConfig, sharder: Sharder):
    """x (B, S, d) whole on every rank -> logits against the tied table:
    this rank's vocab chunk where the table is split by vocab and read
    there (``lm.vocab_sharded``), else against ``embed``, the table read
    whole."""
    if lm.vocab_sharded(_shim(cfg), sharder):
        return x @ params["embed"]["table"].t()
    return x @ embed["table"].t()


def argmax(logits, cfg: EncDecConfig, sharder: Optional[Sharder] = None):
    """The greedy tokens of ``prefill``'s or ``decode_step``'s logits, in
    global vocab ids (``lm.sharded_argmax``: one all-gather of (max, id)
    pairs over ``model`` where the logits are vocab-sharded)."""
    return lm.sharded_argmax(logits, _shim(cfg), sharder)


def decode_step(params, tokens, caches, cfg: EncDecConfig, *,
                sharder: Optional[Sharder] = None, backend: str = "ref"):
    """tokens (B, 1) -> (logits (B, 1, vocab), caches).  Each decoder
    layer writes the step's self-attention K/V at ``pos`` into its cache
    IN PLACE (``attention.attention``; the write clamps to the cache, as
    JAX's does, so the cache needs room) and attends its prefix; the
    cross-attention attends the static cross K/V over the whole encoder
    length through ``attention._ref_decode``, as JAX's does.  The
    returned caches hold the same tensors, ``pos`` one on.

    With ``sharder`` serving sharded the tokens are the rank's batch
    slice, whole on every model rank, ``params`` the rank's slices (each
    layer's gathered where it is read), ``caches`` the rank's layout
    (``init_dec_caches(sharder=)``): the step's K/V go to the rank whose
    block holds ``pos``, and both attentions merge their blocks' softmax
    partials over ``model`` (``attention._sharded_decode``).  The
    embedding and the logits read the tied table as the LM's decode does
    (``lm.decode_embed``): vocab-sharded logits where the ranks divide the
    vocab under ``shard_vocab`` (``argmax`` reads them)."""
    sharder = sharder or null_sharder()
    sharded = sharder.serves_sharded
    shim = _shim(cfg)
    pos = caches["pos"]
    kv, cross = caches["periods"]["kv"], caches["periods"]["cross"]
    if lm.vocab_sharded(shim, sharder):
        embed = None
        x = lm.decode_embed(params, tokens, shim, sharder)
    else:
        embed = sharder.whole(params["embed"], "embed")
        x = L.embed(embed, tokens)
    acfg, xcfg = cfg.attn_cfg(), cfg.attn_cfg(rope=False)
    b, s, _ = x.shape
    for i, lp in enumerate(unstack(params["dec_periods"], cfg.n_dec_layers)):
        lp = sharder.whole(lp, "dec_periods")
        h = _norm(cfg, lp["ln1"], x)
        h, _ = A.attention(lp["self_attn"], h, acfg, causal=True,
                           cache={"k": kv["k"][i], "v": kv["v"][i],
                                  "pos": pos}, backend=backend,
                           sharder=sharder)
        x = x + h
        h = _norm(cfg, lp["ln_x"], x)
        q = L.linear(lp["cross_attn"]["wq"], h).reshape(
            b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)
        if sharded:
            o = A._sharded_decode(q, cross["k"][i], cross["v"][i], xcfg,
                                  pos, False, sharder)
        else:
            o = A._ref_decode(q, cross["k"][i], cross["v"][i], xcfg, pos,
                              causal=False)
        x = x + L.linear(lp["cross_attn"]["wo"],
                         o.transpose(1, 2).reshape(b, s, -1))
        h = _norm(cfg, lp["ln2"], x)
        x = x + L.mlp(lp["mlp"], h, cfg.mlp_kind)
    x = _norm(cfg, sharder.whole(params["dec_norm"], "dec_norm"), x)
    return (_logits(params, x, embed, cfg, sharder),
            {"pos": pos + s, "periods": caches["periods"]})


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
    launches).

    With ``sharder`` serving sharded (JAX's ``prefill(sharder=)``) the
    batch is the rank's shard (``lm.shard_lm_batch``: its batch slice,
    its shard of both sequences, each dividing by the model ranks), the
    encoder and the decoder run as ``encdec_loss`` runs them under the
    planned schedules (K1 on the rank's heads), each layer's weights
    gathered where they are read, and the caches come in the rank's
    layout (``init_dec_caches(sharder=)``): every layer's self-attention
    K/V re-cut onto the rank's block of the ``max_len`` cache in one
    all-gather (``Sharder.kv_cache``), the cross K/V the rank's shard of
    the encoder sequence as its cross-attention projects them.  The
    logits come whole on every rank (``Sharder.seq_rows``), vocab-sharded
    where ``decode_step``'s are."""
    sharder = sharder or null_sharder()
    sharded = sharder.serves_sharded
    tokens = batch["tokens"]
    b, s_loc = tokens.shape
    n = sharder.seq_shards if sharded else 1
    s_dec, s_enc = s_loc * n, batch["feats"].shape[1] * n
    if caches is None:
        if max_len is None:
            raise ValueError("prefill needs caches with room for the "
                             "decode: pass max_len or init_dec_caches' "
                             "buffers")
        caches = init_dec_caches(cfg, b * sharder.dp_size if sharded else b,
                                 max_len, s_enc, device=tokens.device,
                                 sharder=sharder)
    kv, cross = caches["periods"]["kv"], caches["periods"]["cross"]
    if kv["k"].shape[3] * n < s_dec or cross["k"].shape[3] * n != s_enc:
        raise ValueError(
            f"caches of {kv['k'].shape[3] * n} positions and "
            f"{cross['k'].shape[3] * n} frames cannot take a {s_dec}-token "
            f"prompt over {s_enc} frames")
    enc = encode(params, batch["feats"], cfg, sharder=sharder,
                 backend=backend, remat=False, fused_switch=fused_switch)
    dec = _with_planned_schedule(sharder, cfg, s_dec=s_dec,
                                 batch=b * sharder.dp_size)
    embed = sharder.whole(params["embed"], "embed")
    x = dec.enter3(L.embed(embed, tokens))
    acfg, xcfg = cfg.attn_cfg(), cfg.attn_cfg(rope=False)
    ks, vs = [], []
    for i, lp in enumerate(unstack(params["dec_periods"], cfg.n_dec_layers)):
        lp = dec.whole(lp, "dec_periods")
        x = dec.wrap3(x)
        h = _norm(cfg, lp["ln1"], x)
        h, (ck, cv) = A.attention_sp(lp["self_attn"], h, acfg, sharder=dec,
                                     backend=backend, causal=True,
                                     fused_switch=fused_switch,
                                     return_kv=True)
        ks.append(ck)
        vs.append(cv)
        x = x + h
        h = _norm(cfg, lp["ln_x"], x)
        h, (ck, cv) = A.attention_sp(lp["cross_attn"], h, xcfg, sharder=dec,
                                     backend=backend, causal=False, x_kv=enc,
                                     fused_switch=fused_switch,
                                     return_kv=True)
        cross["k"][i] = ck
        cross["v"][i] = cv
        x = x + h
        h = _norm(cfg, lp["ln2"], x)
        x = dec.act3(x + dec.act3(L.mlp(lp["mlp"], h, cfg.mlp_kind)))
    # every layer's self K/V onto the rank's blocks of the cache at once
    both = dec.kv_cache(torch.stack([torch.stack(ks), torch.stack(vs)]),
                        s_dec, kv["k"].shape[3] * n)
    kv["k"].copy_(both[0])
    kv["v"].copy_(both[1])
    x = _norm(cfg, dec.whole(params["dec_norm"], "dec_norm"),
              dec.seq_rows(x, s_dec - 1, 1))
    caches["pos"] = torch.full((), s_dec, dtype=torch.long,
                               device=tokens.device)
    return _logits(params, x, embed, cfg, dec), caches


def serve_contract(cfg: EncDecConfig, n: int, params, plan: ParallelPlan, *,
                   dp: int = 1, prefill=None, decode: Optional[int] = None
                   ) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls and bytes (``core.dsp``'s rule), by
    kind, that serving on a ``(dp, n)`` mesh under ``plan`` issues per
    rank, from ``params`` (the GLOBAL tree; meta tensors will do):

      ``prefill=(batch, s_enc, s_dec)``: one ``prefill`` of ``batch``
        requests of ``s_enc`` frames and ``s_dec``-token prompts: the
        hooks' forward without remat (``collective_contract`` at the
        rank's shard: 2 all-to-alls an encoder layer, 5 a decoder layer
        at 16 heads); every leaf a spec splits read once (each layer's
        once per layer, the table once for the lookup and the logits);
        one all-gather of every layer's stacked self K/V onto the cache's
        blocks (``Sharder.kv_cache``); one all-reduce of the last
        position (``Sharder.seq_rows``);
      ``decode=rows``: one ``decode_step`` of ``rows`` rows: the
        embedding's all-reduce where the table is split by vocab and read
        there (``lm.decode_embed``), else the table read once; each
        layer's leaves read once; per decoder layer two all-gathers of
        the float32 softmax partials (the self-attention's and the
        cross-attention's, ``attention._sharded_decode``); the final
        norm read;

    and after each, ``argmax``'s all-gather of (max, id) pairs in float64
    over ``model`` where the logits are vocab-sharded.  The hooks are
    counted with the fused switch, as ``prefill`` runs them.

    The trainer's rules: an all-gather counts its result's bytes, an
    all-reduce twice its result's."""
    sizes = {"data": dp, "model": n}
    calls: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}

    def add(kind, size, times=1):
        if times:
            calls[kind] = calls.get(kind, 0) + times
            nbytes[kind] = nbytes.get(kind, 0) + size * times

    specs = param_pspecs(params, plan, axis_sizes=sizes)
    split = plan.shard_vocab and n > 1 and cfg.vocab % n == 0
    width = cfg.dtype.itemsize

    def read(*keys):
        node, spec = params, specs
        for k in keys:
            node, spec = node[k], spec[k]
        for leaf, sp in zip(lm.tree_leaves(node), lm.tree_leaves(spec)):
            times = 1
            if keys[0] in STACKED:
                shape, sp, times = tuple(leaf.shape[1:]), sp[1:], leaf.shape[0]
            else:
                shape = tuple(leaf.shape)
            for numel in gathered_numels(shape, sp, sizes):
                add("all-gather", numel * leaf.element_size(), times)

    def take_argmax(rows):
        if split:
            add("all-gather", n * rows * 2 * 8)

    if prefill is not None:
        batch, s_enc, s_dec = prefill
        b = batch // dp
        hooks = collective_contract(cfg, n, b, s_enc // n, s_dec // n)
        for kind, c in hooks["calls"].items():
            calls[kind] = calls.get(kind, 0) + c
            nbytes[kind] = nbytes.get(kind, 0) + hooks["bytes"][kind]
        for key in ("frontend", "enc_periods", "enc_norm", "embed",
                    "dec_periods", "dec_norm"):
            read(key)
        add("all-gather", 2 * cfg.n_dec_layers * b * cfg.n_kv_heads * s_dec
            * cfg.head_dim * width)
        add("all-reduce", 2 * b * cfg.d_model * width)
        take_argmax(b)
    if decode is not None:
        r = decode // dp
        if split:
            add("all-reduce", 2 * r * cfg.d_model * width)
        else:
            read("embed")
        read("dec_periods")
        add("all-gather", n * r * cfg.n_heads * (cfg.head_dim + 2) * 4,
            2 * cfg.n_dec_layers)
        read("dec_norm")
        take_argmax(r)
    return {"calls": calls, "bytes": nbytes}


__all__ = ["EncDecConfig", "stages", "dsp_schedule", "init_encdec",
           "encdec_param_count", "encode", "decode", "encdec_loss",
           "collective_contract", "param_contract", "init_dec_caches",
           "build_cross_caches", "decode_step", "prefill", "argmax",
           "serve_contract"]
