"""Decoder-only LM assembled from per-layer block specs (counterpart of
``repro.models.lm``): init, the training forward and loss, and the serving
path (prefill, decode, logits).

Per-period layer parameters live under ``periods`` stacked on a leading
``n_periods`` dim, as in the JAX package, so a JAX parameter tree crosses
over with no transpose (``repro_torch.bridge``).  The JAX ``lax.scan`` over
periods is a Python loop here.  Attention, MLP and SSM layers are ported
(SSM layers train; serving them comes with mamba2 serving); MoE layers
come with their family.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


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


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` leafwise, ``path`` the tuple of keys to the
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


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
    if spec.ffn == "moe":
        raise NotImplementedError("moe layers are not ported yet")
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
    drawn and copied in turn, so the peak is the model plus one period's
    float32 draw."""
    if cfg.frontend_dim:
        raise NotImplementedError("the VLM frontend is not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = cfg.period_specs()
    params: Dict[str, Any] = {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                  dtype=cfg.dtype)}
    periods = None
    for i in range(cfg.n_periods):
        one = {str(j): _init_layer(gen, cfg, spec)
               for j, spec in enumerate(specs)}
        if periods is None:
            periods = tree_map(
                lambda a: a.new_empty((cfg.n_periods,) + tuple(a.shape)), one)
        tree_map(lambda dst, src: dst[i].copy_(src), periods, one)
    params["periods"] = periods
    params["final_norm"] = _init_norm_kind(cfg, cfg.d_model, dev)
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                             dtype=cfg.dtype)
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

def _apply_layer(p, x, cfg: LMConfig, spec: LayerSpec, backend: str):
    h = _apply_norm(cfg, p["ln1"], x)
    if spec.mixer == "attn":
        h = A.attention_sp(p["attn"], h, cfg.attn_cfg(spec.window),
                           backend=backend, causal=True)
    else:
        h = S.ssm_block(p["ssm"], h, cfg.ssm_cfg, backend=backend)
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn1"], h)
    return _ffn_block(p, x + h, cfg, spec)


def forward(params, tokens, cfg: LMConfig, *, backend: str = "kernel",
            remat: bool = True):
    """tokens: (B, S) -> final hidden states (B, S, C).  ``remat``
    checkpoints each period and recomputes it in the backward (JAX's
    ``remat_policy="full"``), so the backward runs every period's forward
    once more.  The JAX forward's MoE load-balance aux comes with MoE."""
    specs = cfg.period_specs()
    x = L.embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale)

    def period_body(x, pp):
        for j, spec in enumerate(specs):
            x = _apply_layer(pp[str(j)], x, cfg, spec, backend)
        return x

    for pp in unstack(params["periods"], cfg.n_periods):
        if remat:
            x = checkpoint(period_body, x, pp, use_reentrant=False)
        else:
            x = period_body(x, pp)
    return _apply_norm(cfg, params["final_norm"], x)


def chunked_xent(x, table, labels, cfg: LMConfig, *, chunk: int = 512):
    """Mean cross-entropy without materialising (B, S, V): a loop over S
    chunks, each checkpointed so its logits are recomputed in the
    backward.  Logits are a matmul in the model dtype, upcast to f32."""
    b, s, _ = x.shape
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
    return total / (b * s)


def lm_loss(params, batch, cfg: LMConfig, *, backend: str = "kernel",
            remat: bool = True):
    """batch {"tokens", "labels"}: (B, S) -> (loss, {"xent": loss})."""
    x = forward(params, batch["tokens"], cfg, backend=backend, remat=remat)
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["unembed"]["table"])
    loss = chunked_xent(x, table, batch["labels"], cfg)
    return loss, {"xent": loss}


# ---------------------------------------------------------------------------
# Serving: prefill + incremental decode
# ---------------------------------------------------------------------------

def init_caches(cfg: LMConfig, batch: int, max_len: int, *, dtype=None,
                per_slot_pos: bool = False, device="cuda"):
    """Zero caches, stacked per period.  Attention layers carry {k, v} of
    (n_periods, B, Hkv, max_len, Dh); SSM layers carry {conv, state} of
    (n_periods, B, d_conv - 1, d_xbc) in the model dtype and (n_periods,
    B, H, P, S) in float32.  ``pos`` is the write position: one shared
    scalar for a static batch, or a (B,) vector with ``per_slot_pos``
    (continuous batching)."""
    dev = resolve_device(device)
    kv_dtype = dtype or cfg.cache_dtype or cfg.dtype
    ssm_dtype = dtype or cfg.dtype
    specs = cfg.period_specs()
    shape = (cfg.n_periods, batch, cfg.n_kv_heads, max_len, cfg.head_dim)

    def one_layer(spec: LayerSpec):
        if spec.mixer == "attn":
            return {"kv": {
                "k": torch.zeros(shape, dtype=kv_dtype, device=dev),
                "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}}
        one = S.init_ssm_cache(batch, cfg.ssm_cfg, dtype=ssm_dtype,
                               device=dev)
        return {"ssm": tree_map(
            lambda a: a.new_zeros((cfg.n_periods,) + tuple(a.shape)), one)}

    pos = torch.zeros((batch,) if per_slot_pos else (), dtype=torch.long,
                      device=dev)
    return {"pos": pos,
            "periods": {str(i): one_layer(s) for i, s in enumerate(specs)}}


def logits_fn(params, x, cfg: LMConfig):
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["unembed"]["table"])
    return L.softcap_logits(x @ table.t(), cfg.final_softcap)


def _ffn_block(p, x, cfg: LMConfig, spec: LayerSpec):
    if spec.ffn == "none":
        return x
    h = L.mlp(p["mlp"], _apply_norm(cfg, p["ln2"], x), cfg.mlp_kind)
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn2"], h)
    return x + h


def _decode_layer(p, x, pc, cfg: LMConfig, spec: LayerSpec, pos):
    """One layer of incremental decode; x: (B, S, C).  Writes the layer's
    cache ``pc`` in place and returns (x, pc)."""
    h = _apply_norm(cfg, p["ln1"], x)
    if spec.mixer == "attn":
        cache = {"k": pc["kv"]["k"], "v": pc["kv"]["v"], "pos": pos}
        h, _ = A.attention(p["attn"], h, cfg.attn_cfg(spec.window),
                           causal=True, cache=cache)
    else:
        h, new = S.ssm_decode_step(p["ssm"], h, cfg.ssm_cfg, pc["ssm"])
        tree_map(lambda dst, src: dst.copy_(src), pc["ssm"], new)
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn1"], h)
    return _ffn_block(p, x + h, cfg, spec), pc


def forward_decode(params, tokens, caches, cfg: LMConfig):
    """tokens: (B, S) -> (logits (B, S, V), caches).  ``caches['pos']`` may
    be a scalar (static batch) or a (B,) per-slot vector (continuous
    batching).  The cache tensors are written in place; the returned dict
    holds them with ``pos`` advanced by S."""
    specs = cfg.period_specs()
    pos = caches["pos"]
    x = L.embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale)
    for i in range(cfg.n_periods):
        pp, pcs = _period(params["periods"], i), _period(caches["periods"], i)
        for j, spec in enumerate(specs):
            x, _ = _decode_layer(pp[str(j)], x, pcs[str(j)], cfg, spec, pos)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(params, x, cfg)
    return logits, {"pos": pos + tokens.shape[1],
                    "periods": caches["periods"]}


def forward_prefill(params, tokens, cfg: LMConfig, *,
                    backend: str = "kernel"):
    """Full-sequence prefill: returns (last-position logits (B, 1, V),
    caches with pos = S).  KV cache length == prompt length; SSM layers
    leave their {conv, state} decode cache (``ssm_block(return_cache)``)."""
    specs = cfg.period_specs()
    kv_dtype = cfg.cache_dtype or cfg.dtype
    x = L.embed(params["embed"], tokens, scale_by_sqrt_dim=cfg.embed_scale)
    periods = [{} for _ in specs]
    for i in range(cfg.n_periods):
        pp = _period(params["periods"], i)
        for j, spec in enumerate(specs):
            p = pp[str(j)]
            h = _apply_norm(cfg, p["ln1"], x)
            if spec.mixer == "attn":
                h, (ck, cv) = A.attention_sp(
                    p["attn"], h, cfg.attn_cfg(spec.window), backend=backend,
                    causal=True, return_kv=True)
                pc = {"kv": {"k": ck.to(kv_dtype), "v": cv.to(kv_dtype)}}
            else:
                h, ssm_cache = S.ssm_block(p["ssm"], h, cfg.ssm_cfg,
                                           backend=backend, return_cache=True)
                pc = {"ssm": ssm_cache}
            if not periods[j]:      # stacked leaves, allocated at period 0
                periods[j] = tree_map(
                    lambda a: a.new_empty((cfg.n_periods,) + tuple(a.shape)),
                    pc)
            tree_map(lambda dst, src: dst[i].copy_(src), periods[j], pc)
            if cfg.post_norm:
                h = _apply_norm(cfg, p["pn1"], h)
            x = _ffn_block(p, x + h, cfg, spec)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = logits_fn(params, x[:, -1:], cfg)
    return logits, {"pos": torch.tensor(tokens.shape[1], dtype=torch.long,
                                        device=x.device),
                    "periods": {str(j): pc for j, pc in enumerate(periods)}}
