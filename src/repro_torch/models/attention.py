"""Attention: MHA / GQA / MQA with qk-norm, RoPE, sliding window, logit
soft-capping and KV-cache decode (counterpart of ``repro.models.attention``).

Tensors are (B, S, C) at the block boundary; the kernel path uses
(B, H, S, D).  Prefill goes through ``kernels.ops.flash_attention`` (the
CUDA kernel on the card); decode attends over the cache with plain
PyTorch (``_ref_decode``), as the JAX package does with jnp.
``attention_sp`` with a ``parallel.partition.Sharder`` on a mesh runs the
DSP-1D attention of a sequence-sharded rank (the LM's training path and
its sharded prefill, and the enc-dec model's cross-attention, whose
encoder K/V take a switch of their own).  Sharded decode
(``attention(cache=, sharder=)``)
keeps the KV cache sequence-sharded over ``model``: each rank writes the
step's K/V where its block holds the position, attends its block and
merges its softmax partial with the others' (``_sharded_decode``).

A cache with a ``table`` is the block pool's (``serving.block_pool``):
K/V in fixed-size blocks (n_blocks, Hkv, block, D), each row's positions
mapped onto blocks by its table row (``_paged``).  A decode step attends
the row's gathered blocks in plain PyTorch, as JAX's
``_ref_decode_paged`` does; a prefill chunk of one row on one device goes
through ``kernels.ops.flash_attention`` (K1 on the card) at its start
offset; on a mesh each rank holds a within-block slice of every block and
a chunk merges softmax partials as a decode step does.

Under plan ``tp`` (``Sharder.tp``) the projections are column- and
row-parallel: ``attention_sp`` gathers the rank's sequence shard whole,
runs its heads (K1 at q_offset 0) and reduce-scatters the partial
output of its rows of ``wo`` (``_attention_tp``); a decode step gathers
the step's q/k/v heads, writes and attends the sequence-sharded cache
as under DSP, and sums its rows' partial output with one all-reduce.

Decode writes the new K/V into the cache tensors IN PLACE (the JAX package
returns updated copies): at full width a copy of every layer's cache per
generated token would double the cache traffic.  The returned cache dict
holds the same tensors.  The writes go through uint8 views of the cache
(``core.dsp.as_bytes``), so a float8 cache takes the same indexing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import dsp
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding window (None = full)
    softcap: Optional[float] = None       # attention logit soft-cap (gemma2)
    bias: bool = False
    scale: Optional[float] = None         # override 1/sqrt(head_dim)


def init_attention(gen: torch.Generator, cfg: AttnConfig, *,
                   dtype=torch.float32):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": L.init_linear(gen, d, h * dh, bias=cfg.bias, dtype=dtype),
        "wk": L.init_linear(gen, d, hkv * dh, bias=cfg.bias, dtype=dtype),
        "wv": L.init_linear(gen, d, hkv * dh, bias=cfg.bias, dtype=dtype),
        "wo": L.init_linear(gen, h * dh, d, bias=cfg.bias, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.init_norm(dh, dtype=dtype, device=gen.device)
        p["k_norm"] = L.init_norm(dh, dtype=dtype, device=gen.device)
    return p


def init_kv_cache(batch: int, cfg: AttnConfig, max_len: int, *,
                  dtype=torch.float32, device="cpu"):
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.long, device=device)}


def _project(p, x, src, cfg: AttnConfig):
    b, s, _ = x.shape
    s_kv = src.shape[1]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.linear(p["wq"], x).reshape(b, s, h, dh)
    k = L.linear(p["wk"], src).reshape(b, s_kv, hkv, dh)
    v = L.linear(p["wv"], src).reshape(b, s_kv, hkv, dh)
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        k = L.rms_norm(p["k_norm"], k)
    return q, k, v


def tp_columns(p, sharder):
    """A column-parallel projection as the rank reads it under ``tp``:
    its weight as given (the rank's block of output columns, or the whole
    weight where ``Sharder.whole`` gathered it) and the same block of the
    bias, which the layout keeps whole (``param_pspecs``)."""
    w = p["w"]
    out = {"w": w}
    if "b" in p:
        k = w.shape[1]
        out["b"] = (p["b"] if p["b"].shape[0] == k
                    else p["b"].narrow(0, sharder.sp_index * k, k))
    return out


def tp_rows(p, x, sharder, *, step: bool):
    """A row-parallel projection under ``tp``: x (..., C/n), the rank's
    block of the input, through its rows of the weight into a partial
    output, summed over ``model`` (``step``: a decode step's whole
    tokens, one all-reduce; else the sequence, one reduce-scatter that
    keeps the rank's shard), and the bias, whole, added once after the
    sum."""
    y = x @ p["w"]
    y = sharder.tp_sum(y) if step else sharder.tp_exit(y)
    return y + p["b"] if "b" in p else y


def _tp_project(p, x, cfg: AttnConfig, sharder):
    """q (B, S, H/n, D) of this rank's heads from its columns of ``wq``,
    and k/v (B, S, Hkv/n, D) of its K/V heads from its columns of ``wk``
    and ``wv``, or (``Sharder.kv_whole``, the K/V heads do not divide
    the ranks) every K/V head from the whole ``wk``/``wv``."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    q = L.linear(tp_columns(p["wq"], sharder), x).reshape(b, s, -1, dh)
    k = L.linear(tp_columns(p["wk"], sharder), x).reshape(b, s, -1, dh)
    v = L.linear(tp_columns(p["wv"], sharder), x).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = L.rms_norm(p["q_norm"], q)
        k = L.rms_norm(p["k_norm"], k)
    return q, k, v


def _tp_kv_heads(k, v, cfg: AttnConfig, sharder):
    """The K/V heads (B, S, ., D) that this rank's H/n q heads read: its
    own K/V heads as they are, or under ``kv_whole`` (every K/V head
    computed) the one each of its q heads maps onto, in q head order."""
    if not sharder.kv_whole:
        return k, v
    hq = cfg.n_heads // sharder.sp_size
    g = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(sharder.sp_index * hq, (sharder.sp_index + 1) * hq,
                       device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _tp_gather_heads(q, k, v, sharder):
    """A decode step's q/k/v of the rank's heads (B, S, ., D) -> every
    head on every rank, in head order: one all-gather over ``model`` of
    the three stacked on the head dim (of q alone under ``kv_whole``,
    whose k/v hold every head already)."""
    n = sharder.sp_size
    hq = q.shape[2]
    parts = q if sharder.kv_whole else torch.cat([q, k, v], 2)
    got = dsp.gather(parts[None], 0, sharder.ctx.sp_group)
    # (n, B, S, heads of a rank, D) -> (B, S, n x heads, D) per tensor

    def heads(t):
        return t.permute(1, 2, 0, 3, 4).reshape(
            t.shape[1], t.shape[2], -1, t.shape[-1])
    if sharder.kv_whole:
        return heads(got), k, v
    kh = k.shape[2]
    return (heads(got[:, :, :, :hq]), heads(got[:, :, :, hq:hq + kh]),
            heads(got[:, :, :, hq + kh:]))


def attention(p, x, cfg: AttnConfig, *, causal: bool = True,
              positions: Optional[torch.Tensor] = None,
              x_kv: Optional[torch.Tensor] = None,
              cache: Optional[dict] = None, sharder=None,
              backend: str = "kernel"):
    """x: (B, S, C).  ``x_kv`` switches to cross-attention.  With ``cache``
    given, runs incremental decoding: writes K/V at cache['pos'] (a scalar,
    or a (B,) vector of per-slot positions) and attends to the prefix;
    returns (out, new_cache), else just out.  ``backend`` picks the
    flash-attention path of the no-cache branch and of a paged prefill
    chunk; decode is always plain.

    With ``sharder`` serving sharded (``Sharder.serves_sharded``) the
    cache tensors are this rank's block of the sequence (``kv_block``), x
    is whole on every rank, and one step (S = 1) writes its K/V on the
    rank whose block holds the position and attends through
    ``_sharded_decode``.

    A ``cache['table']`` (B, blocks_per_slot) switches to the block pool's
    layout (``_paged``); ``cache['start']``, a host int, is the first
    position of a prefill chunk of one row (S > 1), which K1 takes as its
    query offset on one device."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    tp = sharder is not None and sharder.tp
    if tp:
        q, k, v = _tp_project(p, x, cfg, sharder)
    else:
        q, k, v = _project(p, x, x if x_kv is None else x_kv, cfg)

    def out(o):
        # o (B, S, H·D), every head -> the block's output: under tp the
        # rank's heads through its rows of wo
        if not tp:
            return L.linear(p["wo"], o)
        n = h * dh // sharder.sp_size
        return tp_rows(p["wo"], o[..., sharder.sp_index * n:
                                  (sharder.sp_index + 1) * n], sharder,
                       step=True)

    if positions is None:
        base = (cache["pos"] if cache is not None
                else torch.zeros((), dtype=torch.long, device=x.device))
        steps = torch.arange(s, device=x.device)
        positions = base[:, None] + steps if base.dim() == 1 else base + steps
    if cfg.rope and x_kv is None:
        q = L.apply_rope(q, positions, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, theta=cfg.rope_theta)

    if cache is not None:
        pos = cache["pos"]
        ck, cv = cache["k"], cache["v"]
        sharded = sharder is not None and sharder.serves_sharded
        if tp:
            q, k, v = _tp_gather_heads(q, k, v, sharder)
        elif sharded:
            q, k, v = (sharder.decode_heads(t) for t in (q, k, v))
        if "table" in cache:
            o = _paged(q, k, v, cache, cfg, causal,
                       sharder if sharded else None, backend)
            o = o.transpose(1, 2).reshape(b, s, h * dh)
            return out(o), {"k": ck, "v": cv, "pos": pos + s,
                            "table": cache["table"]}
        if sharded:
            _sharded_write(ck, cv, k, v, pos, sharder)
            o = _sharded_decode(q.transpose(1, 2), ck, cv, cfg, pos, causal,
                                sharder)
        else:
            steps = torch.arange(s, device=x.device)
            # the write start clamps so the update fits, as jax's
            # dynamic_update_slice does: idle pool slots keep stepping past
            # max_len on garbage that the next insert overwrites
            start = pos.long().clamp(max=ck.shape[2] - s)
            # written as bytes: an fp8 cache has no index_copy_ (and its
            # casts round as JAX's dynamic_update_slice stores them)
            if pos.dim() == 1:
                # per-slot write positions (continuous-batching slot pool):
                # each row appends at its own sequence offset
                rows = torch.arange(b, device=x.device)[:, None]
                cols = start[:, None] + steps
                for c, t in ((ck, k), (cv, v)):    # t is (B, S, Hkv, D)
                    dsp.as_bytes(c)[rows, :, cols] = dsp.as_bytes(
                        t.to(c.dtype))
            else:
                idx = start + steps
                for c, t in ((ck, k), (cv, v)):
                    dsp.as_bytes(c)[:, :, idx] = dsp.as_bytes(
                        t.transpose(1, 2).to(c.dtype))
            o = _ref_decode(q.transpose(1, 2), ck, cv, cfg, pos, causal)
        new_cache = {"k": ck, "v": cv, "pos": pos + s}
        o = o.transpose(1, 2).reshape(b, s, h * dh)
        return out(o), new_cache

    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal and x_kv is None,
                        window=cfg.window, softcap=cfg.softcap,
                        scale=cfg.scale, backend=backend)
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return L.linear(p["wo"], o)


def _sharded_write(ck, cv, k, v, pos, sharder) -> None:
    """Write one step's k/v (B, 1, Hkv, D) into this rank's cache block
    (B, Hkv, L, D) at global position ``pos`` (a scalar or per row),
    clamped to the cache's global length as the one-device write clamps:
    the rank whose block holds the position writes it, the others write
    back what they hold (no host sync on which rank owns it)."""
    b, s = k.shape[:2]
    if s != 1:
        raise NotImplementedError(
            "sharded decode into the slot layout takes one token a step; "
            "prefill chunks on a mesh run in the block pool's layout "
            "(_paged_write)")
    blk = ck.shape[2]
    local = pos.long().clamp(max=blk * sharder.sp_size - 1) - (
        sharder.sp_index * blk)
    own = (local >= 0) & (local < blk)
    idx = local.clamp(0, blk - 1)
    # as bytes, so an fp8 cache takes the same ops
    if pos.dim() == 1:
        rows = torch.arange(b, device=k.device)
        for c, t in ((ck, k), (cv, v)):
            c = dsp.as_bytes(c)
            c[rows, :, idx] = torch.where(own[:, None, None],
                                          dsp.as_bytes(t[:, 0].to(ck.dtype)),
                                          c[rows, :, idx])
    else:
        for c, t in ((ck, k), (cv, v)):
            c = dsp.as_bytes(c)
            c[:, :, idx] = torch.where(own, dsp.as_bytes(
                t[:, 0].to(ck.dtype)), c[:, :, idx])


def _decode_partial(q, k, v, cfg: AttnConfig, pos, causal: bool, k_pos):
    """One block's softmax partial of decode attention, in float32: q (B,
    H, Sq, D), k/v a block (B, Hkv, L, D) of the cache whose columns hold
    the global positions ``k_pos`` (L,), masked by global positions (cols
    <= pos + i, window).  ``pos`` is a scalar (static batch) or a (B,)
    vector (slot pool: each row masks against its own length).  Returns
    (B, Hkv, G, Sq, D + 2): the row max m, the sum l of exp(s - m) over
    the unmasked columns and the unnormalised output o.  A row with every
    column masked gives m = NEG_INF (finite), l = 0 and o = 0."""
    b, h, sq, d = q.shape
    hkv, blk = k.shape[1], k.shape[2]
    g = h // hkv
    scale = cfg.scale if cfg.scale is not None else d ** -0.5
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if cfg.softcap is not None:
        s = cfg.softcap * torch.tanh(s / cfg.softcap)
    per_row = pos.dim() == 1
    steps = torch.arange(sq, device=q.device)
    q_pos = (pos[:, None] if per_row else pos) + steps
    mask = torch.ones(tuple(q_pos.shape) + (blk,), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos <= q_pos[..., None]
    if cfg.window is not None:
        mask &= k_pos > q_pos[..., None] - cfg.window
    if per_row:                               # (B, sq, skv) row-wise mask
        mask = mask[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    return torch.cat([m, e.sum(dim=-1, keepdim=True),
                      torch.einsum("bhgqk,bhkd->bhgqd", e, v.float())], -1)


def _merge_partials(parts, shape, dtype):
    """The decode output from ``_decode_partial``s stacked on dim 0, one a
    block of the sequence: exp(m_r - M)-weighted sums of l and o, o / l,
    reshaped to ``shape`` in ``dtype``.  A block with every column masked
    weighs exactly 0; a row masked everywhere comes out 0, never NaN.  At
    one block the weight is exp(0) = 1, so one device and one rank of a
    mesh compute the same bits."""
    w = torch.exp(parts[..., :1] - parts[..., :1].amax(dim=0))
    l = (w * parts[..., 1:2]).sum(dim=0)
    o = (w * parts[..., 2:]).sum(dim=0) / torch.where(l > 0, l,
                                                       torch.ones_like(l))
    return o.reshape(shape).to(dtype)


def _ref_decode(q, k, v, cfg: AttnConfig, pos, causal: bool):
    """Decode attention with a position offset held in a tensor: q (B, H,
    Sq, D), k/v the whole cache; the softmax of ``_decode_partial`` over
    the one block."""
    part = _decode_partial(q, k, v, cfg, pos, causal,
                           torch.arange(k.shape[2], device=q.device))
    return _merge_partials(part[None], q.shape, q.dtype)


def _sharded_decode(q, k, v, cfg: AttnConfig, pos, causal: bool, sharder):
    """``_ref_decode`` over a sequence-sharded cache: q (B, H, Sq, D) whole
    on every rank, k/v this rank's block (B, Hkv, L, D) of positions
    [r·L, (r+1)·L).  Each rank computes its block's softmax partial, and
    one all-gather over ``model`` of the stacked (m, l, o) gives every
    rank every partial to merge."""
    blk = k.shape[2]
    part = _decode_partial(q, k, v, cfg, pos, causal, sharder.sp_index * blk
                           + torch.arange(blk, device=q.device))
    return _merge_partials(dsp.gather(part[None], 0, sharder.ctx.sp_group),
                           q.shape, q.dtype)


# ---------------------------------------------------------------------------
# The block pool's layout (paged serving)
# ---------------------------------------------------------------------------

def _paged(q, k, v, cache, cfg: AttnConfig, causal: bool, sharder,
           backend: str):
    """Paged attention (JAX's ``table`` branch): q/k/v (B, S, H|Hkv, D) of
    the step, ``cache`` the block pool's row view: ``k``/``v`` (n_blocks,
    Hkv, b_loc, D), ``table`` (B, blocks_per_slot) of block ids, ``pos``
    (B,) and, for a chunk, ``start``.  The step's K/V go into the blocks
    in place (``_paged_write``).  One device, S > 1: a prefill chunk of
    one row, K1 over the row's blocks (``_paged_chunk``).  Otherwise each
    row's blocks are gathered whole, (B, Hkv, blocks_per_slot · b_loc,
    D), and attended in plain PyTorch (``_decode_partial``) with the
    columns at their global positions: n·b + j for table entry n off a
    mesh, n·b + r·b_loc + j on rank r of ``sharder``'s mesh, whose
    partials one all-gather over ``model`` merges (``_sharded_decode``'s
    single call).  Returns (B, H, S, D)."""
    ck, cv, table, pos = cache["k"], cache["v"], cache["table"], cache["pos"]
    sp, r = ((sharder.sp_size, sharder.sp_index) if sharder is not None
             else (1, 0))
    _paged_write(ck, cv, k, v, pos, table, sp, r)
    q = q.transpose(1, 2)
    if q.shape[2] > 1 and sharder is None:
        return _paged_chunk(q, ck, cv, table, cache.get("start"), cfg,
                            causal, backend)
    b, nbs = table.shape
    hkv, b_loc, d = ck.shape[1:]
    blocks = [dsp.as_bytes(c)[table].view(c.dtype).transpose(1, 2).reshape(
        b, hkv, nbs * b_loc, d) for c in (ck, cv)]
    k_pos = (torch.arange(nbs, device=q.device)[:, None] * (b_loc * sp)
             + r * b_loc + torch.arange(b_loc, device=q.device)).reshape(-1)
    part = _decode_partial(q, *blocks, cfg, pos, causal, k_pos)[None]
    if sharder is not None:
        part = dsp.gather(part, 0, sharder.ctx.sp_group)
    return _merge_partials(part, q.shape, q.dtype)


def _paged_write(ck, cv, k, v, pos, table, sp: int, r: int) -> None:
    """Write the step's k/v (B, S, Hkv, D) into the blocks (n_blocks, Hkv,
    b_loc, D) in place: row i's position p at block ``table[i, p // b]``,
    offset p % b, b = b_loc · sp; rank r of ``sp`` holds offsets [r·b_loc,
    (r+1)·b_loc) and writes those.  A position past the row's table (an
    idle lane stepping past max_len) drops its write, as JAX's scatter
    drops the out-of-range index its table read gives; it and a position
    the rank does not hold write back what the garbage block holds there
    (``block_pool.GARBAGE_BLOCK``, 0), so no live block is touched and no
    host sync decides which rank owns a position."""
    b_loc = ck.shape[2]
    nbs = table.shape[1]
    p = pos.long()[:, None] + torch.arange(k.shape[1], device=k.device)
    n = p // (b_loc * sp)
    off = p % (b_loc * sp) - r * b_loc
    ok = (n < nbs) & (off >= 0) & (off < b_loc)
    phys = torch.gather(table, 1, n.clamp(max=nbs - 1))
    phys = torch.where(ok, phys, torch.zeros_like(phys))
    off = off.clamp(0, b_loc - 1)
    for c, t in ((ck, k), (cv, v)):     # as bytes: an fp8 cache too
        dt, c = c.dtype, dsp.as_bytes(c)
        c[phys, :, off] = torch.where(ok[..., None, None],
                                      dsp.as_bytes(t.to(dt)),
                                      c[phys, :, off])


def _paged_chunk(q, ck, cv, table, start, cfg: AttnConfig, causal: bool,
                 backend: str):
    """A prefill chunk of one row on one device: q (1, H, c, D) at global
    positions [start, start + c) against the row's first ceil((start +
    c) / b) blocks gathered into (1, Hkv, start + c, D), through
    ``kernels.ops.flash_attention`` at ``q_offset = start`` (K1 on a CUDA
    tensor, its plain version on the CPU).  ``start`` is a host int, the
    chunk's offset the scheduler holds; JAX attends the chunk through
    ``_ref_decode_paged``, the same function."""
    if q.shape[0] != 1 or start is None:
        raise ValueError(
            f"a paged prefill chunk is one row with its start as a host "
            f"int, got {q.shape[0]} rows, start {start!r}")
    end = start + q.shape[2]
    blocks = table[0, :-(-end // ck.shape[2])]

    def row(c):
        g = dsp.as_bytes(c)[blocks].view(c.dtype).transpose(0, 1).reshape(
            1, c.shape[1], -1, c.shape[3])
        return g[:, :, :end].to(q.dtype)
    return flash_attention(q, row(ck), row(cv), causal=causal,
                           window=cfg.window, softcap=cfg.softcap,
                           scale=cfg.scale, q_offset=start, backend=backend)


def attention_sp(p, x, cfg: AttnConfig, *, sharder=None,
                 backend: str = "kernel", fused_switch: bool = True,
                 causal: bool = True,
                 x_kv: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None,
                 return_kv: bool = False):
    """Attention under DSP-1D sequence parallelism: enter sequence-sharded,
    dynamic-switch to head-sharded for the attention core, switch back.
    x: (B, S, C) -> (B, S, C): on a mesh (``sharder``, a
    ``parallel.partition.Sharder``) the rank's sequence shard, whose q and
    k are rotated at their global positions.

    ``fused_switch`` stacks q/k/v into ONE all-to-all (K/V only, beside q's
    own, under GQA); unfused issues three (the Ulysses schedule).  When the
    K/V heads undershoot the SP size they are repeated up to it first.
    When the q heads do not divide the SP size, q stays sequence-sharded
    and K/V are gathered whole (the ``kv_gather`` layout).  The output
    switches back before ``wo``, whose contraction needs every head (JAX's
    hook sits after ``wo``, where XLA moves it to).  ``return_kv`` also
    returns the decode-cache K/V (B, Hkv, S, D): on a mesh the rank's
    sequence shard, rotated at global positions, taken before the
    switch.

    Cross-attention (``x_kv``, the encoder output (B, S_kv, C): on a mesh
    the rank's shard of its own sequence) projects K/V from ``x_kv``
    with no rope and no causal mask.  On a mesh q takes its own switch
    and the K/V one stacked switch, as JAX's do where the two lengths
    differ (JAX stacks all three where the rank's lengths are equal, and
    so does this), and the core runs over the whole S x S_kv on the
    rank's heads."""
    on_mesh = sharder is not None and sharder.ctx is not None
    if on_mesh and sharder.tp and x_kv is not None:
        raise NotImplementedError(
            "cross-attention under plan 'tp' is not ported (the enc-dec "
            "model's spec runs dsp)")
    if on_mesh and sharder.tp:
        return _attention_tp(p, x, cfg, sharder, backend=backend,
                             causal=causal, return_kv=return_kv)
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project(p, x, x if x_kv is None else x_kv, cfg)
    if cfg.rope and x_kv is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)
            if on_mesh:
                positions = positions + sharder.seq_offset(s)
        q = L.apply_rope(q, positions, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    is_causal = causal and x_kv is None
    if not on_mesh:
        q = q.transpose(1, 2).contiguous()
        k = k.transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()
        o = flash_attention(q, k, v, causal=is_causal, window=cfg.window,
                            softcap=cfg.softcap, scale=cfg.scale,
                            backend=backend)
        o = L.linear(p["wo"], o.transpose(1, 2).reshape(b, s, h * dh))
        if return_kv:
            return o, (k, v)
        return o

    # the rank's sequence shard of the decode cache's K/V, at global
    # positions, before any head repeat or switch
    kv_out = (k.transpose(1, 2), v.transpose(1, 2)) if return_kv else None
    sp = sharder.sp_size
    head_switch = sharder.wants_head_switch(h)
    if head_switch and hkv < sp:
        rep = (sp + hkv - 1) // hkv              # repeat K/V heads up to SP
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        hkv *= rep
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, D)
    if not head_switch:
        q = sharder.q_seq(q)
        kv = sharder.kv_gathered(torch.stack([k, v]))      # ONE all-gather
        o = chunked_attention(q, kv[0], kv[1], cfg, sharder=sharder,
                              layout="kv_gather", causal=is_causal,
                              backend=backend)
        src = "resid"
    else:
        if fused_switch and h == hkv and s == k.shape[2]:
            qkv = sharder.heads_stacked(torch.stack([q, k, v]))   # ONE a2a
            q, k, v = qkv[0], qkv[1], qkv[2]
        elif fused_switch:
            q = sharder.heads_enter(q)
            kv = sharder.heads_stacked(torch.stack([k, v]))
            k, v = kv[0], kv[1]
        else:                                    # Ulysses-style: 3 separate
            q = sharder.heads_enter(q)
            k = sharder.heads_enter(k)
            v = sharder.heads_enter(v)
        o = sharder.heads(chunked_attention(q, k, v, cfg, sharder=sharder,
                                            layout="heads",
                                            causal=is_causal,
                                            backend=backend))
        src = "mixer"
    o = o.transpose(1, 2)
    o = sharder.mixer_exit3(o.reshape(b, o.shape[1], -1), src=src)
    o = L.linear(p["wo"], o)
    return (o, kv_out) if return_kv else o


def _attention_tp(p, x, cfg: AttnConfig, sharder, *, backend: str,
                  causal: bool, return_kv: bool):
    """``attention_sp`` under ``tp`` (Megatron-SP): the rank's sequence
    shard x (B, S/n, C) gathered whole (``Sharder.tp_enter``), q/k/v of
    the rank's heads from its columns (``_tp_project``), rotated at
    global positions 0..S-1, K1 on those heads over the whole sequence
    (q_offset 0), the output through the rank's rows of ``wo`` into a
    partial, and its sum reduce-scattered back onto the rank's shard
    (``tp_rows``).  ``return_kv`` also returns the cache's K/V (B,
    Hkv/n, S, D): the rank's K/V heads over the whole sequence (every
    head under ``kv_whole``), which ``Sharder.kv_cache`` switches onto
    the rank's block of the cache."""
    x = sharder.tp_enter(x)
    b, s, _ = x.shape
    q, k, v = _tp_project(p, x, cfg, sharder)
    if cfg.rope:
        positions = torch.arange(s, device=x.device)
        q = L.apply_rope(q, positions, theta=cfg.rope_theta)
        k = L.apply_rope(k, positions, theta=cfg.rope_theta)
    kv_out = (k.transpose(1, 2), v.transpose(1, 2)) if return_kv else None
    ka, va = _tp_kv_heads(k, v, cfg, sharder)
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        ka.transpose(1, 2).contiguous(),
                        va.transpose(1, 2).contiguous(), causal=causal,
                        window=cfg.window, softcap=cfg.softcap,
                        scale=cfg.scale, backend=backend)
    o = tp_rows(p["wo"], o.transpose(1, 2).reshape(b, s, -1), sharder,
                step=False)
    return (o, kv_out) if return_kv else o


def chunked_attention(q, k, v, cfg: AttnConfig, *, sharder, layout: str,
                      causal: bool, backend: str = "kernel"):
    """The rank's attention core on a mesh, through
    ``kernels.ops.flash_attention`` (K1 on the card), which streams K/V
    itself: JAX's query-chunked scan (``_local_chunked_attn``) keeps XLA's
    score buffer small, which the kernel never materialises.

    layout:
      "heads"     q/k/v (B, H|Hkv, S, D) holding the rank's heads after the
                  switch, the whole sequence: q_offset 0.
      "kv_gather" q (B, H, S/n, D), the rank's queries, against K/V
                  gathered whole: q_offset = the shard's first position
                  (a Python int, so K1 takes it, where JAX's traced offset
                  sends the body to its reference).
    """
    if layout == "heads":
        q_offset = 0
    elif layout == "kv_gather":
        q_offset = sharder.seq_offset(q.shape[2])
    else:
        raise ValueError(layout)
    return flash_attention(q, k, v, causal=causal, window=cfg.window,
                           softcap=cfg.softcap, scale=cfg.scale,
                           q_offset=q_offset, backend=backend)
