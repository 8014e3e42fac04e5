"""Dispatching wrappers around the kernels (counterpart of
``repro.kernels.ops``).

A CPU tensor, or ``backend="ref"``, goes to the kernel's plain PyTorch
version; a CUDA tensor goes to the CUDA kernel, which raises on what it
does not take.  Nothing falls back from the kernel to the plain version.
Both ops are autograd ``Function``s whose backward, as JAX's custom VJPs
do, recomputes through a plain reference on the saved inputs:
``flash_attention`` through ``ref.attention_ref``, ``ssd_scan`` through
``ref.ssd_chunked_ref``.  Neither has a backward kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain

BACKENDS = ("kernel", "ref")
# the most bytes of f32 scores one slice of flash attention's backward
# recompute may hold: (batch slice, Hq, Sq, Skv) x 4 B; autograd keeps a few
# such tensors live at once
BACKWARD_SCORE_BYTES = 2 << 30
# one sequence whose scores pass this recomputes over groups of its K/V
# heads (mistral-large-123b's 96 heads at 4096 tokens hold 6.4 GB)
BACKWARD_HEAD_SCORE_BYTES = 4 << 30


def _use_plain(t: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    return backend == "ref" or t.device.type == "cpu"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    backend: str = "kernel") -> torch.Tensor:
    """Multi-head attention; q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D).

    ``block_q``/``block_k`` keep the JAX signature; they size the TPU
    kernel's tiles, and the CUDA kernel picks its own.
    """
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be >= 1, got {block_q}, {block_k}")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, kw, _use_plain(q, backend))


class _FlashAttention(torch.autograd.Function):
    """Forward as JAX's ``fwd_plain``: the kernel (or its plain version);
    backward through ``attention_ref`` on the saved q, k, v with the same
    mask, softcap, scale and offset, as JAX's custom VJP does.  Sequences
    and K/V heads do not interact, so the backward recomputes over slices
    of the batch dim, each holding at most ``BACKWARD_SCORE_BYTES`` of
    scores (at least one sequence), where one sequence holds more than
    ``BACKWARD_HEAD_SCORE_BYTES`` over groups of its K/V heads with their
    q heads (at least one), and concatenates the grads: the same values
    as one recompute of the whole batch."""

    @staticmethod
    def forward(ctx, q, k, v, kw: dict, plain: bool):
        ctx.kw = kw
        ctx.save_for_backward(q, k, v)
        if plain:
            return flash_attention_plain(q, k, v, **kw)
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), **kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        b, hq, sq, _ = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        grp = hq // hkv
        per_head = 4 * sq * skv
        step = max(1, BACKWARD_SCORE_BYTES // max(hq * per_head, 1))
        kstep = (hkv if hq * per_head <= BACKWARD_HEAD_SCORE_BYTES
                 else max(1, BACKWARD_HEAD_SCORE_BYTES // (grp * per_head)))
        need = ctx.needs_input_grad[:3]
        rows = []
        for i in range(0, b, step):
            cols = []
            for j in range(0, hkv, kstep):
                heads = (slice(j * grp, (j + kstep) * grp),
                         slice(j, j + kstep), slice(j, j + kstep))
                inputs = [t[i:i + step, h].detach().requires_grad_(n)
                          for t, h, n in zip((q, k, v), heads, need)]
                with torch.enable_grad():
                    o = _ref.attention_ref(*inputs, **ctx.kw)
                cols.append(torch.autograd.grad(
                    o, [t for t in inputs if t.requires_grad],
                    g[i:i + step, heads[0]]))
            rows.append([c[0] if len(c) == 1 else torch.cat(c, 1)
                         for c in zip(*cols)])
        grads = iter(zip(*rows))         # each needed grad's batch slices
        out = []
        for n in need:
            gs = next(grads) if n else None
            out.append(gs if gs is None else
                       gs[0] if len(gs) == 1 else torch.cat(gs))
        return tuple(out) + (None, None)


class _SSDScan(torch.autograd.Function):
    """Forward as JAX's ``fwd_plain``: the kernel (or its plain version) in
    the kernel layout; backward through ``ssd_chunked_ref`` on the saved
    inputs, as JAX's custom VJP does."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk: int, plain: bool):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b, c, d_skip)
        # kernel layout (B, H, L, P) / (B, H, L) / (B, G, L, S) as views of
        # the model's (B, L, ...) tensors: the sm90 kernel reads them through
        # their strides, the others copy what they need
        xdt = (x * dt[..., None]).transpose(1, 2)
        da = (dt * a[None, None, :]).transpose(1, 2)               # f32
        scan = ssd_scan_plain if plain else ssd_scan_fwd
        y = scan(xdt, da, b.transpose(1, 2), c.transpose(1, 2),
                 chunk=chunk).transpose(1, 2)
        if d_skip is not None:
            y = y + d_skip[None, None, :, None] * x
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors,
                                     ctx.needs_input_grad)]
        with torch.enable_grad():
            y = _ref.ssd_chunked_ref(*inputs[:5], d_skip=inputs[5],
                                     chunk=ctx.chunk)
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(y, wrt, g))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs) + (None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             d_skip: Optional[torch.Tensor] = None, *, chunk: int = 128,
             backend: str = "kernel") -> torch.Tensor:
    """Mamba-2 SSD.  x: (B, L, H, P), dt: (B, L, H), a: (H,),
    b/c: (B, L, G, S), d_skip: (H,).  Returns y: (B, L, H, P) in x's
    dtype.  L need not be a multiple of ``chunk``: the last chunk is short
    (the JAX wrapper's zero padding, which the kernel does by masking)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    return _SSDScan.apply(x, dt, a, b, c, d_skip, chunk,
                          _use_plain(x, backend))
