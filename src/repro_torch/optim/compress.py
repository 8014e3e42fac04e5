"""Error-feedback int8 gradient compression (counterpart of
``repro.optim.compress``).

Per-leaf symmetric int8 quantisation with an error-feedback residual: the
quantisation error of step t is added back to the gradient at step t+1,
so the scheme is unbiased in the long run (the 1-bit-Adam / EF-SGD
family).  As in JAX, the trainer applies it to the gradients already
summed over the mesh (``train.trainer.allreduce_grads``) and the values
are quantised and dequantised in place: the bytes on the wire are not
compressed.

Under a parameter layout (``parallel.partition.param_pspecs``) a rank
holds a slice of a leaf, so the per-tensor scale is the whole leaf's:
the slices' |x| maxima are all-reduced (MAX) over the ranks that split
the leaf, one bucket per set of mesh dims, and the 4096-element
pass-through tests the whole leaf's size.  The result is then the whole
leaf's compression, sliced.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.distributed as dist

from repro_torch.core import dsp
from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.parallel.partition import global_shape, split_axes

# leaves smaller than this pass through uncompressed (headers would
# dominate)
MIN_ELEMENTS = 4096


def quantize_int8(x: torch.Tensor, amax=None):
    """Symmetric per-tensor int8 of f32 ``x``.  Returns (q, scale).
    ``amax`` is the tensor's max |x| when ``x`` is a slice of it (default:
    ``x``'s own)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = (amax + 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_residuals(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def _whole_amax(targets: Dict[int, torch.Tensor], specs, ctx) -> Dict:
    """Each target's (by leaf index) whole-leaf max |x|: its own,
    all-reduced (MAX) over the dims its leaf is split over, one f32
    bucket per set of dims."""
    amax = {i: torch.max(torch.abs(t)) for i, t in targets.items()}
    if specs is None:
        return amax
    names = ctx.mesh.mesh_dim_names
    groups: Dict[tuple, list] = {}
    for i, spec in enumerate(tree_leaves(specs)):
        axes = split_axes(spec, names)
        if axes and i in amax:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        bucket = torch.stack([amax[i] for i in idx])
        dsp.all_reduce(bucket, ctx.axes_group(axes), op=dist.ReduceOp.MAX)
        amax.update(zip(idx, bucket))
    return amax


def compress_with_feedback(grads, residuals, *, specs=None, ctx=None):
    """Returns (dequantised grads in their dtypes, new residuals).
    Leaves of fewer than ``MIN_ELEMENTS`` elements (whole) pass through
    uncompressed.  ``specs`` and ``ctx``: the layout of this rank's
    slices (``param_pspecs`` of the global tree on ``ctx``'s mesh), each
    slice compressed with its whole leaf's scale."""
    flat_g, flat_r = tree_leaves(grads), tree_leaves(residuals)
    flat_s = (tree_leaves(specs) if specs is not None
              else [None] * len(flat_g))
    targets = {i: g.float() + r
               for i, (g, r, spec) in enumerate(zip(flat_g, flat_r, flat_s))
               if math.prod(global_shape(g.shape, spec, ctx)) >= MIN_ELEMENTS}
    amax = _whole_amax(targets, specs, ctx)
    out_g, out_r = [], []
    for i, g in enumerate(flat_g):
        if i not in targets:
            out_g.append(g.float())
            out_r.append(torch.zeros_like(out_g[-1]))
            continue
        q, scale = quantize_int8(targets[i], amax[i])
        out_g.append(dequantize_int8(q, scale).to(g.dtype))
        # the residual rounds once, as XLA's fused multiply-subtract in
        # JAX's jitted step does: q * scale is exact in f64, and so is the
        # difference (|target - q * scale| <= scale / 2)
        out_r.append((targets[i].double()
                      - q.double() * scale.double()).float())
    it_g, it_r = iter(out_g), iter(out_r)
    return (tree_map(lambda _: next(it_g), grads),
            tree_map(lambda _: next(it_r), grads))


def compressed_bytes(grads) -> int:
    """Wire bytes if every eligible leaf (whole) shipped int8 (vs its
    dtype's)."""
    return sum(g.numel() * (1 if g.numel() >= MIN_ELEMENTS
                            else g.element_size())
               for g in tree_leaves(grads))
