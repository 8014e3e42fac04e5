"""Activation layouts of the LM family under DSP (counterpart of
``repro.parallel.partition``): the parallel plan and the ``Sharder``.

The model calls semantic hooks at its stage boundaries (``act3``,
``heads_stacked``, ``mixer3``, ...) and stays mesh-agnostic; which dim
each stage class shards comes from the planned switching schedule
(``models.lm.dsp_schedule``), as in JAX.  Layouts are logical dims of the
model's (B, S, H·Dh) stage view: 1 is the sequence, 2 the flattened
head/channel axis, None the whole tensor.  Residual/channel stages
("resid") shard the sequence; the mixer cores ("mixer": the attention
softmax, the SSD scan) shard heads or channels.

In JAX each hook is a sharding constraint and XLA finds the source
layout.  Here each hook states the class layout its tensor leaves and the
one it enters, and issues one ``core.dsp`` primitive over the ``model``
group of a ``core.layout.ParallelContext``, or nothing: a keep where both
are the same class, ``dynamic_switch`` (one all-to-all) from resid to
mixer and back, ``gather`` (one all-gather, reduce-scattered backward)
from resid to whole.  Each primitive's backward is its transpose, so the
backward retraces the plan mirrored.  Where JAX calls one hook from two
layouts (``mixer3`` enters the scan and keeps inside it, ``mixer_exit3``
leaves a mixer and keeps at a layer exit) the caller passes ``src``.
Without a context every hook is the identity.

``seq_halo`` has no JAX hook: XLA adds the causal conv's halo itself, and
here it is one permute of the previous rank's last rows.

Parameters are laid out by JAX's rules: ``param_pspecs`` gives each leaf
a spec, one entry per dim (an axis name, a tuple of names flattened with
the first major, or None).  Under ``zero`` (DSP mode) a weight is split
over ``("data", "model")`` flattened, data-major, as JAX's
``P(("data", "model"))`` is; under ``shard_vocab`` the embedding tables
are split over ``model`` by vocab row.  ``shard_params`` keeps each rank's
slice, ``gather_params`` (differentiable: one all-gather forward, one
float32 reduce-scatter backward) gives the model whole leaves where it
reads them (``whole_params``: a subtree, or one entry of a stacked one,
as the LM's ``Sharder.whole`` and the 2D DiT's groups of block pairs
read it), ``unshard_params`` gathers for checks, ``param_copies`` and
``reduce_axes`` tell the trainer how many ranks hold each leaf and over
which dims its grad is still to be summed, and ``store_contract`` counts
the calls and bytes the store adds to a training step.  Leaves under a
stacked subtree (``STACKED``: the LM's and DiT's, and the enc-dec model's
``enc_periods`` and ``dec_periods``, which JAX passes as
``stacked_prefixes``; no tree holds keys of both) carry a leading period
dim that no spec splits.  ``make_sharder`` raises
``NotImplementedError`` for what it does not run yet, naming the ROADMAP
item (queue 1) that brings it.  JAX's inference ``tp_flat`` rules come
with their item; its ``ffn_hidden``, which no JAX model calls, has no
counterpart.

Plan ``tp`` (Megatron-SP) keeps the residual stream split by sequence
over ``model`` and runs each attention and MLP block tensor-parallel:
``tp_enter`` gathers the whole sequence (one all-gather), the rank's
columns of ``wq``/``wk``/``wv``/``wi``/``wg`` give its heads and hidden
units, its rows of ``wo`` a partial output, and ``tp_exit`` sums the
partials and keeps the rank's shard (one reduce-scatter); a decode step,
whole on every rank, sums with one all-reduce (``tp_sum``).  Its
parameters are laid out by ``param_pspecs``' ``tp`` rules (a column or
row leaf split over ``model``, ZeRO over ``data``), and ``whole`` keeps
the ``model`` split (``read_specs``), except ``wk``/``wv`` where the K/V
heads do not divide the ranks (``Sharder.kv_whole``).  It takes no
switching schedule.

MoE runs under DSP and ``tp``, with ``ep`` or without:
``Sharder.moe_experts`` (JAX's hook of that name) places the rank's
tokens and experts for ``models.moe.moe_gather``, which exchanges the
expert counts, and under ``ep`` dispatches and combines with
``core.dsp.exchange``.  Under ``ep`` an expert leaf is split over
``model`` by expert (``param_pspecs``), and the rank runs its own
experts; under ``tp`` without ``ep`` by hidden column, and the rank runs
its columns of every expert on the block's gathered sequence.
``Sharder.whole`` gathers only an expert leaf's other splits
(``read_specs``).  A serving step holds its tokens whole on every model
rank (``moe_experts(step=True)``): each rank routes them all.

Serving lays its caches out by JAX's ``cache_pspecs`` (the KV sequence in
contiguous blocks over ``model``, the SSM state by head).  The decode
hooks are ``decode_heads`` (a keep: the step's q/k/v are whole on every
rank) and ``kv_cache`` (the prefill's re-cut onto the cache's blocks,
one all-gather); ``seq_rows`` gives every rank some rows of the
sequence-sharded stream (one all-reduce), and ``reshard`` moves a tree
between meshes for the elastic resize.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import dsp
from repro_torch.core.layout import ExpertPlace, ParallelContext, from_mesh


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """How the ``model`` axis is used for one architecture."""

    mode: str = "dsp"            # "dsp" | "tp" | "none"
    ep: bool = False             # expert-parallel MoE over the model axis
    zero: bool = True            # FSDP params over the data axis
    shard_vocab: bool = True     # embedding table vocab dim over model axis


MODES = ("dsp", "tp", "none")

# tensor dim of each logical dim (1 = sequence, 2 = heads/channels) in the
# views the hooks take: (B, S, C), (B, H, S, D), and stacked (k, B, H, S, D)
_VIEWS: Dict[str, Dict[int, int]] = {"bsc": {1: 1, 2: 2},
                                     "bhsd": {1: 2, 2: 1},
                                     "kbhsd": {1: 3, 2: 2}}


# ---------------------------------------------------------------------------
# Parameter specs (JAX's ``param_pspecs`` rules, as tuples)
# ---------------------------------------------------------------------------

# one spec entry per tensor dim: a mesh axis name, a tuple of names (the
# axes flattened, the first major), or None (the dim whole)
Spec = Tuple[Any, ...]


def tree_map_with_path(fn, *trees, path: Tuple[str, ...] = ()):
    """``fn(path, *leaves)`` leafwise over nested dicts of the same
    structure (``path`` the keys to the leaf)."""
    if isinstance(trees[0], dict):
        return {k: tree_map_with_path(fn, *(t[k] for t in trees),
                                      path=path + (k,))
                for k in trees[0]}
    return fn(path, *trees)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _axes_size(entry, axis_sizes: dict) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= axis_sizes.get(a, 1)
        return n
    return axis_sizes.get(entry, 1)


def _guard(spec, shape, axis_sizes: dict) -> Spec:
    """Drop (not pad) any entry whose dim its axes do not divide: the leaf
    stays whole along it (mamba2's 50280-row table at 16, the conv's 4
    taps), as JAX's jit shardings require."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is not None and dim % _axes_size(entry, axis_sizes):
            entry = None
        out.append(entry)
    return tuple(out)


def _leaf_spec(path: str, shape, plan: ParallelPlan, fsdp,
               axis_sizes: dict) -> Spec:
    """Base spec of an *unstacked* leaf of ``shape`` (None: not an array);
    stacking prepends None.  ``fsdp`` is the ZeRO entry: "data" in TP mode
    (the model axis already holds the TP shard) or ("data", "model") in
    DSP mode (weights are not model-sharded, so ZeRO flattens both axes:
    full-pod ZeRO-3)."""
    if path.endswith("meta") or shape is None:
        return ()
    nd = len(shape)
    tp = plan.mode == "tp"

    def g(*entries):
        return _guard(entries, shape, axis_sizes)

    # embeddings: vocab over model ONLY (sharding d over data would make
    # every xent chunk re-gather the table)
    if "table" in path:
        if plan.shard_vocab:
            return g("model", None)
        return g(fsdp, None)

    # MoE stacked experts (E, d, f) / (E, f, d)
    if is_expert_leaf(path, nd):
        if plan.ep and tp and not plan.zero:
            return (g("model", None, "data") if not path.endswith("wo")
                    else g("model", "data", None))
        if plan.ep:
            return g("model", "data" if plan.zero else None, None)
        if tp:
            return (g(None, "data" if plan.zero else None, "model")
                    if not path.endswith("wo")
                    else g(None, "model", "data" if plan.zero else None))
        return g(None, fsdp, None)

    # SSM params: never model-sharded in training (DSP switches the
    # activations), ZeRO on whichever dim divides; TP channel-shards the
    # projections
    if "/ssm/" in path or path.startswith("ssm/"):
        if tp and path.endswith("in_proj/w"):
            return g(fsdp, "model")
        if tp and path.endswith("out_proj/w"):
            return g("model", fsdp)
        if nd >= 2:
            first = g(fsdp, *([None] * (nd - 1)))
            if first[:1] != (None,):
                return first
            return g(None, fsdp, *([None] * (nd - 2)))
        return (None,)

    # dense projections
    col = any(f"{n}/w" in path for n in ("wq", "wk", "wv", "wi", "wg"))
    row = "wo/w" in path or path.endswith("out_proj/w")
    if nd == 2 and (col or row) and tp:
        return (g("model", "data" if plan.zero else None) if row
                else g("data" if plan.zero else None, "model"))
    if nd == 2:
        first = g(fsdp, None)
        if first[:1] != (None,):
            return first
        return g(None, fsdp)
    if nd == 1:
        if tp and col and path.endswith("/b"):
            return g("model")
        return (None,)
    return (None,) * nd


# subtrees whose leaves carry a leading period (scan) dim: JAX's default
# ``stacked_prefixes`` and the enc-dec model's
STACKED = ("layers", "periods", "enc_periods", "dec_periods")


def _stacked(path: str) -> bool:
    """Whether the "/"-joined ``path`` lies under a ``STACKED`` subtree."""
    return any(path.startswith(s + "/") or f"/{s}/" in path
               for s in STACKED)


def is_expert_leaf(path: str, ndim: int) -> bool:
    """Whether the unstacked leaf at ``path`` ("/"-joined keys) of
    ``ndim`` dims is a MoE layer's stacked experts (E, d, f) / (E, f,
    d)."""
    return ndim == 3 and any(path.endswith(s) for s in ("wi", "wg", "wo"))


def is_tp_leaf(path: str, ndim: int) -> bool:
    """Whether the unstacked leaf at ``path`` of ``ndim`` dims is a dense
    weight that ``tp`` splits over ``model`` (``param_pspecs``): a
    column-parallel projection's (``wq``, ``wk``, ``wv``, ``wi``, ``wg``)
    by output column, or a row-parallel one's (``wo``) by input row.
    Biases stay whole, as in JAX's rules: the rank reads its columns of a
    column bias and adds a row bias once, after the sum."""
    if "/ssm/" in path or path.startswith("ssm/"):
        return False
    return ndim == 2 and any(f"{n}/w" in path for n in
                             ("wq", "wk", "wv", "wi", "wg", "wo"))


def read_specs(specs, plan: ParallelPlan, path: Tuple[str, ...] = (), *,
               kv_whole: bool = False):
    """``specs`` (the ``param_pspecs`` subtree at ``path``) as the model
    reads the leaves, gathered over every entry but the ones that stay the
    rank's: under ``ep`` an expert leaf's ``model`` split (the rank runs
    its own experts); under ``tp`` an expert leaf's too (without ``ep``
    the rank runs its hidden columns of every expert) and a dense column
    or row leaf's (``is_tp_leaf``: the rank runs its heads and its hidden
    columns), unless ``kv_whole`` and the leaf is ``wk``/``wv``: K/V
    heads that the ranks' column blocks cut (``n_kv_heads % n != 0``) are
    read whole.  Only the ``data`` (ZeRO)
    split is gathered otherwise.  ``specs`` itself under other plans."""
    if specs is None or not (plan.ep or plan.mode == "tp"):
        return specs

    def one(path, spec):
        p = _path_str(path)
        nd = len(spec) - _stacked(p)
        tp = plan.mode == "tp"
        local = ((plan.ep or tp) and is_expert_leaf(p, nd)) or (
            tp and is_tp_leaf(p, nd)
            and not (kv_whole and any(f"/{n}/" in f"/{p}"
                                      for n in ("wk", "wv"))))
        if not local:
            return spec
        return tuple(None if e == "model" else e for e in spec)
    return tree_map_with_path(one, specs, path=tuple(path))


def param_pspecs(params, plan: ParallelPlan, *,
                 axis_sizes: Optional[dict] = None):
    """The spec tree of ``params`` (nested dicts; leaves with a ``shape``,
    meta tensors included, at their GLOBAL shapes), by JAX's rules
    (``repro.parallel.partition.param_pspecs``).  Leaves under a
    ``STACKED`` subtree carry a leading period dim; their base spec gets a
    None prepended.  ``axis_sizes`` ({"data": 16, "model": 16}, the default:
    the production pod) drives the divisibility guard."""
    axis_sizes = axis_sizes or {"data": 16, "model": 16}
    if not plan.zero:
        fsdp = None
    elif plan.mode == "tp":
        fsdp = "data"
    else:
        fsdp = ("data", "model")     # ZeRO over the full pod in DSP mode

    def rule(path, leaf):
        s = _path_str(path)
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if _stacked(s):
            return (None,) + _leaf_spec(s, shape[1:], plan, fsdp, axis_sizes)
        return _leaf_spec(s, shape, plan, fsdp, axis_sizes)

    return tree_map_with_path(rule, params)


# ---------------------------------------------------------------------------
# The parameter store: each rank's slices, gathered where they are read
# ---------------------------------------------------------------------------

def mesh_sizes(ctx: ParallelContext) -> Dict[str, int]:
    """{dim name: size} of ``ctx``'s mesh: ``param_pspecs``'
    ``axis_sizes``."""
    return {a: ctx.size(a) for a in ctx.mesh.mesh_dim_names}


def entry_axes(entry, names) -> Tuple[str, ...]:
    """The dims among ``names`` (a mesh's) that a spec entry names: a dim
    the mesh lacks has size 1, as in ``_axes_size``."""
    axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return tuple(a for a in axes if a in names)


def split_axes(spec: Spec, names) -> Tuple[str, ...]:
    """The dims among ``names`` (a mesh's, in its order) a leaf of
    ``spec`` is split over."""
    used = {a for e in (spec or ()) for a in entry_axes(e, names)}
    return tuple(a for a in names if a in used)


def _cuts(spec: Spec, ctx: Optional[ParallelContext], ndim: int):
    """Per dim, (n, i): ``spec`` on ``ctx``'s mesh cuts the dim into n
    equal slices and this rank holds slice i (chunk ``ctx.axes_index`` of
    the axes the dim's entry names); (1, 0) throughout without a mesh."""
    if ctx is None:
        return [(1, 0)] * ndim
    entries = tuple(spec or ()) + (None,) * ndim
    out = []
    for d in range(ndim):
        axes = entry_axes(entries[d], ctx.mesh.mesh_dim_names)
        out.append(ctx.axes_index(axes) if axes else (1, 0))
    return out


def global_shape(shape, spec: Spec, ctx: Optional[ParallelContext]):
    """The whole leaf's shape, from this rank's slice's ``shape`` cut by
    ``spec`` on ``ctx``."""
    return tuple(int(s) * n for s, (n, _) in
                 zip(shape, _cuts(spec, ctx, len(shape))))


def slice_index(gshape, spec: Spec, ctx: Optional[ParallelContext]):
    """This rank's (start, stop) per dim of a leaf of global ``gshape``
    cut by ``spec`` on ``ctx``: the slice ``shard_params`` keeps."""
    index = []
    for d, (size, (n, i)) in enumerate(zip(gshape, _cuts(spec, ctx,
                                                         len(gshape)))):
        if size % n:
            raise ValueError(f"dim {d} of {tuple(gshape)} does not split "
                             f"{n} ways")
        index.append((i * size // n, (i + 1) * size // n))
    return tuple(index)


def shard_params(params, specs, ctx: ParallelContext):
    """Each rank's slice of each leaf of ``params`` (whole, every rank
    alike) per its spec (``slice_index``).  A slice that is not the whole
    leaf is copied, so that the whole tree can be freed."""
    def one(_, p, spec):
        out = p[tuple(slice(a, b) for a, b in slice_index(p.shape, spec,
                                                          ctx))]
        if out.numel() == p.numel():
            return p
        return out.clone(memory_format=torch.contiguous_format)
    return tree_map_with_path(one, params, specs)


def gather_params(params, specs, ctx: ParallelContext):
    """The whole leaves of a subtree of shards: along each dim its spec
    names, one all-gather over that entry's group (``ctx.axes_group``;
    issued at one rank too), whose backward reduce-scatters the gradient
    summed in float32 (``core.dsp.gather_param``).  Leaves whose spec
    names no mesh dim come back as they are.  A leaf gathered along a dim
    past its first (a ``tp`` row leaf over ``data``) comes back in the
    whole leaf's layout, not as the gather's transposed view: a matmul
    reads the weight as the unsharded model reads it, bit for bit."""
    def one(_, p, spec):
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry, ctx.mesh.mesh_dim_names)
            if axes:
                p = dsp.gather_param(p, dim, ctx.axes_group(axes))
        return p.contiguous() if isinstance(p, torch.Tensor) else p
    return tree_map_with_path(one, params, specs)


def whole_params(tree, specs, ctx: Optional[ParallelContext], *,
                 stacked: bool = False):
    """``tree``, a subtree of the parameters, with every leaf its spec
    (``specs``, the same subtree of ``param_pspecs``) splits gathered
    whole (``gather_params``), where the model reads it; ``tree`` itself
    without a mesh or specs.  ``stacked``: ``tree`` is one entry of a
    subtree stacked on a leading dim (a period, a block pair), so the
    specs drop their leading entry."""
    if ctx is None or specs is None:
        return tree
    if stacked:
        specs = tree_map_with_path(lambda _, s: s[1:], specs)
    return gather_params(tree, specs, ctx)


@torch.no_grad()
def unshard_params(params, specs, ctx: ParallelContext):
    """``gather_params`` without autograd: the whole tree (or one leaf)
    from every rank's shards (counted by ``core.dsp`` like any call), for
    checks and for ``Trainer.replan``, which gathers one leaf at a
    time."""
    return gather_params(params, specs, ctx)


def reduce_axes(spec: Spec, names) -> Tuple[str, ...]:
    """The dims among ``names`` (a mesh's, in its order) a leaf of
    ``spec`` is NOT split over: its gradient, partial on each rank, is
    still to be summed over them (a ZeRO leaf's reduce-scatter already
    summed over the dims it names)."""
    used = {a for e in spec for a in entry_axes(e, names)}
    return tuple(a for a in names if a not in used)


def param_copies(specs, ctx: ParallelContext):
    """For each leaf, how many ranks hold a copy of each of its slices:
    the product of the sizes of ``reduce_axes``."""
    def one(_, spec):
        n = 1
        for a in reduce_axes(spec, ctx.mesh.mesh_dim_names):
            n *= ctx.size(a)
        return n
    return tree_map_with_path(one, specs)


def gathered_numels(shape, spec: Spec, sizes: Dict[str, int]) -> List[int]:
    """The elements each all-gather of ``gather_params`` returns, in turn,
    for a leaf of global ``shape`` split by ``spec`` on a mesh of
    ``sizes``: one per entry naming a mesh dim (a dim of size 1 too),
    each growing its dim from the slice to the whole."""
    def split(entry):
        return math.prod(sizes[a] for a in entry_axes(entry, sizes))
    shape = [d // split(e) for d, e in zip(shape, spec)]
    out = []
    for dim, entry in enumerate(spec):
        if entry_axes(entry, sizes):
            shape[dim] *= split(entry)
            out.append(math.prod(shape))
    return out


def read_numels(shape, spec: Spec, read: Spec,
                sizes: Dict[str, int]) -> List[int]:
    """``gathered_numels`` of a leaf of global ``shape`` laid out by
    ``spec`` and read by ``read`` (``read_specs``): the splits the read
    keeps stay the rank's, so each all-gather returns that much less."""
    shape = tuple(d * _axes_size(r, sizes) // _axes_size(e, sizes)
                  for d, e, r in zip(shape, spec, read))
    return gathered_numels(shape, read, sizes)


def store_contract(params, specs, sizes: Dict[str, int],
                   reads: Callable[[Tuple[str, ...]], Tuple[int, int]],
                   read_specs=None) -> Dict[str, Dict[str, int]]:
    """The ``torch.distributed`` calls and bytes, by kind (``core.dsp``'s
    rule), that the parameter store adds per rank to one training step on
    a mesh of ``sizes`` (``mesh_sizes``).  ``params`` is the GLOBAL tree
    (meta tensors will do) and ``specs`` its ``param_pspecs``:

      each leaf a spec splits, as often as ``reads(path)`` = (all-gathers,
        reduce-scatters) says: each all-gather of the whole leaf in its
        dtype (``gather_params``), each reduce-scatter of its float32
        gradient; a leaf under ``STACKED`` that often per entry of its
        leading dim, at the entry's shape;
      the trainer: one all-reduce of one float32 bucket per set of
        ``reduce_axes`` of the leaves, the loss in the world's
        (``train.trainer.allreduce_grads``), and one of the clip's scalar
        (``train.trainer.slices_norm``).

    ``read_specs`` (default ``specs``) are the specs the leaves are
    gathered by where they are read (the function ``read_specs``).  An
    entry naming
    only dims of size 1 is still issued (at one rank each is a copy)."""
    calls: Dict[str, int] = {}
    nbytes: Dict[str, int] = {}
    buckets: Dict[tuple, int] = {}
    world = tuple(sizes)

    def add(kind, size, times=1):
        calls[kind] = calls.get(kind, 0) + times
        nbytes[kind] = nbytes.get(kind, 0) + size * times

    def count(path, p, spec, read):
        all_gathers, reduce_scatters = reads(path)
        shape, entries, kept, times = tuple(p.shape), read, spec, 1
        if path[0] in STACKED:
            shape, entries, kept, times = (shape[1:], read[1:], spec[1:],
                                           shape[0])
        for numel in read_numels(shape, kept, entries, sizes):
            add("all-gather", numel * p.element_size(), all_gathers * times)
            add("reduce-scatter", numel * 4, reduce_scatters * times)
        key = reduce_axes(spec, world)
        if key:
            buckets[key] = buckets.get(key, 0) + p.numel() // math.prod(
                math.prod(sizes[a] for a in entry_axes(e, sizes))
                for e in spec)

    tree_map_with_path(count, params, specs,
                       specs if read_specs is None else read_specs)
    buckets[world] = buckets.get(world, 0) + 1          # the loss
    for elems in buckets.values():
        add("all-reduce", 2 * 4 * elems)
    add("all-reduce", 2 * 4)                            # the clip's norm
    return {"calls": calls, "bytes": nbytes}


@torch.no_grad()
def reshard(tree, old_specs, old_ctx: Optional[ParallelContext], new_specs,
            new_ctx: Optional[ParallelContext], *, leaving: bool = False):
    """``tree`` moved from one layout to another, one leaf at a time: each
    leaf gathered whole from its old slices (``unshard_params``: one
    all-gather per split entry, over the old mesh's groups), cut to this
    rank's new slice (``shard_params``) and the whole leaf dropped, so a
    rank holds its old and new slices and one whole leaf at most.  A spec
    tree of None (or a None leaf) means whole; leaves that are not tensors
    pass as they are.  ``leaving`` (a rank the new mesh drops): the rank
    takes part in every gather and keeps nothing (None leaves).  Shared by
    ``Trainer.replan``, ``ServingEngine.replan`` and ``KVPool.migrate``."""
    def spec_of(specs, path):
        if specs is None:
            return None
        for k in path:
            specs = specs[k]
        return specs

    def move(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None if leaving else leaf
        old = spec_of(old_specs, path)
        if old is not None and old_ctx is not None:
            leaf = unshard_params(leaf, old, old_ctx)
        if leaving:
            return None
        new = spec_of(new_specs, path)
        if new is None or new_ctx is None:
            return leaf
        return shard_params(leaf, new, new_ctx)
    return tree_map_with_path(move, tree)


# ---------------------------------------------------------------------------
# The decode cache and the slot pool (JAX's ``cache_pspecs``)
#
# The serving stack stores KV and SSM state stacked per period.  Under DSP
# the KV *sequence* dim is split over ``model`` in contiguous blocks (rank r
# holds positions [r·M/n, (r+1)·M/n) of a cache of M positions), so every
# slot holds the same share of its history on every rank and slots come and
# go with no resharding; the SSM state is split by head; ``conv`` and
# ``pos`` are whole.  The slot (batch) dim is split over ``data``.
#
# The block pool (``serving.block_pool``) holds KV as (periods, blocks, Hkv,
# block_size, D): the within-block sequence dim is split over ``model`` the
# same way (rank r holds offsets [r·b/n, (r+1)·b/n) of every block), and the
# block dim is whole, so a block id names the same slice on every rank and
# alloc, free and share are host bookkeeping.
# ---------------------------------------------------------------------------

KV_SEQ_DIM = 3          # (periods, slots, Hkv, S, D): the sequence axis
SLOT_DIM = 1            # (periods, slots, ...): the slot/batch axis
BLOCK_DIM = 1           # (periods, blocks, Hkv, block, D): the paged block
                        # axis, never split (blocks are scattered per
                        # request by a host-side table)


def is_kv_leaf(path, leaf) -> bool:
    """Whether a cache leaf at key path ``path`` is a stacked KV tensor;
    SSM ``conv`` and ``state`` leaves are not.  The one definition shared
    by ``cache_pspecs``, the layout check and the engine's re-cut."""
    return (("k" in path or "v" in path)
            and getattr(leaf, "ndim", 0) == KV_SEQ_DIM + 2)


def cache_pspecs(caches, plan: ParallelPlan, *, paged: bool = False):
    """The spec tree of a cache or slot-pool tree (JAX's rules): KV
    (periods, slots, Hkv, S, D) split over ``model`` on the sequence
    under ``dsp``/``tp``, the SSM ``state`` (periods, slots, H, P, S) over
    ``model`` by head, ``conv`` whole; the slot dim over ``data``; ``pos``
    (a scalar or the pool's per-slot vector) whole.  ``paged``: the block
    pool's KV (periods, blocks, Hkv, block_size, D), the within-block
    sequence over ``model`` and the block dim (``BLOCK_DIM``) never split;
    its ``table`` and ``pos`` whole."""
    seq = "model" if plan.mode in ("dsp", "tp") else None

    def rule(path, leaf):
        if "k" in path or "v" in path:
            return (None, None if paged else "data", None, seq, None)
        if "state" in path:
            return (None, "data", seq, None, None)
        if "conv" in path:
            return (None, "data", None, None)
        return ()
    return tree_map_with_path(rule, caches)


def kv_block(ctx: Optional[ParallelContext], plan: ParallelPlan,
             seq_len: int) -> Tuple[int, int]:
    """(start, stop): the positions of a ``seq_len``-long KV cache this
    rank holds under ``cache_pspecs`` (``slice_index`` on the sequence
    dim); the whole cache without a mesh.  In the paged layout pass the
    block size: the within-block offsets [r·b/n, (r+1)·b/n) that rank r
    holds of every block."""
    spec = (None, None, None, "model" if plan.mode in ("dsp", "tp")
            else None, None)
    return slice_index((1, 1, 1, seq_len, 1), spec, ctx)[KV_SEQ_DIM]


def assert_kv_cache_on_mesh(caches, ctx: Optional[ParallelContext],
                            plan: ParallelPlan, seq_len: int) -> None:
    """Assert that every KV leaf of a cache or slot pool (this rank's
    tensors) holds the block of a ``seq_len``-long cache that
    ``cache_pspecs`` gives it: ``seq_len / n`` positions, rank r the r-th
    contiguous block (``kv_block``), so that its n blocks tile the
    sequence.  For the block pool ``seq_len`` is the block size: rank r
    holds offsets [r·b/n, (r+1)·b/n) of every block.  A no-op off a mesh
    or under plan ``none``."""
    sp = ctx.sp_size if ctx is not None else 1
    if sp <= 1 or plan.mode not in ("dsp", "tp"):
        return
    start, stop = kv_block(ctx, plan, seq_len)

    def check(path, leaf):
        if is_kv_leaf(path, leaf):
            assert (leaf.shape[KV_SEQ_DIM] * sp == seq_len
                    and stop - start == leaf.shape[KV_SEQ_DIM]
                    and start == ctx.sp_index * (seq_len // sp)), (
                f"KV cache leaf {'/'.join(path)} not sequence-sharded over "
                f"the {sp}-way model dim: this rank holds "
                f"{tuple(leaf.shape)} of {seq_len} positions, the layout "
                f"gives it [{start}, {stop})")
    tree_map_with_path(check, caches)


@dataclasses.dataclass(frozen=True)
class Sharder:
    """Semantic activation-layout hooks over ``ctx``'s ``model`` group,
    and the parameters' layout (``param_specs``, read by ``whole``).
    ``ctx=None`` (one device) makes every hook the identity.

    ``schedule`` is the planned switching schedule on the (B, S, H·Dh)
    stage view; ``resid_dim``/``mixer_dim`` cache the planned shard dim of
    the residual/channel stages and of the mixer stages."""

    ctx: Optional[ParallelContext]
    plan: ParallelPlan
    schedule: Optional[Any] = None
    resid_dim: Optional[int] = None
    mixer_dim: Optional[int] = None
    # ``param_pspecs`` of the global parameter tree: how the tree the
    # model is given is split (None: every leaf whole)
    param_specs: Optional[Dict[str, Any]] = None
    # under ``tp``: the K/V heads do not divide the model ranks, so
    # ``whole`` reads ``wk``/``wv`` whole (``models.lm`` sets it)
    kv_whole: bool = False

    def with_schedule(self, schedule) -> "Sharder":
        _check_schedule(schedule, on_mesh=self.ctx is not None)
        resid, mixer = _stage_dims(self.plan, schedule)
        return dataclasses.replace(self, schedule=schedule, resid_dim=resid,
                                   mixer_dim=mixer)

    # -- the mesh ---------------------------------------------------------------
    @property
    def sp_size(self) -> int:
        return 1 if self.ctx is None else self.ctx.sp_size

    @property
    def sp_index(self) -> int:
        return 0 if self.ctx is None else self.ctx.sp_index

    @property
    def dp_size(self) -> int:
        return 1 if self.ctx is None else self.ctx.dp_size

    @property
    def dp_index(self) -> int:
        return 0 if self.ctx is None else self.ctx.dp_index

    @property
    def tp(self) -> bool:
        """Whether the layers run tensor-parallel: plan ``tp`` on a
        mesh."""
        return self.ctx is not None and self.plan.mode == "tp"

    @property
    def seq_shards(self) -> int:
        """Ranks the resid stages split the sequence over: the SP size when
        the residual stream is sequence-sharded, else 1."""
        return self.sp_size if self.resid_dim == 1 else 1

    def seq_offset(self, s_local: int) -> int:
        """Global position of this rank's first token of a resid-layout
        tensor with ``s_local`` tokens."""
        return self.sp_index * s_local if self.resid_dim == 1 else 0

    def mixer_slice(self, n: int) -> Tuple[int, int]:
        """(first, count) of this rank's share of an ``n``-long head or
        channel axis in the mixer layout: chunk ``sp_index`` of ``sp_size``
        when the mixer shards dim 2, else all of it."""
        if self.ctx is None or self.mixer_dim != 2:
            return 0, n
        k = n // self.sp_size
        return self.sp_index * k, k

    def wants_head_switch(self, n_heads: int) -> bool:
        """True when the planned mixer layout is head-sharded and the head
        count divides the SP size (``attention_sp`` gathers K/V
        otherwise)."""
        return self.mixer_dim == 2 and n_heads % self.sp_size == 0

    def whole(self, tree, *path: str):
        """``tree``, the parameters' subtree at ``path``, with every leaf
        gathered over the splits the model does not keep
        (``read_specs``: all but ``ep``'s experts and ``tp``'s columns and
        rows), where the model reads it; ``tree`` itself without a mesh or
        specs.  Under a ``STACKED`` subtree ``tree`` is one period: the
        specs drop their leading (period) entry."""
        specs = self.param_specs
        if specs is not None:
            for k in path:
                specs = specs[k]
            specs = read_specs(specs, self.plan, path,
                               kv_whole=self.kv_whole)
        return whole_params(tree, specs, self.ctx,
                            stacked=bool(path) and path[0] in STACKED)

    # -- the one transition ----------------------------------------------------
    def _class(self, name: str) -> Optional[int]:
        return {"resid": self.resid_dim, "mixer": self.mixer_dim,
                "whole": None}[name]

    def _move(self, x: torch.Tensor, src: str, tgt: str,
              view: str) -> torch.Tensor:
        """``x`` from class layout ``src`` ("resid" or "mixer") to ``tgt``
        ("resid", "mixer" or "whole"), its logical dims placed as ``view``
        says: a keep, one switch or one gather."""
        if self.ctx is None or self.plan.mode != "dsp":
            return x
        a, b = self._class(src), self._class(tgt)
        if a == b:
            return x
        dims = _VIEWS[view]
        group = self.ctx.sp_group
        if b is None:
            return dsp.gather(x, dims[a], group)
        return dsp.dynamic_switch(x, dims[a], dims[b], group)

    # -- (B, S, C) residual stream ----------------------------------------------
    def enter3(self, x):
        """Entry boundary, before the layer loop: the dataloader splits the
        sequence, which is the resid layout (``_check_schedule``), a
        keep."""
        return self._move(x, "resid", "resid", "bsc")

    def act3(self, x):
        """Inside the resid stages (after the MLP, at a layer exit): a
        keep."""
        return self._move(x, "resid", "resid", "bsc")

    def wrap3(self, x):
        """Top of each period: the carry already holds the resid layout, a
        keep."""
        return self._move(x, "resid", "resid", "bsc")

    def mixer_exit3(self, x, *, src: str = "mixer"):
        """Out of a mixer stage into the residual stream (the paper's
        switch back), on the (B, S, C) view: the attention output before
        ``wo`` (channel-sharded, C = heads·D), or, with ``src="resid"``, a
        tensor already back in it (a keep)."""
        return self._move(x, src, "resid", "bsc")

    # -- (B, H, S, D) attention heads -------------------------------------------
    def heads_enter(self, x):
        """Into the mixer stage, one (B, H, S, D) tensor: one switch from
        the sequence to the heads."""
        return self._move(x, "resid", "mixer", "bhsd")

    def heads_stacked(self, x):
        """Into the mixer stage, stacked (k, B, H, S, D) q/k/v: ONE switch
        for all k (the fused DSP switch)."""
        return self._move(x, "resid", "mixer", "kbhsd")

    def heads(self, x):
        """Inside the mixer stage (the attention output): a keep."""
        return self._move(x, "mixer", "mixer", "bhsd")

    def q_seq(self, x):
        """(B, H, S, D) q kept sequence-sharded (the kv-gather path, whose
        heads do not divide the SP size): a keep."""
        return self._move(x, "resid", "resid", "bhsd")

    def kv_gathered(self, x):
        """(2, B, Hkv, S, D) stacked K/V gathered to the whole sequence:
        one all-gather (the paper's gather primitive)."""
        return self._move(x, "resid", "whole", "kbhsd")

    # -- (B, L, D) scan operands --------------------------------------------------
    def mixer3(self, x, *, src: str):
        """A flat scan operand into the mixer layout on its channel dim:
        from the sequence-sharded stream (``src="resid"``, one switch), or
        kept inside the scan (``src="mixer"``)."""
        return self._move(x, src, "mixer", "bsc")

    def scan_out3(self, x):
        """The scan's output back to the resid layout: one switch."""
        return self.mixer_exit3(x)

    def replicated(self, x, *, src: str = "resid"):
        """Small tensors whole on every rank (the SSM's B/C groups: G may
        undershoot the SP size): one all-gather of the sequence."""
        return self._move(x, src, "whole", "bsc")

    def xent_chunks(self, x):
        """The loss's chunks: each rank's chunks are its own sequence
        shard, a keep."""
        return self._move(x, "resid", "resid", "bsc")

    def seq_halo(self, x, rows: int) -> Optional[torch.Tensor]:
        """The ``rows`` positions just before this rank's sequence shard of
        (B, S, C) ``x``: the previous rank's last rows, sent with one
        cyclic permute from rank r to r + 1, zeroed on rank 0 (whose
        backward sends the last rank a zero cotangent).  None where the
        sequence is whole, at one rank too: no neighbour, no call."""
        if (self.ctx is None or self.plan.mode != "dsp"
                or self.resid_dim != 1 or self.sp_size == 1):
            return None
        if x.shape[1] < rows:
            raise ValueError(f"a sequence shard of {x.shape[1]} positions "
                             f"cannot hold a halo of {rows}")
        n = self.sp_size
        halo = dsp.ppermute(x[:, x.shape[1] - rows:],
                            [(r, (r + 1) % n) for r in range(n)],
                            self.ctx.sp_group)
        return halo * (self.sp_index != 0)

    # -- tensor parallelism (Megatron-SP) ------------------------------------
    def tp_enter(self, x):
        """Into a ``tp`` block: the (B, S/n, C) resid shard -> the whole
        sequence, one all-gather over ``model`` (its backward a
        reduce-scatter); a keep off ``tp``."""
        if not self.tp:
            return x
        return dsp.gather(x, 1, self.ctx.sp_group)

    def tp_exit(self, x):
        """Out of a ``tp`` block: the ranks' partial row-parallel outputs
        (B, S, C) summed, the rank's sequence shard kept, one
        reduce-scatter over ``model`` (its backward an all-gather); a keep
        off ``tp``."""
        if not self.tp:
            return x
        return dsp.reduce_scatter(x, 1, self.ctx.sp_group)

    def tp_sum(self, x):
        """A decode step's partial row-parallel output (whole sequence on
        every rank) summed over ``model``: one SUM all-reduce, in place; a
        keep off ``tp``."""
        if self.tp:
            dsp.all_reduce(x, self.ctx.sp_group)
        return x

    # -- MoE -------------------------------------------------------------------
    def moe_experts(self, *, step: bool = False) -> Optional[ExpertPlace]:
        """Where this rank's MoE tokens and experts sit (JAX's hook of this
        name shards the (B, E, C, d) dispatch buffer over ``model`` under
        ``ep``): the row's tokens in the resid layout, split by sequence
        over ``model``, with the count exchange over the world; under
        ``ep`` the experts split there in blocks.  Under ``tp`` without
        ``ep`` the tokens are the block's gathered sequence instead, whole
        on every model rank (``ExpertPlace.whole``), and each expert's
        hidden columns split over ``model`` (``param_pspecs``).  A serving
        ``step`` (a decode step, a paged prefill chunk) holds its tokens
        whole on every model rank: no count exchange.  None without a
        mesh (one device: ``models.moe`` runs alone)."""
        if self.ctx is None or self.plan.mode not in ("dsp", "tp"):
            return None
        whole = step or (self.tp and not self.plan.ep)
        if not whole and self.resid_dim != 1:
            raise NotImplementedError(
                f"MoE on a mesh needs the residual stream split by sequence "
                f"over 'model' (the plan puts it on dim {self.resid_dim})")
        return ExpertPlace(
            group=self.ctx.sp_group,
            world_group=None if step else self.ctx.axes_group(tuple(
                self.ctx.mesh.mesh_dim_names)),
            seq_shards=self.sp_size, seq_index=self.sp_index,
            dp_size=self.dp_size, dp_index=self.dp_index, ep=self.plan.ep,
            whole=whole)

    # -- serving: the prefill's rows, the decode token, the cache --------------
    @property
    def serves_sharded(self) -> bool:
        """Whether serving runs sharded: on a mesh under plan ``dsp`` or
        ``tp``, the KV cache split by sequence and the SSM state by head
        over ``model`` (``cache_pspecs``), at one model rank too."""
        return self.ctx is not None and self.plan.mode in ("dsp", "tp")

    def _seq_sharded(self) -> bool:
        return self.serves_sharded and self.resid_dim == 1

    def seq_rows(self, x, first: int, count: int) -> torch.Tensor:
        """Rows ``[first, first + count)`` of the global sequence of a
        resid-layout (B, S, C) ``x``, whole on every rank, zeros at
        positions below 0 (a prompt shorter than ``count``): the rank
        holding each row adds it to a zero buffer, the others add zeros,
        and one SUM all-reduce over ``model`` gives every rank the rows
        bit for bit.  A slice without a mesh.  The prefill's last position
        (for the logits) and the conv window's last inputs."""
        s = x.shape[1]
        off = self.sp_index * s if self._seq_sharded() else 0
        out = x.new_zeros((x.shape[0], count) + tuple(x.shape[2:]))
        lo, hi = max(first, off), min(first + count, off + s)
        if lo < hi:
            out[:, lo - first:hi - first] = x[:, lo - off:hi - off]
        if self._seq_sharded():
            dsp.all_reduce(out, self.ctx.sp_group)
        return out

    def decode_heads(self, x):
        """(B, H, S, D) q/k/v of a decode step: whole on every model rank
        (the step's embedding is whole there), so each rank attends its own
        block of the sequence-sharded cache with every head; a keep, no
        call (JAX's hook replicates them over ``model``)."""
        return x

    def kv_cache(self, kv, length: int, max_len: int) -> torch.Tensor:
        """The prefill's K/V (..., S_local, D), this rank's sequence shard
        of the prompt padded to n·S_local positions, -> this rank's block
        of a ``max_len``-long cache (``kv_block``): on a mesh one
        all-gather of the shards over ``model`` (JAX leaves this reshard
        to XLA), then the block cut out, the prompt's first ``length``
        positions kept and zeros past them.  Without a mesh the prompt's
        cache widened with zeros.

        Under ``tp`` the K/V (..., Hkv/n, S, D) are the rank's heads over
        the whole padded prompt: widened to ``max_len`` with zeros past
        ``length`` and switched from heads to sequence (one all-to-all
        over ``model``), they are this rank's block with every head.
        With ``kv_whole`` they hold every head already, and the rank cuts
        its block with no call."""
        dim = kv.dim() - 2
        if self.tp and not self.kv_whole:
            s = min(kv.shape[dim], length)
            pad = list(kv.shape)
            pad[dim] = max_len - s
            kv = torch.cat([kv.narrow(dim, 0, s), kv.new_zeros(pad)], dim)
            return dsp.dynamic_switch(kv, dim - 1, dim, self.ctx.sp_group)
        if self._seq_sharded() and not self.tp:
            kv = dsp.gather(kv, dim, self.ctx.sp_group)
        start, stop = kv_block(self.ctx, self.plan, max_len)
        shape = list(kv.shape)
        shape[dim] = stop - start
        out = kv.new_zeros(shape)
        hi = min(stop, length)
        if start < hi:
            out.narrow(dim, 0, hi - start).copy_(kv.narrow(dim, start,
                                                           hi - start))
        return out


def _check_schedule(schedule, *, on_mesh: bool) -> None:
    if schedule is not None and hasattr(schedule, "layouts"):
        raise TypeError(
            "make_sharder received a 2D (layout-pair) schedule; the "
            "class-hook Sharder executes one dim per stage class")
    if schedule is None or not on_mesh:
        return
    if schedule.initial != 1 or schedule.final != 1:
        raise ValueError(
            f"the LM's batch arrives split on the sequence and its loss "
            f"reads it there: the schedule must enter and leave on dim 1, "
            f"not {schedule.initial} and {schedule.final}")
    if any(s != "dsp" for s in (schedule.strategies or ())):
        raise NotImplementedError(
            f"embedded strategies {sorted(set(schedule.strategies))} in the "
            f"LM's stages are not ported (ROADMAP queue 1 item 3's "
            f"remainder)")
    if not schedule.mirrored:
        raise NotImplementedError(
            "a planned (non-mirrored) backward: the hooks' primitives "
            "transpose the forward, and JAX runs it only through XLA "
            "(ROADMAP queue 1, standing notes)")
    if schedule.overlap is not None:
        raise NotImplementedError(
            f"overlap {schedule.overlap!r} for the LM's switches comes with "
            f"the overlapped switch that overlaps (ROADMAP queue 1 item 2)")


def _stage_dims(plan: ParallelPlan,
                schedule) -> Tuple[Optional[int], Optional[int]]:
    """Planned (resid_dim, mixer_dim) of the logical (B, S, H·Dh) stage
    view: mixer stages compute along the sequence (dim 1 in
    ``compute_dims``), everything else is a residual/channel stage.
    Without a schedule the mode-based defaults apply.  The hooks execute
    ONE layout per stage class, so a plan that gives same-class stages
    different dims is rejected."""
    if schedule is not None:
        resid = mixer = None
        for st, d in zip(schedule.stages, schedule.dims):
            name = "mixer" if 1 in st.compute_dims else "resid"
            have = mixer if name == "mixer" else resid
            if have is not None and have != d:
                raise ValueError(
                    f"non-uniform plan: {name} stage {st.name!r} shards dim "
                    f"{d}, earlier {name} stages shard {have}; the Sharder "
                    f"hook path needs one layout per stage class")
            if name == "mixer":
                mixer = d
            else:
                resid = d
        return resid, mixer
    if plan.mode in ("dsp", "tp"):
        return 1, 2
    return None, None


def make_sharder(mesh, plan: ParallelPlan, schedule=None, *,
                 param_specs=None) -> Sharder:
    """The hooks for ``plan`` on ``mesh`` (a ``DeviceMesh`` with a
    ``model`` dim, the others splitting the batch), or the identity hooks
    when ``mesh`` is None.  ``schedule`` (``models.lm.dsp_schedule``) gives
    the stage layouts; without one, forwards plan their own from the
    batch's shape, priced in bytes.  ``param_specs`` is
    ``param_pspecs(params, plan, axis_sizes=mesh_sizes(ctx))`` of the
    global tree, the layout of the parameters the model is given
    (``shard_params``); on a mesh a plan with ``zero``, ``shard_vocab``
    or mode ``tp`` needs it.

    On a mesh plan mode ``dsp`` runs, ``ep`` on or off, under a mirrored
    all-"dsp" schedule with no ``overlap``, and plan ``tp`` with no
    schedule (the model checks what it runs: ``models.lm.check_tp``);
    the rest raises ``NotImplementedError`` naming the ROADMAP item that
    brings it."""
    if plan.mode not in MODES:
        raise ValueError(f"plan mode {plan.mode!r} not in {MODES}")
    ctx = None
    if mesh is not None:
        ctx = from_mesh(mesh)
        if ctx.sp_axes != ("model",):
            raise NotImplementedError(
                f"the LM's hooks run over one 'model' mesh dim, not the SP "
                f"grid {ctx.sp_axes} (ROADMAP queue 1 item 3's remainder)")
        if plan.mode == "none":
            raise ValueError("plan mode 'none' shares no work over the "
                             "model dim: pass mesh=None")
        if plan.mode == "tp" and schedule is not None:
            raise ValueError("plan mode 'tp' takes no switching schedule: "
                             "its blocks gather the sequence and "
                             "reduce-scatter it back (Sharder.tp_enter)")
        if (plan.zero or plan.shard_vocab
                or plan.mode == "tp") and param_specs is None:
            raise ValueError(
                "a plan with zero, shard_vocab or tp on a mesh splits the "
                "parameters: pass param_specs=param_pspecs(params, plan, "
                "axis_sizes=mesh_sizes(ctx)) of the global tree")
    _check_schedule(schedule, on_mesh=ctx is not None)
    resid, mixer = _stage_dims(plan, schedule)
    return Sharder(ctx=ctx, plan=plan, schedule=schedule, resid_dim=resid,
                   mixer_dim=mixer,
                   param_specs=param_specs if ctx is not None else None)


def null_sharder() -> Sharder:
    """One device, plan ``none``: every hook the identity."""
    return make_sharder(None, ParallelPlan(mode="none"))


__all__ = ["ParallelPlan", "Sharder", "make_sharder", "null_sharder",
           "param_pspecs", "mesh_sizes", "shard_params", "gather_params",
           "whole_params", "unshard_params", "gathered_numels",
           "read_numels",
           "is_expert_leaf", "is_tp_leaf", "read_specs",
           "store_contract", "entry_axes", "split_axes", "reduce_axes",
           "STACKED",
           "global_shape", "slice_index", "param_copies", "reshard",
           "KV_SEQ_DIM", "SLOT_DIM", "BLOCK_DIM", "is_kv_leaf",
           "cache_pspecs", "kv_block", "assert_kv_cache_on_mesh",
           "tree_map_with_path"]
