"""Mixture-of-Experts: top-k routing, shared experts, dense residual
(counterpart of ``repro.models.moe``).

Two dispatch implementations, as in JAX:

* ``einsum`` — GShard/T5X-style capacity dispatch through one-hot
  (B, S, E, C) tensors, one group per batch row;
* ``gather`` — sort-based dispatch per row: the (token, k) pairs of a row
  sorted by expert (stable, so within an expert the pairs keep token
  order), each pair's slot its place in its expert's run, the pairs past
  the capacity dropped.  The LM runs this one.

Experts whose count does not divide the EP axis are padded with
never-routed dummies (router logits forced to -1e30), e.g. qwen2-moe's
60 -> 64.  The router is a float32 linear whatever the model's dtype.

On a ``("data", "model")`` mesh (``gather`` only) the row's tokens are
split over ``model`` by sequence, and the port gives JAX's global
semantics: the capacity comes from the whole row's length, and a pair's
slot from the whole row's token order.  Each rank routes its own tokens;
one all-reduce over the world of the per-(row, expert) counts (the count
exchange) gives every rank the counts of the ranks before it in the
sequence, so its pairs take their global slots and the pairs JAX drops
are dropped here.  Without ``ep`` every rank holds every expert and runs
its kept pairs itself.  With ``ep`` the rank holds E/n experts: its kept
pairs go to their experts' ranks in one variable-split all-to-all
(``core.dsp.exchange``: the DSP switch from the token dim to the expert
dim), each rank runs its experts over a (B, E/n, C, d) buffer laid out as
JAX's (B, E, C, d) one is, and the reverse exchange brings each pair's
output home.  Each rank combines its own tokens: its pairs' outputs
gathered back through the inverse permutation and summed over k in order,
with no atomics, so two runs agree bit for bit.

Where the row's tokens are whole on every model rank instead (under
``tp`` without ``ep``, the block's gathered sequence; a serving step),
each rank routes them all, with no position offsets: without ``ep`` it
runs what it holds of every expert (all of each, or under ``tp`` its
hidden columns, a partial output), with ``ep`` the pairs routed to its
block of experts, and the caller sums the partials (``models.lm
.moe_block``).  A prefill padded on the right passes its true
``length``: the padding takes no slot and the capacity is the unpadded
row's.

The aux stats are JAX's, global over the batch: ``load_balance`` (E ·
sum over experts of the routed fraction times the mean router
probability) and ``dropped`` (the share of pairs past the capacity).  On
a mesh each rank returns its share of each, so that their sum over the
world is the global value (the loss's convention): the routed fraction
comes from the count exchange, the probabilities are the rank's own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import dsp
from repro_torch.core.layout import ExpertPlace
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    """Static routing metadata (kept out of the parameter tree)."""
    n_experts: int
    top_k: int
    e_phys: int                 # physical experts incl. EP padding
    kind: str = "silu_glu"
    has_shared: bool = False
    has_dense: bool = False


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             top_k: int, *, n_shared: int = 0,
             shared_ff: Optional[int] = None,
             dense_ff: Optional[int] = None, kind: str = "silu_glu",
             pad_experts_to: Optional[int] = None, dtype=torch.float32):
    """``pad_experts_to``: physical expert count (>= n_experts) for EP
    divisibility; the extra experts are initialised but never routed to."""
    e_phys = pad_experts_to or n_experts
    if e_phys < n_experts:
        raise ValueError(f"pad_experts_to {e_phys} < n_experts {n_experts}")
    p = {"router": L.init_linear(gen, d_model, e_phys, dtype=torch.float32),
         "wi": L._normal(gen, (e_phys, d_model, d_ff),
                         1.0 / math.sqrt(d_model), dtype),
         "wo": L._normal(gen, (e_phys, d_ff, d_model),
                         1.0 / math.sqrt(d_ff), dtype)}
    if kind.endswith("_glu"):
        p["wg"] = L._normal(gen, (e_phys, d_model, d_ff),
                            1.0 / math.sqrt(d_model), dtype)
    if n_shared > 0:
        sff = shared_ff if shared_ff is not None else n_shared * d_ff
        p["shared"] = L.init_mlp(gen, d_model, sff, kind=kind, dtype=dtype)
        p["shared_gate"] = L.init_linear(gen, d_model, 1, dtype=dtype)
    if dense_ff is not None:
        p["dense"] = L.init_mlp(gen, d_model, dense_ff, kind=kind,
                                dtype=dtype)
    return p


def _expert_ffn(p, xe, kind: str):
    """xe: (..., E, C, d) -> (..., E, C, d), batched over experts."""
    hi = torch.einsum("...ecd,edf->...ecf", xe, p["wi"])
    if kind == "silu_glu":
        h = F.silu(torch.einsum("...ecd,edf->...ecf", xe, p["wg"])) * hi
    elif kind == "gelu_glu":
        h = F.gelu(torch.einsum("...ecd,edf->...ecf", xe, p["wg"]),
                   approximate="tanh") * hi
    elif kind == "relu":
        h = F.relu(hi)
    else:
        h = F.gelu(hi, approximate="tanh")
    return torch.einsum("...ecf,efd->...ecd", h, p["wo"])


def _router_logits(p, x, meta: MoEArgs):
    """x: (..., d) -> (..., E_phys) routing logits in float32, the padded
    experts' forced to -1e30."""
    logits = L.linear(p["router"], x.float())
    e, e_phys = meta.n_experts, meta.e_phys
    if e_phys > e:
        neg = logits.new_full(logits.shape[:-1] + (e_phys - e,), -1e30)
        logits = torch.cat([logits[..., :e], neg], dim=-1)
    return logits


def _route(p, x, meta: MoEArgs, norm_topk: bool):
    probs = torch.softmax(_router_logits(p, x, meta), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, meta.top_k, dim=-1)
    if norm_topk:
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def _capacity(s: int, k: int, e_phys: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(s * k / e_phys * capacity_factor)))


def moe_einsum(p, x, meta: MoEArgs, *, capacity_factor: float = 1.25,
               norm_topk: bool = True):
    """x: (B, S, d).  Grouped capacity dispatch; groups = batch rows.
    Returns (y, aux).  One device only: on a mesh the LM runs the gather
    dispatch."""
    e_phys, k = meta.e_phys, meta.top_k
    b, s, d = x.shape
    probs, gate_vals, gate_idx = _route(p, x, meta, norm_topk)
    cap = _capacity(s, k, e_phys, capacity_factor)
    assign = F.one_hot(gate_idx, e_phys).float()                # (B,S,K,E)
    flat = assign.reshape(b, s * k, e_phys)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e_phys)
    keep = (pos < cap) * assign
    # one-hot of each pair's slot, all zeros past the capacity (JAX's
    # ``one_hot`` of an index out of range)
    slot = ((pos * assign).sum(-1).long()[..., None]
            == torch.arange(cap, device=x.device)).float()       # (B,S,K,C)
    dispatch = torch.einsum("bske,bskc->bsec", keep, slot)
    combine = torch.einsum("bske,bskc,bsk->bsec", keep, slot,
                           gate_vals.float())
    xe = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
    ye = _expert_ffn(p, xe, meta.kind)
    y = torch.einsum("becd,bsec->bsd", ye, combine.to(x.dtype))
    y = y + shared_and_dense(p, x, meta)
    frac = assign.sum(2).mean(dim=(0, 1))
    pmean = probs.mean(dim=(0, 1))
    aux = {"load_balance": e_phys * torch.sum(frac * pmean),
           "dropped": (assign.sum((2, 3)) > keep.sum((2, 3))).float().mean()}
    return y.to(x.dtype), aux


def _exclusive_cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(t, dim=dim) - t


def _count_exchange(counts: torch.Tensor, place: ExpertPlace):
    """counts (B, E): this rank's pairs per (row, expert) -> every model
    rank's of this rank's data slice, (n, B, E), from one SUM all-reduce
    over the world of a (dp, n, B, E) buffer in which each rank fills its
    own entry (every rank gets the counts bit for bit), and the counts
    over the whole world, (E,)."""
    buf = counts.new_zeros((place.dp_size, place.seq_shards)
                           + tuple(counts.shape))
    buf[place.dp_index, place.seq_index] = counts
    dsp.all_reduce(buf, place.world_group)
    return buf[place.dp_index], buf.sum(dim=(0, 1, 2))


def moe_gather(p, x, meta: MoEArgs, *, capacity_factor: float = 2.0,
               norm_topk: bool = True,
               expert_hook: Optional[ExpertPlace] = None,
               length: Optional[int] = None, shared: bool = True):
    """Sort-based dispatch per batch row (JAX's ``moe_gather``): per row
    only (S·K,) index vectors and an (E, C, d) buffer exist.  x: (B, S, d)
    -> (y, aux).  ``expert_hook`` (``Sharder.moe_experts()``) places the
    rank on a mesh: x is then its shard of the rows (its data slice, its
    sequence chunk) and the dispatch runs as the module docstring says;
    None runs on one device.  Under ``ExpertPlace.whole`` x holds the
    row's tokens whole on every model rank: each rank routes them all, its
    capacity from their own count, and runs its block of experts (under
    ``ep``) or whatever of every expert it holds (all of each, or its
    hidden columns under ``tp``); the caller sums the ranks' outputs
    where they are partial, and the aux shares are divided among the
    ranks that hold the same tokens.

    ``length``: the row's true global length, where it was padded on the
    right (a prefill on a mesh): the positions at or past it take no
    expert slot, and the capacity comes from ``length``, so the kept
    pairs are an unpadded row's.  ``shared=False`` leaves out the shared
    and dense MLPs (``shared_and_dense``), which the caller then runs."""
    place = expert_hook
    e_phys, k = meta.e_phys, meta.top_k
    b, s, d = x.shape
    sk = s * k
    whole = place is None or place.whole
    n = 1 if whole else place.seq_shards      # ranks the row is split over
    seq = s * n if length is None else length    # the row's true length
    probs, gate_vals, gate_idx = _route(p, x, meta, norm_topk)
    cap = _capacity(seq, k, e_phys, capacity_factor)
    dev = x.device

    flat_e = gate_idx.reshape(b, sk)
    real = torch.ones((s,), dtype=torch.bool, device=dev)
    if length is not None:
        # padded positions route to a sentinel expert past the real ones:
        # their pairs sort last and take no slot
        first = 0 if whole else place.seq_index * s
        real = torch.arange(first, first + s, device=dev) < length
        flat_e = torch.where(real.repeat_interleave(k)[None], flat_e, e_phys)
    order = torch.argsort(flat_e, dim=-1, stable=True)        # (B, SK)
    e_sorted = flat_e.gather(1, order)
    counts = torch.zeros((b, e_phys + 1), dtype=torch.long, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = _exclusive_cumsum(counts, 1)          # each run's first index
    pos = torch.arange(sk, device=dev) - start.gather(1, e_sorted)
    counts = counts[:, :e_phys]
    routed = e_sorted < e_phys
    copies = 1                 # model ranks that route the same tokens
    if place is None or place.world_group is None:
        every, total = counts[None], counts.sum(0)
    else:
        every, total = _count_exchange(counts, place)
        if whole:
            copies = place.seq_shards
            total = total // copies
        else:
            # the pairs of earlier ranks in the sequence come first
            pos = pos + _exclusive_cumsum(every, 0)[place.seq_index].gather(
                1, e_sorted.clamp(max=e_phys - 1))
    valid = (pos < cap) & routed                               # (B, SK)

    xk = x.unsqueeze(2).expand(b, s, k, d).reshape(b, sk, d)
    rows = xk.gather(1, order[..., None].expand(b, sk, d))     # sorted
    if place is not None and place.ep and not whole:
        out = _experts_ep(p, meta, rows, e_sorted, pos, valid, every, cap,
                          place)
    elif place is not None and place.ep:
        out = _experts_local(p, meta, rows, e_sorted, pos, valid, cap,
                             block=(place.seq_index, place.seq_shards))
    else:
        out = _experts_local(p, meta, rows, e_sorted, pos, valid, cap)
    gate_sorted = gate_vals.reshape(b, sk).gather(1, order)
    out = out * torch.where(valid, gate_sorted, 0.0).to(x.dtype)[..., None]
    inverse = torch.argsort(order, dim=-1)
    y = out.gather(1, inverse[..., None].expand(b, sk, d))
    y = y.reshape(b, s, k, d).sum(dim=2)
    if shared:
        y = y + shared_and_dense(p, x, meta)

    tokens = b * seq                               # global counts below
    if place is not None:
        tokens *= place.dp_size
    frac = total.float() / tokens
    psum = torch.where(real[None, :, None], probs, 0.0).sum(dim=(0, 1))
    aux = {"load_balance": e_phys * torch.sum(frac * psum / tokens)
           / copies,
           "dropped": (routed & ~valid).sum().float() / (tokens * k)
           / copies}
    return y.to(x.dtype), aux


def _experts_local(p, meta: MoEArgs, rows, e_sorted, pos, valid, cap: int,
                   block=None):
    """Every expert on this rank: the kept rows (B, SK, d) of each row into
    a (B, E, C, d) buffer at their slots, the experts over it, and each
    pair's output back in the rows' order (zeros for dropped pairs).
    ``block`` (i, n): the rank holds the i-th of n blocks of the experts
    (``ep`` with the tokens whole), and runs only the pairs routed there;
    the others' outputs are zeros."""
    b, sk, d = rows.shape
    e_phys = meta.e_phys
    first = 0
    if block is not None:
        e_phys //= block[1]
        first = block[0] * e_phys
        valid = valid & (e_sorted >= first) & (e_sorted < first + e_phys)
    size = b * e_phys * cap
    slot = (torch.arange(b, device=rows.device)[:, None] * e_phys
            + e_sorted - first) * cap + pos
    slot = torch.where(valid, slot, size).reshape(-1)   # dropped: a spare row
    buf = rows.new_zeros((size + 1, d)).index_copy(0, slot,
                                                   rows.reshape(-1, d))
    ye = _expert_ffn(p, buf[:size].reshape(b, e_phys, cap, d), meta.kind)
    out = ye.reshape(size, d).index_select(0, slot.clamp(max=size - 1))
    return torch.where(valid.reshape(-1, 1), out, 0.0).reshape(b, sk, d)


def _experts_ep(p, meta: MoEArgs, rows, e_sorted, pos, valid, every, cap,
                place: ExpertPlace):
    """This rank's E/n experts: its kept rows sent to their experts' ranks
    (``dsp.exchange``), grouped by rank, then row, then expert, then slot;
    the rows it receives placed at their slots of a (B, E/n, C, d) buffer
    (each source's rows of a (row, expert) run fill slots from that
    source's offset on, so no index crosses the wire), its experts over
    it, and the outputs sent back the reverse way.  ``every`` (n, B, E)
    is every model rank's pair counts (the count exchange), from which
    every rank knows every split."""
    b, sk, d = rows.shape
    n, me, e_phys = place.seq_shards, place.seq_index, meta.e_phys
    if e_phys % n:
        raise ValueError(f"ep: {e_phys} experts do not split over {n} ranks")
    el = e_phys // n
    dev = rows.device
    offset = _exclusive_cumsum(every, 0)                     # (n, B, E)
    kept = torch.minimum(every, (cap - offset).clamp(min=0))  # (n, B, E)
    # rows rank r sends rank q: its kept pairs on q's experts
    splits = kept.reshape(n, b, n, el).sum(dim=(1, 3)).tolist()
    send = splits[me]
    recv = [splits[r][me] for r in range(n)]

    dest = torch.where(valid, e_sorted // el, n).reshape(-1)
    by_dest = torch.argsort(dest, stable=True)[:sum(send)]
    back = dsp.exchange(rows.reshape(-1, d).index_select(0, by_dest), send,
                        recv, place.group)

    # the slots of the received rows: runs (source, row, expert) in order
    mine = slice(me * el, (me + 1) * el)
    run_len = kept[:, :, mine].reshape(-1)
    run_slot = ((torch.arange(b, device=dev)[:, None] * el
                 + torch.arange(el, device=dev)) * cap)[None] \
        + offset[:, :, mine]
    first = _exclusive_cumsum(run_len, 0)
    total = sum(recv)
    slot = (torch.repeat_interleave(run_slot.reshape(-1) - first, run_len,
                                    output_size=total)
            + torch.arange(total, device=dev))
    size = b * el * cap
    buf = back.new_zeros((size, d)).index_copy(0, slot, back)
    local = {k: v for k, v in p.items() if k in ("wi", "wg", "wo")}
    ye = _expert_ffn(local, buf.reshape(b, el, cap, d), meta.kind)
    home = dsp.exchange(ye.reshape(size, d).index_select(0, slot), recv,
                        send, place.group)
    out = home.new_zeros((b * sk, d)).index_copy(0, by_dest, home)
    return out.reshape(b, sk, d)


def shared_and_dense(p, x, meta: MoEArgs, mlp=L.mlp):
    """The shared experts (gated by ``shared_gate``) and the dense
    residual MLP on x, summed; 0 where the layer has neither.  ``mlp``
    runs each of them (``models.lm``'s ``tp_partial`` under ``tp``: the
    rank's columns and rows, a partial output that is linear in the gated
    sum, so the caller sums it over ``model``)."""
    out = 0.0
    if "shared" in p:
        sh = mlp(p["shared"], x, meta.kind)
        gate = torch.sigmoid(L.linear(p["shared_gate"], x))
        out = out + gate * sh
    if "dense" in p:
        out = out + mlp(p["dense"], x, meta.kind)
    return out


def moe(p, x, meta: MoEArgs, *, impl: str = "gather",
        capacity_factor: float = 1.25, norm_topk: bool = True,
        expert_hook: Optional[ExpertPlace] = None,
        length: Optional[int] = None, shared: bool = True):
    if impl == "einsum":
        if expert_hook is not None or length is not None or not shared:
            raise NotImplementedError(
                "the einsum dispatch runs on one device; on a mesh use "
                "impl='gather', as the LM does")
        return moe_einsum(p, x, meta, capacity_factor=capacity_factor,
                          norm_topk=norm_topk)
    return moe_gather(p, x, meta, capacity_factor=max(capacity_factor, 2.0),
                      norm_topk=norm_topk, expert_hook=expert_hook,
                      length=length, shared=shared)


def moe_active_params(d_model: int, d_ff: int, top_k: int, kind: str,
                      n_shared: int = 0, shared_ff: Optional[int] = None,
                      dense_ff: Optional[int] = None) -> int:
    per_expert = L.mlp_param_count(d_model, d_ff, kind)
    total = top_k * per_expert
    if n_shared:
        total += L.mlp_param_count(d_model, shared_ff or n_shared * d_ff, kind)
    if dense_ff:
        total += L.mlp_param_count(d_model, dense_ff, kind)
    return total


__all__ = ["MoEArgs", "init_moe", "moe", "moe_einsum", "moe_gather",
           "shared_and_dense", "moe_active_params"]
