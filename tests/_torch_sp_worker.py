"""One rank of the port's embedded-SP baseline checks over gloo on the CPU.

    python tests/_torch_sp_worker.py <rank> <world> <dir>

``tests/test_torch_sp_baselines.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params.npz``,
``inputs.npz``).  For each scenario of ``_torch_sp_jax.SCENARIOS`` a rank
runs ``make_spmd_forward`` once without grads (its output shard) and once
under ``jax.grad``'s loss, the sum of the output's squares (its grads,
then summed over the world), and counts the ``torch.distributed`` calls
and bytes of each (``core.dsp.calls`` and ``volume``).  Then the
overlapped switch against ``dynamic_switch`` and a causal GQA ring
attention against ``attention_ref`` of the whole sequence.  What it saw
goes to ``dir/rank<r>.npz``."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_sp_jax import SCENARIOS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.core.overlap import overlapped_switch  # noqa: E402
from repro_torch.core.ring import ring_attention  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_sp2d_mesh  # noqa: E402
from repro_torch.models import transformer2d as TT  # noqa: E402
from repro_torch.models.lm import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.trainer import allreduce_grads  # noqa: E402

CFG = TT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4, d_ff=128,
                   in_dim=16, dtype=torch.float32)
KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
         "collective-permute")


def counted(out, name):
    out[f"{name}/calls"] = np.array([dsp.calls.get(k, 0) for k in KINDS])
    out[f"{name}/bytes"] = np.array([dsp.volume.get(k, 0) for k in KINDS])
    dsp.reset_calls()


def build_mesh(kind):
    if kind == "sp2x2":
        return make_sp2d_mesh(2, 2, device_type="cpu")
    shape = {"1x4": (1, 4), "2x2": (2, 2)}[kind]
    return make_mesh(shape, ("data", "model"), "cpu")


def scenario(out, name, params_np, inp):
    mode, overlap, kind = SCENARIOS[name]
    mesh = build_mesh(kind)
    ctx = from_mesh(mesh)
    fwd = TT.make_spmd_forward(CFG, mesh, mode=mode, backend="ref",
                               overlap=overlap)
    params = bridge.params_from_numpy(params_np, device="cpu")
    dsp.reset_calls()
    with torch.no_grad():
        out[f"{name}/out"] = fwd(params, inp["x"], inp["t"])
    out[f"{name}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
    counted(out, f"{name}/fwd")
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    y = fwd(leaves, inp["x"], inp["t"])
    loss = (y * y).sum()
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    counted(out, f"{name}/grad")
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), leaves))
    out[f"{name}/loss"] = total
    for path, g in flatten(gtree).items():
        out[f"{name}/grad/{path}"] = g
    dsp.reset_calls()


def overlapped(out):
    """On the (1, 4) mesh's model group: each mode of the overlapped switch
    (with and without ``consume``), its values and its backward, against
    ``dynamic_switch``'s; the calls of each."""
    ctx = from_mesh(make_mesh((1, 4), ("data", "model"), "cpu"))
    g = ctx.sp_group
    rank = dist.get_rank()
    x = (torch.arange(2 * 2 * 8 * 3, dtype=torch.float32).reshape(2, 2, 8, 3)
         + 1000 * rank).requires_grad_(True)
    w = torch.randn(2, 8, 2, 3, generator=torch.Generator().manual_seed(rank))

    def consume(piece, t):
        return piece * 2.0 + t

    dsp.reset_calls()
    want = dsp.dynamic_switch(x, 1, 2, g)
    (want_grad,) = torch.autograd.grad((want * w).sum(), x)
    dsp.reset_calls()
    for mode in ("chunked", "double_buffer"):
        for hook in (None, consume):
            name = f"ovl/{mode}/{'consume' if hook else 'plain'}"
            y = overlapped_switch(x, 1, 2, g, mode=mode, consume=hook)
            (grad,) = torch.autograd.grad((y * w).sum(), x)
            counted(out, name)
            ref = want if hook is None else torch.cat(
                [consume(want.narrow(1, 2 * p, 2), (rank - p) % 4)
                 for p in range(4)], dim=1)
            out[f"{name}/equal"] = np.array(bool(torch.equal(y, ref)))
            out[f"{name}/grad_equal"] = np.array(
                bool(torch.equal(grad, want_grad)) if hook is None else True)


def ring_causal_gqa(out, q, k, v):
    """Causal GQA ring attention over 4 ranks (the later ranks' K/V blocks
    are fully masked for the earlier ranks' rows) on each rank's slice of
    the sequence."""
    ctx = from_mesh(make_mesh((1, 4), ("data", "model"), "cpu"))
    r, s_loc = ctx.sp_index, q.shape[1] // 4
    sl = slice(r * s_loc, (r + 1) * s_loc)
    out["ringc/out"] = ring_attention(q[:, sl], k[:, sl], v[:, sl],
                                      ctx.sp_group, causal=True)
    out["ringc/ref"] = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True).transpose(1, 2)[:, sl]
    dsp.reset_calls()


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    torch.manual_seed(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    try:
        params_np = unflatten(dict(np.load(os.path.join(work,
                                                        "params.npz"))))
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        inp = {k: torch.from_numpy(raw[k]) for k in ("x", "t")}
        out = {}
        for name in SCENARIOS:
            scenario(out, name, params_np, inp)
        overlapped(out)
        ring_causal_gqa(out, *(torch.from_numpy(raw[k])
                               for k in ("ring_q", "ring_k", "ring_v")))
        np.savez(os.path.join(work, f"rank{rank}.npz"),
                 **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                        else v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
