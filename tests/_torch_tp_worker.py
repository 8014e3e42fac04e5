"""One rank of the port's ``tp`` checks over gloo on the CPU.

    python tests/_torch_tp_worker.py <rank> <world> <dir>

``tests/test_torch_tp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params.npz``,
JAX's init of mistral-large-123b's SMOKE config, and ``inputs.npz``).
The rank writes ``dir/rank<r>.npz``:

* ``train/<mesh>/zero<0|1>``, for each mesh of ``_torch_tp_jax.MESHES``
  under ``ParallelPlan(mode="tp", zero=)``, the parameters cut to the
  rank's slices (``param_pspecs``, ``shard_params``): its coordinate;
  the shapes ``Sharder.whole`` gives one period's projections; its
  ``forward(sharder=)`` shard; ``lm_loss(sharder=)`` with remat on its
  batch shard, the loss and grads summed by ``allreduce_grads``, each
  grad slice with its place in the whole leaf, the clip's norm, and the
  step's ``torch.distributed`` calls and bytes beside its contract
  (``lm.remat_step`` of ``collective_contract(tp=True)`` plus
  ``lm.param_contract``);
* ``ckpt/*``: the parameters saved at (2, 2) and restored at (1, 4),
  each slice against ``shard_params`` of the whole tree, bit for bit;
* ``serve/*`` at ``SERVE_MESH`` under ``ParallelPlan(mode="tp")`` with
  the fp8 cache: the prefill's and one decode step's logits (the rank's
  vocab chunk) and each one's calls and bytes beside
  ``lm.serve_contract``; ``generate``; the continuous scheduler with 2
  slots and ``replan(2)`` at decode step 3 (the pool gathered before and
  after, each segment's calls beside its contract); and the paged
  scheduler.

Every rank waits at a barrier, then leaves the group, before it exits."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models.lm import tree_map  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, cache_pspecs, make_sharder, mesh_sizes, param_pspecs,
    shard_params, slice_index, tree_map_with_path, unshard_params)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousScheduler, PagedScheduler)
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.trainer import allreduce_grads, slices_norm  # noqa

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_tp_jax import (BATCH, BLOCK, CHUNK, MAX_LEN,  # noqa: E402
                           MESHES, NEW, PROMPT, SEQ, SERVE_BATCH,
                           SERVE_MESH, configs, label, requests)

SERVE_PLAN = ParallelPlan(mode="tp")


def counts() -> np.ndarray:
    """(calls, bytes) by ``KINDS`` since the last reset; resets."""
    out = np.array([[dsp.calls.get(k, 0) for k in KINDS],
                    [dsp.volume.get(k, 0) for k in KINDS]], dtype=np.int64)
    dsp.reset_calls()
    return out


def contract(*parts) -> np.ndarray:
    out = np.zeros((2, len(KINDS)), dtype=np.int64)
    for c in parts:
        for i, k in enumerate(KINDS):
            out[0, i] += c["calls"].get(k, 0)
            out[1, i] += c["bytes"].get(k, 0)
    return out


def _shape(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree.shape)


def train_case(out, cfg, whole, batch, shape, zero):
    key = f"train/{label(shape)}/zero{int(zero)}"
    plan = ParallelPlan(mode="tp", zero=zero)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = from_mesh(mesh)
    specs = param_pspecs(whole, plan, axis_sizes=mesh_sizes(ctx))
    sharder = make_sharder(mesh, plan, param_specs=specs)
    params = shard_params(whole, specs, ctx)
    local = TL.shard_lm_batch(batch, sharder)
    out[f"{key}/coord"] = np.array([sharder.dp_index, sharder.sp_index])
    one = TL.unstack(params["periods"], cfg.n_periods)[0]
    read = TL.fit_sharder(sharder, cfg).whole(one, "periods")["0"]
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("mlp", ("wi", "wg", "wo"))):
        for name in names:
            out[f"{key}/read/{part}/{name}"] = np.array(
                read[part][name]["w"].shape)
    dsp.reset_calls()
    with torch.no_grad():
        out[f"{key}/out"] = TL.forward(params, local["tokens"], cfg,
                                       sharder=sharder, remat=False)[0]
    dsp.reset_calls()
    leaves = tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = TL.lm_loss(leaves, local, cfg, sharder=sharder)
    grads = iter(torch.autograd.grad(loss, TL.tree_leaves(leaves)))
    total, gtree = allreduce_grads(loss.detach(), tree_map(
        lambda p: next(grads), params), specs, ctx)
    out[f"{key}/norm"] = slices_norm(gtree, specs, ctx)
    out[f"{key}/step"] = counts()
    dp, n = shape
    out[f"{key}/contract"] = contract(
        TL.remat_step(TL.collective_contract(cfg, n, BATCH // dp, SEQ // n,
                                             tp=True)),
        TL.param_contract(cfg, whole, plan, {"data": dp, "model": n}))
    out[f"{key}/loss"] = total

    def save(path, g, spec):
        p = "/".join(path)
        out[f"{key}/grad/{p}"] = g
        out[f"{key}/index/{p}"] = np.array(slice_index(_shape(whole, path),
                                                       spec, ctx))
    tree_map_with_path(save, gtree, specs)


def ckpt_case(out, cfg, whole, work):
    """Saved at (2, 2), restored at (1, 4): bit-equal slices."""
    plan = ParallelPlan(mode="tp", zero=True)
    mgr = CheckpointManager(os.path.join(work, "ck"))
    layouts = {}
    for shape in ((2, 2), (1, 4)):
        ctx = from_mesh(make_mesh(shape, ("data", "model"), "cpu"))
        layouts[shape] = (param_pspecs(whole, plan,
                                       axis_sizes=mesh_sizes(ctx)), ctx)
    specs, ctx = layouts[(2, 2)]
    mgr.save(1, {"params": shard_params(whole, specs, ctx)}, blocking=True,
             specs={"params": specs}, ctx=ctx)
    specs, ctx = layouts[(1, 4)]
    template = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                              device="meta"), whole)
    step, tree = mgr.restore({"params": template}, specs={"params": specs},
                             ctx=ctx, device="cpu")
    want = flatten(shard_params(whole, specs, ctx))
    got = flatten(tree["params"])
    out["ckpt/step"] = np.array(step)
    out["ckpt/equal"] = np.array([torch.equal(got[k], want[k])
                                  for k in sorted(want)])


def gathered(pool) -> dict:
    return flatten(unshard_params(pool.caches,
                                  cache_pspecs(pool.caches, pool.plan),
                                  pool.ctx))


def serve_cases(out, cfg, whole, raw):
    prompts = torch.from_numpy(raw["prompts"]).long()
    mesh = make_mesh(SERVE_MESH, ("data", "model"), "cpu")
    n = SERVE_MESH[1]
    eng = ServingEngine(whole, cfg, max_len=MAX_LEN, mesh=mesh,
                        plan=SERVE_PLAN, device="cpu")
    out["serve/coord"] = np.array([eng.sharder.dp_index,
                                   eng.sharder.sp_index])
    out["serve/kv_whole"] = np.array(eng.sharder.kv_whole)
    dsp.reset_calls()
    logits, caches = eng._prefill(prompts[:, :PROMPT])
    eng.next_tokens(logits)
    out["serve/prefill"] = logits
    out["serve/prefill_counts"] = counts()
    out["serve/prefill_contract"] = contract(TL.serve_contract(
        cfg, n, whole, SERVE_PLAN, prefill=(SERVE_BATCH, PROMPT),
        max_len=MAX_LEN))
    logits, _ = eng._decode(prompts[:, PROMPT:PROMPT + 1], caches)
    eng.next_tokens(logits)
    out["serve/decode"] = logits
    out["serve/decode_counts"] = counts()
    out["serve/decode_contract"] = contract(TL.serve_contract(
        cfg, n, whole, SERVE_PLAN, decode=SERVE_BATCH))
    out["serve/generate"] = eng.generate(prompts[:, :PROMPT], NEW,
                                         check_sharding=True)

    # continuous, 2 slots, replan(2) at decode step 3
    reqs = requests(prompts, Request)
    sched = ContinuousScheduler(eng, max_batch=2)

    def on_step(s, k):
        s.pool.assert_on_mesh()
        if k != 3:
            return
        before = gathered(s.pool)
        dsp.reset_calls()
        s.replan(2)
        out["serve/migrate_counts"] = counts()
        out["serve/migrate_contract"] = contract(TL.serve_contract(
            cfg, n, whole, SERVE_PLAN, migrate=(2, MAX_LEN, 2)))
        if eng.active:
            after = gathered(s.pool)
            out["serve/moved_equal"] = np.array(
                [torch.equal(dsp.as_bytes(before[p]), dsp.as_bytes(after[p]))
                 for p in before])
            out["serve/sp_after"] = np.array(eng.sp_degree)

    sched.run(reqs, on_step=on_step)
    if eng.active:
        for r in reqs:
            out[f"serve/continuous/{r.request_id}"] = np.array(r.generated)

    # paged, on a fresh engine at SERVE_MESH
    eng = ServingEngine(whole, cfg, max_len=MAX_LEN, mesh=mesh,
                        plan=SERVE_PLAN, device="cpu")
    reqs = requests(prompts, Request)
    sched = PagedScheduler(eng, max_batch=2, block_size=BLOCK,
                           prefill_chunk=CHUNK)
    sched.run(reqs)
    sched.pool.assert_on_mesh()
    for r in reqs:
        out[f"serve/paged/{r.request_id}"] = np.array(r.generated)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        cfgs = configs("repro_torch")
        whole = bridge.params_from_numpy(unflatten(dict(np.load(
            os.path.join(work, "params.npz")))), device="cpu")
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        batch = {k: torch.from_numpy(raw[k]).long()
                 for k in ("tokens", "labels")}
        for shape in MESHES:
            for zero in (True, False):
                train_case(out, cfgs["plain"], whole, batch, shape, zero)
        ckpt_case(out, cfgs["plain"], whole, work)
        serve_cases(out, cfgs["fp8"], whole, raw)
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
