"""One rank of the port's sharded-serving checks over gloo on the CPU.

    python tests/_torch_serve_worker.py <rank> <world> <dir>

``tests/test_torch_serving_dsp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params_<config>
.npz``, ``inputs.npz``).  For each config of ``_torch_serve_jax.configs``
and mesh of ``MESHES`` a rank writes to ``dir/rank<r>.npz`` its
coordinate, its logits of one prefill and one decode step with the calls
and bytes each issued (``core.dsp``'s counters) beside
``lm.serve_contract``'s, the engine's schedule and cache specs, and the
tokens of ``generate`` under ZeRO and the vocab split on and off; at
(1, 4) the tokens of prompts the 4 ranks do not divide, of a Poisson
trace through the continuous scheduler, and of a continuous run of 2
slots with a live ``replan(2)`` at decode step 3 (the moved caches
gathered before and after, the calls of each segment beside the
contract's), then ``replan(1)`` and a regrow that must raise."""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsp  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    KV_SEQ_DIM, ParallelPlan, cache_pspecs, is_kv_leaf, kv_block,
    unshard_params)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousScheduler  # noqa: E402

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_serve_jax import (BATCH, BUDGETS, CONT_BUDGETS,  # noqa: E402
                              MAX_LEN, MESHES, SEQ, SHORT, SHORT_NEW,
                              configs, label)

KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
         "collective-permute", "broadcast")
PLAN = ParallelPlan(mode="dsp")
ARRIVAL = 0.01                 # mean inter-arrival seconds, Poisson trace


def counts() -> np.ndarray:
    """[calls, bytes] by KINDS since the last reset, and reset."""
    out = np.array([[dsp.calls.get(k, 0) for k in KINDS],
                    [dsp.volume.get(k, 0) for k in KINDS]], dtype=np.int64)
    dsp.reset_calls()
    return out


def contract(*parts) -> np.ndarray:
    """The sum of ``lm.serve_contract`` results, as ``counts`` lays them
    out."""
    out = np.zeros((2, len(KINDS)), dtype=np.int64)
    for c in parts:
        for i, k in enumerate(KINDS):
            out[0, i] += c["calls"].get(k, 0)
            out[1, i] += c["bytes"].get(k, 0)
    return out


class Recorder:
    """Wraps an engine's steps to log what each ran on: (SP degree, batch,
    prompt length) per prefill, (SP degree, rows) per decode step."""

    def __init__(self, eng):
        self.prefills, self.decodes = [], []
        pre, dec = eng._prefill, eng._decode

        def prefill(tokens):
            self.prefills.append((eng.sp_degree, *tuple(tokens.shape)))
            return pre(tokens)

        def decode(token, caches):
            self.decodes.append((eng.sp_degree, token.shape[0]))
            return dec(token, caches)
        eng._prefill, eng._decode = prefill, decode

    def expected(self, cfg, params, ticks):
        parts = [TL.serve_contract(cfg, n, params, PLAN, prefill=(b, s))
                 for n, b, s in self.prefills]
        parts += [TL.serve_contract(cfg, n, params, PLAN, decode=r)
                  for n, r in self.decodes]
        parts.append(TL.serve_contract(cfg, 1, params, PLAN, ticks=ticks))
        self.prefills, self.decodes = [], []
        return contract(*parts)


def gathered(pool) -> dict:
    """The pool's leaves whole (not counted: the counters are reset
    after)."""
    if pool.ctx is None:
        return flatten(pool.caches)
    return flatten(unshard_params(pool.caches,
                                  cache_pspecs(pool.caches, pool.plan),
                                  pool.ctx))


def static_cases(out, cname, cfg, params, raw):
    prompts = torch.from_numpy(raw["prompts"]).long()
    eos = int(raw[f"{cname}/eos"])
    for shape in MESHES:
        key = f"{cname}/{label(shape)}"
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh,
                            plan=PLAN, device="cpu")
        ctx = eng.sharder.ctx
        out[f"{key}/coord"] = np.array([ctx.dp_index, ctx.sp_index])
        out[f"{key}/schedule"] = np.array(eng.schedule.dims)
        specs = cache_pspecs(TL.init_caches(cfg, 1, MAX_LEN, device="cpu"),
                             PLAN)["periods"]
        for path, spec in flatten(specs).items():
            out[f"{key}/cache_spec/{path}"] = np.array([str(e)
                                                        for e in spec])
        # a whole cache, every rank alike, cut to this rank's slices
        whole = TL.init_caches(cfg, BATCH, MAX_LEN, device="cpu")
        gen = torch.Generator().manual_seed(7)
        for leaf in TL.tree_leaves(whole["periods"]):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        rows = BATCH // shape[0]
        start, stop = kv_block(ctx, PLAN, MAX_LEN)
        want = flatten(whole["periods"])
        ok = []
        for path, got in flatten(eng.shard_caches(whole)["periods"]).items():
            w = want[path].narrow(1, ctx.dp_index * rows, rows)
            if is_kv_leaf(tuple(path.split("/")), w):
                w = w.narrow(KV_SEQ_DIM, start, stop - start)
            elif path.endswith("state"):
                h = w.shape[2] // shape[1]
                w = w.narrow(2, ctx.sp_index * h, h)
            ok.append(torch.equal(got, w))
        out[f"{key}/shard_caches"] = np.array(ok)
        dsp.reset_calls()
        logits, caches = eng._prefill(prompts[:, :SEQ])
        eng.next_tokens(logits)
        out[f"{key}/prefill"] = logits
        out[f"{key}/prefill_counts"] = counts()
        out[f"{key}/prefill_contract"] = contract(TL.serve_contract(
            cfg, shape[1], params, PLAN, dp=shape[0],
            prefill=(BATCH, SEQ)))
        logits, _ = eng._decode(prompts[:, SEQ:SEQ + 1], caches)
        eng.next_tokens(logits)
        out[f"{key}/decode"] = logits
        out[f"{key}/decode_counts"] = counts()
        out[f"{key}/decode_contract"] = contract(TL.serve_contract(
            cfg, shape[1], params, PLAN, dp=shape[0], decode=BATCH))
        for zero in (True, False):
            eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh,
                                plan=ParallelPlan(mode="dsp", zero=zero,
                                                  shard_vocab=zero),
                                device="cpu")
            out[f"{key}/generate/zero{int(zero)}"] = eng.generate(
                prompts[:, :SEQ], list(BUDGETS), eos_id=eos, pad_id=-1,
                check_sharding=True)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh, plan=PLAN,
                        device="cpu")
    alone = ServingEngine(params, cfg, max_len=MAX_LEN, device="cpu")
    for n in SHORT:
        out[f"{cname}/short{n}"] = eng.generate(prompts[:2, :n], SHORT_NEW,
                                                check_sharding=True)
        out[f"{cname}/short{n}/alone"] = alone.generate(prompts[:2, :n],
                                                        SHORT_NEW)


def poisson_case(out, cname, cfg, params, raw):
    """The continuous scheduler on (1, 4) over a Poisson trace on the
    wall clock: every rank admits by rank 0's clock."""
    prompts = torch.from_numpy(raw["prompts"]).long()
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh, plan=PLAN,
                        device="cpu")
    rec = Recorder(eng)
    arrivals = np.cumsum(np.random.RandomState(0).exponential(
        ARRIVAL, size=BATCH))
    reqs = [Request(prompt=prompts[i, :SEQ], max_new_tokens=m,
                    arrival_time=float(arrivals[i]), request_id=i)
            for i, m in enumerate(CONT_BUDGETS)]
    sched = ContinuousScheduler(eng, max_batch=2)
    dsp.reset_calls()
    sched.run(reqs)
    out[f"{cname}/poisson/counts"] = counts()
    out[f"{cname}/poisson/contract"] = rec.expected(cfg, params, sched.ticks)
    out[f"{cname}/poisson/ticks"] = np.array(sched.ticks)
    for r in reqs:
        out[f"{cname}/poisson/{r.request_id}"] = np.array(r.generated)


def replan_case(out, cname, cfg, params, raw):
    """2 slots on (1, 4), ``replan(2)`` at decode step 3 with slots live;
    the pool asserted on the mesh after every step."""
    prompts = torch.from_numpy(raw["prompts"]).long()
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh, plan=PLAN,
                        device="cpu")
    rec = Recorder(eng)
    reqs = [Request(prompt=prompts[i, :SEQ], max_new_tokens=m,
                    request_id=i) for i, m in enumerate(CONT_BUDGETS)]
    sched = ContinuousScheduler(eng, max_batch=2)
    key = f"{cname}/replan"
    seen = []

    def on_step(s, k):
        s.pool.assert_on_mesh()
        if k != 3:
            return
        out[f"{key}/before/counts"] = counts()
        out[f"{key}/before/contract"] = rec.expected(cfg, params, s.ticks)
        ticks = s.ticks
        before = gathered(s.pool)
        dsp.reset_calls()
        s.replan(2)
        out[f"{key}/migrate/counts"] = counts()
        out[f"{key}/migrate/contract"] = contract(TL.serve_contract(
            cfg, 4, params, PLAN, migrate=(2, MAX_LEN, 2)))
        if eng.active:
            after = gathered(s.pool)
            out[f"{key}/moved_equal"] = np.array(
                [torch.equal(before[p], after[p]) for p in before])
            out[f"{key}/sp_after"] = np.array(eng.sp_degree)
        dsp.reset_calls()
        seen.append((k, ticks))

    dsp.reset_calls()
    sched.run(reqs, on_step=on_step)
    if eng.active:
        out[f"{key}/after/counts"] = counts()
        out[f"{key}/after/contract"] = rec.expected(
            cfg, params, sched.ticks - seen[0][1])
        out[f"{key}/slots_allocated"] = np.array(
            sched.metrics.slots_allocated)
        for r in reqs:
            out[f"{key}/{r.request_id}"] = np.array(r.generated)
        sched.replan(1)
        out[f"{key}/replan1_mesh_none"] = np.array(
            eng.mesh is None if eng.active else True)
    try:
        eng.replan(2)
        raised = False
    except NotImplementedError:
        raised = True
    out[f"{key}/regrow_raised"] = np.array(raised)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        for cname, cfg in configs(TL, TSSM, torch.float32).items():
            params = bridge.params_from_numpy(unflatten(dict(np.load(
                os.path.join(work, f"params_{cname}.npz")))), device="cpu")
            static_cases(out, cname, cfg, params, raw)
            poisson_case(out, cname, cfg, params, raw)
            replan_case(out, cname, cfg, params, raw)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
