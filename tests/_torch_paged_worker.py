"""One rank of the port's sharded paged-serving checks over gloo on the CPU.

    python tests/_torch_paged_worker.py <rank> <world> <dir>

``tests/test_torch_paged_dsp.py`` starts ``world`` (4) of these on one
``FileStore`` in ``dir``, which also holds the inputs (``params.npz``,
``inputs.npz``).  On a (1, 4) mesh under ``ParallelPlan(mode="dsp")`` a
rank writes to ``dir/rank<r>.npz``: its coordinate, the block pool's
``cache_pspecs(paged=True)``; the pool case of ``_torch_paged_jax`` (its
logits of each chunk and of the decode step, each segment's calls and
bytes beside ``lm.serve_contract``'s, and a slot-pool decode step's at
the same batch); then the paged trace through ``PagedScheduler`` with
chunked prefill and prefix hits, the pool asserted on the mesh after every
step and ``replan(2)`` at the first decode step with a prefill mid-prompt
(the blocks gathered before and after, the tables and ref counts), each
segment's calls beside the contract's, and the tokens."""
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
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, cache_pspecs, unshard_params)
from repro_torch.serving.block_pool import BlockPool  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import KVPool  # noqa: E402
from repro_torch.serving.scheduler import PagedScheduler  # noqa: E402

from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_paged_jax import (BLOCK, BUDGETS, MAX_LEN,  # noqa: E402
                              POOL_CHUNKS, POOL_PROMPTS, SLOTS, SP,
                              TRACE_CHUNK, config, trace_prompts)
from _torch_serve_worker import contract, counts  # noqa: E402

PLAN = ParallelPlan(mode="dsp")
REPLAN_TO = 2


def pool_case(out, cfg, params, raw, mesh):
    """The chunks of two prompts into a block pool, one decode step of
    both slots, each step's logits and calls; then a slot pool's decode
    step at the same batch."""
    eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh, plan=PLAN,
                        device="cpu")
    ctx = eng.sharder.ctx
    out["coord"] = np.array([ctx.dp_index, ctx.sp_index])
    pool = BlockPool(cfg, SLOTS, MAX_LEN, block_size=BLOCK, mesh=mesh,
                     plan=PLAN, device="cpu")
    for path, spec in flatten(cache_pspecs(pool.caches, PLAN,
                                           paged=True)).items():
        out[f"spec/{path}"] = np.array([str(e) for e in spec])
    prompts = torch.from_numpy(raw["pool_prompts"]).long()
    last = []
    dsp.reset_calls()
    for i, (n, widths) in enumerate(zip(POOL_PROMPTS, POOL_CHUNKS)):
        slot = pool.bind(pool.alloc_blocks(pool.blocks_for(n + 4)), 0)
        done = 0
        for j, c in enumerate(widths):
            logits, pool.caches = eng._chunk(prompts[i:i + 1, done:done + c],
                                             pool.caches, slot, done)
            eng.next_tokens(logits)
            out[f"chunk{i}.{j}"] = logits
            out[f"chunk{i}.{j}/counts"] = counts()
            out[f"chunk{i}.{j}/contract"] = contract(TL.serve_contract(
                cfg, SP, params, PLAN, chunk=c, first_tokens=1))
            done += c
        last.append(int(raw["pool_next"][i]))
    pool.assert_on_mesh()
    token = torch.tensor(last)[:, None]
    logits, pool.caches = eng._decode(token, pool.caches)
    eng.next_tokens(logits)
    out["decode"] = logits
    out["decode/counts"] = counts()
    out["decode/contract"] = contract(TL.serve_contract(
        cfg, SP, params, PLAN, decode=SLOTS))
    slots = KVPool(cfg, SLOTS, MAX_LEN, mesh=mesh, plan=PLAN, device="cpu")
    logits, _ = eng._decode(token, slots.caches)
    eng.next_tokens(logits)
    out["slot_decode/counts"] = counts()


class Recorder:
    """Wraps an engine's chunk and decode steps and its argmax to log what
    each ran on: (SP degree, tokens) a chunk, (SP degree, rows) a decode
    step (whose argmax ``serve_contract(decode=)`` counts), the SP degree
    of each argmax outside a decode step (a prompt's first token)."""

    def __init__(self, eng):
        self.chunks, self.decodes, self.firsts = [], [], []
        self._decoded = False
        chunk, dec, argmax = eng._chunk, eng._decode, eng.next_tokens

        def chunk_step(tokens, caches, slot, start):
            self.chunks.append((eng.sp_degree, tokens.shape[1]))
            return chunk(tokens, caches, slot, start)

        def decode(token, caches):
            self.decodes.append((eng.sp_degree, token.shape[0]))
            self._decoded = True
            return dec(token, caches)

        def next_tokens(logits):
            if not self._decoded:
                self.firsts.append(eng.sp_degree)
            self._decoded = False
            return argmax(logits)
        eng._chunk, eng._decode, eng.next_tokens = (chunk_step, decode,
                                                    next_tokens)

    def expected(self, cfg, params, ticks):
        parts = [TL.serve_contract(cfg, n, params, PLAN, chunk=c)
                 for n, c in self.chunks]
        parts += [TL.serve_contract(cfg, n, params, PLAN, decode=r)
                  for n, r in self.decodes]
        parts += [TL.serve_contract(cfg, n, params, PLAN, first_tokens=1)
                  for n in self.firsts]
        parts.append(TL.serve_contract(cfg, 1, params, PLAN, ticks=ticks))
        self.chunks, self.decodes, self.firsts = [], [], []
        return contract(*parts)


def gathered(pool) -> dict:
    """The pool's KV leaves whole (not counted: the counters are reset
    after)."""
    if pool.ctx is None:
        return flatten(pool.caches["periods"])
    return flatten(unshard_params(
        pool.caches, cache_pspecs(pool.caches, pool.plan, paged=True),
        pool.ctx)["periods"])


def trace_case(out, cfg, params, raw, mesh):
    """The paged trace on (1, 4): chunked prefill, prefix hits, the pool
    asserted after every step, ``replan(2)`` with a prefill mid-prompt."""
    eng = ServingEngine(params, cfg, max_len=MAX_LEN, mesh=mesh, plan=PLAN,
                        device="cpu")
    rec = Recorder(eng)
    reqs = [Request(prompt=torch.from_numpy(p).long(), max_new_tokens=m,
                    request_id=i)
            for i, (p, m) in enumerate(zip(trace_prompts(raw), BUDGETS))]
    sched = PagedScheduler(eng, max_batch=SLOTS, block_size=BLOCK,
                           prefill_chunk=TRACE_CHUNK)
    seen = {}

    def on_step(s, k):
        s.pool.assert_on_mesh()
        if seen or not s._prefilling:
            return
        pf = s._prefilling[0]
        if not 0 < pf.done < len(pf.prompt):
            return
        out["replan/before/counts"] = counts()
        out["replan/before/contract"] = rec.expected(cfg, params, s.ticks)
        seen["step"], seen["ticks"] = k, s.ticks
        out["replan/at"] = np.array([k, pf.done, len(pf.prompt)])
        before = gathered(s.pool)
        table, ref = s.pool.caches["table"].clone(), s.pool.ref.copy()
        dsp.reset_calls()
        s.replan(REPLAN_TO)
        out["replan/migrate/counts"] = counts()
        out["replan/migrate/contract"] = contract(TL.serve_contract(
            cfg, SP, params, PLAN, paged_migrate=(
                SLOTS, MAX_LEN, BLOCK, s.pool.n_blocks, REPLAN_TO)))
        if eng.active:
            after = gathered(s.pool)
            out["replan/moved_equal"] = np.array(
                [torch.equal(before[p], after[p]) for p in before])
            out["replan/host_state_equal"] = np.array(
                torch.equal(s.pool.caches["table"], table)
                and (s.pool.ref == ref).all())
            out["replan/sp_after"] = np.array(eng.sp_degree)
        dsp.reset_calls()

    dsp.reset_calls()
    sched.run(reqs, on_step=on_step)
    if eng.active:
        out["replan/after/counts"] = counts()
        out["replan/after/contract"] = rec.expected(
            cfg, params, sched.ticks - seen["ticks"])
        m = sched.metrics
        out["trace/metrics"] = np.array([m.prefix_hit_tokens,
                                         m.prefill_chunk_steps,
                                         m.slots_allocated])
        for r in reqs:
            out[f"trace/{r.request_id}"] = np.array(r.generated)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert world == SP, world
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        raw = dict(np.load(os.path.join(work, "inputs.npz")))
        cfg = config(TL, torch.float32)
        params = bridge.params_from_numpy(unflatten(dict(np.load(
            os.path.join(work, "params.npz")))), device="cpu")
        mesh = make_mesh((1, SP), ("data", "model"), "cpu")
        pool_case(out, cfg, params, raw, mesh)
        trace_case(out, cfg, params, raw, mesh)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
