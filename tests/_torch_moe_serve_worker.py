"""One rank of the port's MoE-serving-on-a-mesh checks over gloo on the
CPU.

    python tests/_torch_moe_serve_worker.py <rank> <world> <dir>

``tests/test_torch_moe_serving_dsp.py`` starts ``world`` (4) of these on
one ``FileStore`` in ``dir``, which also holds the inputs
(``params_<config>.npz``, JAX's init of arctic-480b's and
qwen2-moe-a2.7b's SMOKE configs, and ``inputs.npz``).  The rank writes
``dir/rank<r>.npz``:

* for each config and each plan of ``_torch_moe_serve_jax.PLANS``, at
  ``MESH``: the prefill's logits (the rank's vocab chunk) with each MoE
  call's experts for its tokens (``chip_smoke.moe_calls``), one decode
  step's logits, each with its argmax's, calls and bytes (the decode
  step's beside ``lm.serve_contract``), ``generate``'s tokens, and, with
  the router biased (``_torch_moe_serve_jax.biased``), the prefill's
  logits at a ``SHORT``-token prompt the ranks do not divide, and under
  the continuous run's plan its ``generate``;
* for each config under its pools' plans (``POOLS``): the continuous
  scheduler with 2 slots and ``replan(2)`` at decode step 3 (the pool
  gathered before and after, the move's calls beside its contract), and
  the paged scheduler in ``BLOCK``-token blocks and ``CHUNK``-token
  prefill slices;
* arctic at (2, 2) under ``tp`` + ``ep`` without ZeRO (the experts over
  ``model``, each expert's hidden columns over ``data``): ``generate``,
  and a decode step's calls beside its contract.

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
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.parallel.partition import (  # noqa: E402
    ParallelPlan, cache_pspecs, unshard_params)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousScheduler, PagedScheduler)

from chip_smoke import moe_calls  # noqa: E402
from _torch_dsp_jax import flatten, unflatten  # noqa: E402
from _torch_lmdsp_worker import KINDS  # noqa: E402
from _torch_moe_serve_jax import (BATCH, BLOCK, CHUNK,  # noqa: E402
                                  CONT_BUDGETS, MAX_LEN, MESH, NEW, PLANS,
                                  PROMPT, SHORT, biased)
from _torch_moe_tp_jax import configs  # noqa: E402

# config -> (the continuous run's plan, the paged run's plan)
POOLS = {"arctic": ("tp_ep", "tp"), "qwen2moe": ("dsp_ep", "dsp")}


def plan_of(name: str, **kw) -> ParallelPlan:
    mode, ep = PLANS[name]
    return ParallelPlan(mode=mode, ep=ep, **kw)


def counts() -> np.ndarray:
    """(calls, bytes) by ``KINDS`` since the last reset; resets."""
    out = np.array([[dsp.calls.get(k, 0) for k in KINDS],
                    [dsp.volume.get(k, 0) for k in KINDS]], dtype=np.int64)
    dsp.reset_calls()
    return out


def contract(c) -> np.ndarray:
    return np.array([[c["calls"].get(k, 0) for k in KINDS],
                     [c["bytes"].get(k, 0) for k in KINDS]], dtype=np.int64)


def requests(prompts):
    return [Request(prompt=prompts[i % BATCH, :PROMPT], max_new_tokens=m,
                    request_id=i) for i, m in enumerate(CONT_BUDGETS)]


def plan_cases(out, cname, cfg, whole, skewed, prompts, mesh):
    n = MESH[1]
    for pname in PLANS:
        plan = plan_of(pname)
        key = f"{cname}/{pname}"
        eng = ServingEngine(whole, cfg, max_len=MAX_LEN, mesh=mesh,
                            plan=plan, device="cpu")
        out[f"{key}/coord"] = np.array([eng.sharder.dp_index,
                                        eng.sharder.sp_index])
        dsp.reset_calls()
        with moe_calls() as calls:
            logits, caches = eng._prefill(prompts[:, :PROMPT])
        eng.next_tokens(logits)
        out[f"{key}/prefill"] = logits
        out[f"{key}/prefill_counts"] = counts()
        for i, call in enumerate(calls):
            out[f"{key}/route{i}/experts"] = call["experts"]
        logits, _ = eng._decode(prompts[:, PROMPT:PROMPT + 1], caches)
        eng.next_tokens(logits)
        out[f"{key}/decode"] = logits
        out[f"{key}/decode_counts"] = counts()
        out[f"{key}/decode_contract"] = contract(TL.serve_contract(
            cfg, n, whole, plan, decode=BATCH))
        out[f"{key}/generate"] = eng.generate(prompts[:, :PROMPT], NEW,
                                              check_sharding=True)
        eng = ServingEngine(skewed, cfg, max_len=MAX_LEN, mesh=mesh,
                            plan=plan, device="cpu")
        logits, _ = eng._prefill(prompts[:, :SHORT])
        out[f"{key}/short_prefill"] = logits
        if pname == POOLS[cname][0]:
            out[f"{cname}/short_generate"] = eng.generate(
                prompts[:, :SHORT], NEW)


def gathered(pool) -> dict:
    return flatten(unshard_params(pool.caches,
                                  cache_pspecs(pool.caches, pool.plan),
                                  pool.ctx))


def pool_cases(out, cname, cfg, whole, prompts, mesh):
    cont, paged = POOLS[cname]
    n = MESH[1]
    eng = ServingEngine(whole, cfg, max_len=MAX_LEN, mesh=mesh,
                        plan=plan_of(cont), device="cpu")
    reqs = requests(prompts)

    def on_step(s, k):
        s.pool.assert_on_mesh()
        if k != 3:
            return
        before = gathered(s.pool)
        dsp.reset_calls()
        s.replan(2)
        out[f"{cname}/migrate_counts"] = counts()
        out[f"{cname}/migrate_contract"] = contract(TL.serve_contract(
            cfg, n, whole, plan_of(cont), migrate=(2, MAX_LEN, 2)))
        if eng.active:
            after = gathered(s.pool)
            out[f"{cname}/moved_equal"] = np.array(
                [torch.equal(before[p], after[p]) for p in before])
            out[f"{cname}/sp_after"] = np.array(eng.sp_degree)

    ContinuousScheduler(eng, max_batch=2).run(reqs, on_step=on_step)
    if eng.active:
        for r in reqs:
            out[f"{cname}/continuous/{r.request_id}"] = np.array(r.generated)

    eng = ServingEngine(whole, cfg, max_len=MAX_LEN, mesh=mesh,
                        plan=plan_of(paged), device="cpu")
    reqs = requests(prompts)
    sched = PagedScheduler(eng, max_batch=2, block_size=BLOCK,
                           prefill_chunk=CHUNK)
    sched.run(reqs)
    sched.pool.assert_on_mesh()
    for r in reqs:
        out[f"{cname}/paged/{r.request_id}"] = np.array(r.generated)


def data_case(out, cfg, whole, prompts):
    """arctic at (2, 2) under ``tp`` + ``ep`` without ZeRO."""
    plan = plan_of("tp_ep", zero=False)
    eng = ServingEngine(whole, cfg, max_len=MAX_LEN,
                        mesh=make_mesh((2, 2), ("data", "model"), "cpu"),
                        plan=plan, device="cpu")
    out["2x2/expert_shape"] = np.array(
        eng.params["periods"]["0"]["moe"]["wi"].shape)
    _, caches = eng._prefill(prompts[:, :PROMPT])
    dsp.reset_calls()
    logits, _ = eng._decode(prompts[:, PROMPT:PROMPT + 1], caches)
    eng.next_tokens(logits)
    out["2x2/decode_counts"] = counts()
    out["2x2/decode_contract"] = contract(TL.serve_contract(
        cfg, 2, whole, plan, dp=2, decode=BATCH))
    out["2x2/generate"] = eng.generate(prompts[:, :PROMPT], NEW,
                                       check_sharding=True)


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world)
    out = {}
    try:
        cfgs = configs("repro_torch")
        prompts = torch.from_numpy(dict(np.load(os.path.join(
            work, "inputs.npz")))["prompts"]).long()
        mesh = make_mesh(MESH, ("data", "model"), "cpu")
        for cname, cfg in cfgs.items():
            whole = bridge.params_from_numpy(unflatten(dict(np.load(
                os.path.join(work, f"params_{cname}.npz")))), device="cpu")
            skewed = bridge.params_from_numpy(biased(unflatten(dict(np.load(
                os.path.join(work, f"params_{cname}.npz"))))), device="cpu")
            plan_cases(out, cname, cfg, whole, skewed, prompts, mesh)
            pool_cases(out, cname, cfg, whole, prompts, mesh)
            if cname == "arctic":
                data_case(out, cfg, whole, prompts)
    finally:
        # no rank leaves while another's gloo threads still talk to it
        dist.barrier()
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else v) for k, v in out.items()})


if __name__ == "__main__":
    main()
