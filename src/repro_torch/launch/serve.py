"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id>``.

Initialises the architecture's SMOKE config with random weights from a
seed, as the JAX package's CLI does, and serves it through the plan-aware
``ServingEngine``:

* default — the static batch reference path (one lockstep ``generate``);
  ``--replan M`` then resizes the engine onto the first M ranks and serves
  the same prompts again, printing whether the output is identical;
* ``--continuous`` — the continuous-batching scheduler: ``--max-batch``
  recycled slots, a Poisson arrival trace (``--arrival`` = mean
  inter-arrival seconds; 0 = all at once), per-token streaming
  (``--stream``), and a metrics JSON (TTFT/TPOT/queue-wait percentiles,
  throughput, slot occupancy, the priced fabric) printed and optionally
  written to ``--metrics PATH``;
* ``--paged`` — the paged scheduler on the same trace: ``--block-size``
  token KV blocks, the radix prefix cache (``--prefix-cache`` /
  ``--no-prefix-cache``) and chunked prefill (``--prefill-chunk`` tokens a
  slice), with a summary line of the blocks, the prefix hit rate and the
  chunks beside the metrics JSON.

Under ``torchrun`` with ``--mode dsp`` (the default) the ranks serve
sharded on a ``(--data, world / --data)`` process mesh (NCCL on the
card, gloo on the CPU; ``--backend gloo`` lets several ranks share one
card): the KV caches sequence-sharded over ``model``, asserted on the
mesh, the plan priced on ``--topology`` (``uniform``, the byte model, or
``profile:<path>``, ``Topology.from_profile`` of timed all-gathers):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch qwen3-14b --continuous --arrival 0.01

``--mode tp`` serves under ``ParallelPlan(mode="tp")`` as the JAX CLI
does, static, ``--continuous`` or ``--paged``: column- and row-parallel
attention and MLP, the same sequence-sharded KV caches, no switching
schedule:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch mistral-large-123b --mode tp --continuous

MoE configs (qwen2-moe-a2.7b, arctic-480b) serve under either mode: a
decode step's tokens are whole on every rank, which routes them all and
runs whatever of each expert it holds (every expert under ``dsp``, its
hidden columns under ``tp``), the partials summed with the block's:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch arctic-480b --mode tp --continuous

Rank 0 prints the summary in one write.  ``--ckpt-dir DIR`` serves the
parameters of the latest checkpoint in DIR (``train.checkpoint``, either
package's), restored onto the engine's layout.  ``--device`` defaults to
``cuda``.  The JAX CLI's TPU topology presets and ``--hosts``, and
``--devices`` (``torchrun --nproc-per-node`` starts the ranks) exit with
a message.
"""
import argparse
import json
import os
import sys


def topology_facts(topo, schedule) -> dict:
    """The fabric facts the metrics JSON records: the per-link model
    (``launch.mesh.topology_meta``) and what the planner priced on it."""
    from repro_torch.launch.mesh import topology_meta
    out = topology_meta(topo)
    if topo is not None and schedule is not None:
        out["planned_switches"] = schedule.n_switches()
        out["planned_seconds_per_step"] = schedule.per_device_seconds()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="request count (static: one batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--mode", default="dsp", choices=["dsp", "tp", "none"],
                    help="the model dim's role when serving sharded")
    ap.add_argument("--topology", default="uniform",
                    help="link model of the SP dim: uniform or "
                    "profile:<path> (measured all-gather samples)")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel dim size (model = world / data)")
    ap.add_argument("--replan", type=int, default=0,
                    help="after serving, resize onto this many ranks and "
                    "serve again (static mode)")
    ap.add_argument("--backend", default=None, choices=["gloo", "nccl"],
                    help="process-group backend (default: the device's)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching scheduler")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged scheduler (block-pool KV, "
                    "radix prefix cache, chunked prefill)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block (paged mode)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share prompt-prefix KV blocks via the radix tree "
                    "(paged mode)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per chunked-prefill slice (paged "
                    "mode; default: one slice per prompt)")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots in the KV pool (continuous/paged)")
    ap.add_argument("--arrival", type=float, default=0.0,
                    help="mean inter-arrival seconds of the Poisson request "
                    "trace (continuous mode; 0 = all arrive at once)")
    ap.add_argument("--stream", action="store_true",
                    help="print every generated token as it is emitted")
    ap.add_argument("--metrics", default=None,
                    help="write the engine metrics JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu for tests)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the parameters of this directory's latest "
                    "checkpoint")
    ap.add_argument("--hosts", type=int, default=None,
                    help="not ported (the JAX CLI's ici_dcn host count)")
    ap.add_argument("--devices", type=int, default=None,
                    help="not ported: torchrun --nproc-per-node")
    args = ap.parse_args(argv)
    if args.devices is not None:
        raise SystemExit("--devices: not yet ported; torchrun "
                         "--nproc-per-node N starts the port's N ranks")
    if args.hosts is not None:
        raise SystemExit("--hosts: not yet ported; it sizes the JAX "
                         "package's TPU preset ici_dcn (ROADMAP queue 1, "
                         "standing notes)")

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh, resolve_topology
    from repro_torch.models.lm import init_lm
    from repro_torch.parallel.partition import ParallelPlan
    from repro_torch.serving.engine import Request, ServingEngine

    spec = configs.get(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"the serve CLI covers the LM family, "
                         f"{args.arch} is {spec.family}")
    cfg = spec.smoke
    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = topo = None
    plan = ParallelPlan(mode="none")
    if args.mode != "none" and world > 1:
        if world % args.data:
            raise SystemExit(f"{world} ranks not divisible by --data "
                             f"{args.data}")
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                                  % torch.cuda.device_count())
        mesh = make_mesh((args.data, world // args.data), ("data", "model"),
                         device.type, backend=args.backend)
        try:
            topo = resolve_topology(args.topology, world // args.data)
        except ValueError as e:
            raise SystemExit(f"--topology: {e}")
        plan = ParallelPlan(mode=args.mode)
    rank = dist.get_rank() if dist.is_initialized() else 0
    lines = []
    params = init_lm(0, cfg, device=device)
    max_len = args.prompt_len + args.new_tokens
    sp = world // args.data if mesh is not None else 1
    # the sequence-sharded cache's blocks; paged: whole KV blocks
    max_len += (-max_len) % (args.block_size if args.paged else sp)
    eng = ServingEngine(params, cfg, max_len=max_len, mesh=mesh, plan=plan,
                        topology=topo, device=device)
    if args.ckpt_dir:
        from repro_torch.train.checkpoint import CheckpointManager
        step, tree = CheckpointManager(args.ckpt_dir).restore(
            {"params": params}, specs=(
                None if eng.sharder.param_specs is None
                else {"params": eng.sharder.param_specs}),
            ctx=eng.sharder.ctx, device=device)
        eng.params = tree["params"]
        lines.append(f"restored step {step}")
    del params
    if mesh is not None:
        lines.append(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}; "
                     f"plan {plan}" + ("" if eng.schedule is None else
                                       f"; planned switches "
                                       f"{eng.schedule.n_switches()}"))
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    facts = {"n_devices": world if mesh is not None else 1,
             "mode": plan.mode, "device": str(device),
             **topology_facts(topo, eng.schedule)}

    def emit():
        # rank 0 alone, in one write: the ranks under torchrun share the
        # stream, and a write of under PIPE_BUF bytes is not interleaved
        if rank == 0:
            sys.stdout.write("".join(line + "\n" for line in lines))
            sys.stdout.flush()

    if args.continuous or args.paged:
        from repro_torch.serving.scheduler import (ContinuousScheduler,
                                                   PagedScheduler)
        rng = np.random.RandomState(0)
        gaps = (rng.exponential(args.arrival, size=args.batch)
                if args.arrival > 0 else np.zeros(args.batch))
        arrivals = np.cumsum(gaps)
        reqs = [Request(prompt=prompts[i], max_new_tokens=args.new_tokens,
                        arrival_time=float(arrivals[i]), request_id=i)
                for i in range(args.batch)]
        stream = None
        if args.stream:
            def stream(req, tok):
                if rank == 0:
                    print(f"req{req.request_id} += {tok}", flush=True)
        if args.paged:
            sched = PagedScheduler(eng, max_batch=args.max_batch,
                                   block_size=args.block_size,
                                   prefix_cache=args.prefix_cache,
                                   prefill_chunk=args.prefill_chunk)
        else:
            sched = ContinuousScheduler(eng, max_batch=args.max_batch)
        sched.run(reqs, stream=stream)
        if mesh is not None:
            sched.pool.assert_on_mesh()
            lines.append(f"KV pool sequence-sharded over "
                         f"{eng.sp_degree}-way model dim: OK")
        sched.metrics.extra.update(facts)
        lines.append(sched.metrics.to_json(args.metrics if rank == 0
                                           else None))
        if args.paged:
            s = sched.metrics.summary()
            hit = s["prefix_hit_rate"]
            lines.append(f"paged: {sched.pool.n_blocks - 1} blocks x "
                         f"{sched.pool.block_size} tokens, peak in use "
                         f"{s['peak_blocks_in_use']}, prefix hit rate "
                         f"{'-' if hit is None else f'{hit:.0%}'}, "
                         f"{s['prefill_chunk_steps']} prefill chunks")
        lines.extend(f"req{r.request_id} [{r.result.finish_reason}] "
                     f"ttft={r.result.metrics.ttft:.3f}s: {r.generated}"
                     for r in reqs)
        emit()
        return reqs

    def run(tag):
        out = eng.generate(prompts, max_new_tokens=args.new_tokens,
                           check_sharding=True)
        if eng.mesh is not None:
            lines.append(f"{tag}: KV caches sequence-sharded over "
                         f"{eng.sp_degree}-way model dim: OK")
        lines.extend(f"{tag} req{i}: prompt={prompts[i].tolist()[:8]}... "
                     f"generated={out[i].tolist()}"
                     for i in range(args.batch))
        return out

    out = run(f"serve[{device}, {facts['n_devices']} rank(s)]")
    if args.metrics and rank == 0:
        with open(args.metrics, "w") as f:
            json.dump(facts, f, indent=2)
    if args.replan:
        eng.replan(args.replan)
        if eng.active:
            out2 = run(f"replan[{args.replan} rank(s)]")
            lines.append(f"replan output identical: "
                         f"{bool(torch.equal(out, out2))}")
    emit()
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import close_world
    main()
    close_world()
