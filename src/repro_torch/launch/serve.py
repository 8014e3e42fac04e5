"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id>``.

Initialises the architecture's SMOKE config with random weights from a
seed, as the JAX package's CLI does, and serves it on one device:

* default — the static batch reference path (one lockstep ``generate``);
* ``--continuous`` — the continuous-batching scheduler: ``--max-batch``
  recycled slots, a Poisson arrival trace (``--arrival`` = mean
  inter-arrival seconds; 0 = all at once), per-token streaming
  (``--stream``), and a metrics JSON (TTFT/TPOT/queue-wait percentiles,
  throughput, slot occupancy) printed and optionally written to
  ``--metrics PATH``.

``--device`` defaults to ``cuda``.  The JAX CLI's sharded, elastic,
paged and checkpoint flags are not ported yet and exit with a message.
"""
import argparse
import json

NOT_PORTED = ("devices", "mode", "topology", "replan", "paged", "ckpt_dir")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4,
                    help="request count (static: one batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching scheduler")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots in the KV pool (continuous)")
    ap.add_argument("--arrival", type=float, default=0.0,
                    help="mean inter-arrival seconds of the Poisson request "
                    "trace (continuous mode; 0 = all arrive at once)")
    ap.add_argument("--stream", action="store_true",
                    help="print every generated token as it is emitted")
    ap.add_argument("--metrics", default=None,
                    help="write the engine metrics JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu for tests)")
    for flag in NOT_PORTED:
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help="not yet ported")
    args = ap.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag.replace('_', '-')}: not yet ported")

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.models.lm import init_lm
    from repro_torch.serving.engine import Request, ServingEngine

    spec = configs.get(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"the serve CLI covers the LM family, "
                         f"{args.arch} is {spec.family}")
    cfg = spec.smoke
    device = resolve_device(args.device)
    params = init_lm(0, cfg, device=device)
    eng = ServingEngine(params, cfg, max_len=args.prompt_len + args.new_tokens,
                        device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    if args.continuous:
        from repro_torch.serving.scheduler import ContinuousScheduler
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
                print(f"req{req.request_id} += {tok}", flush=True)
        sched = ContinuousScheduler(eng, max_batch=args.max_batch)
        sched.run(reqs, stream=stream)
        sched.metrics.extra.update({"n_devices": 1, "mode": "none",
                                    "device": str(device)})
        print(sched.metrics.to_json(args.metrics))
        for r in reqs:
            print(f"req{r.request_id} [{r.result.finish_reason}] "
                  f"ttft={r.result.metrics.ttft:.3f}s: {r.generated}")
        return reqs

    out = eng.generate(prompts, max_new_tokens=args.new_tokens)
    for i in range(args.batch):
        print(f"serve[{device}] req{i}: prompt={prompts[i].tolist()[:8]}... "
              f"generated={out[i].tolist()}")
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump({"mode": "none", "n_devices": 1,
                       "device": str(device)}, f, indent=2)
    return out


if __name__ == "__main__":
    main()
