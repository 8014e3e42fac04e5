#!/usr/bin/env python3
"""Where the port's serving time goes on one GPU, at full width.

    python3 tools/profile_torch_serve.py [--arch qwen3-14b] [--depth N]
        [--prompt-len 2048]

Serves ``--arch`` (qwen3-14b or mamba2-370m; ``--depth`` defaults to the
config's own) and runs one prefill of ``--prompt-len`` tokens and
``--steps`` decode steps of a ``--batch``-slot pool under
``torch.profiler``, then prints the device time by kernel group (the
flash-attention kernels, the SSD scan kernels, matmuls, the rest), the
top kernels, the device busy share of each region (device kernel time
over host wall time, both after a synchronize), and the prefill's
launches of each kernel by route (``sm90`` or ``cuda_cores``).  Random
weights from seed 0, as in ``chip_smoke.py``.
"""
import argparse
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd, reset_launches)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kv_pool import KVPool  # noqa: E402

GROUPS = [("flash_attention", re.compile(r"flash_fwd")),
          ("ssd_scan", re.compile(r"ssd_scan")),
          ("matmul", re.compile(r"gemm|xmma|nvjet|cutlass|sm90_|cublas",
                                re.I))]


def group_of(name: str) -> str:
    for g, pat in GROUPS:
        if pat.search(name):
            return g
    return "other"


def region(name, fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
    groups = {}
    for k, ms in kernels.items():
        groups[group_of(k)] = groups.get(group_of(k), 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    out = {"region": name, "wall_ms": wall_ms, "device_ms": busy,
           "device_busy_share": busy / wall_ms, "groups_ms": groups,
           "top_kernels_ms": [[k[:80], ms] for k, ms in top]}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b",
                    choices=("qwen3-14b", "mamba2-370m"))
    ap.add_argument("--depth", type=int, default=None,
                    help="layers (default: the config's)")
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: CUDA is not available")
    import dataclasses
    cfg = configs.get(args.arch).config
    cfg = dataclasses.replace(cfg, n_layers=args.depth or cfg.n_layers)
    params = lm.init_lm(0, cfg, device="cuda")
    max_len = args.prompt_len + args.steps + 1
    eng = ServingEngine(params, cfg, max_len=max_len)
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (1, args.prompt_len), generator=g,
                           device="cuda")
    eng._prefill(prompt[:, :256])                       # warm up
    reset_launches()
    ssd_scan.reset_launches()
    region(f"prefill_{args.prompt_len}", lambda: eng._prefill(prompt))
    print(json.dumps({"flash_attention_launches_by_route":
                      flash_attention_fwd.route_launches,
                      "ssd_scan_launches_by_route":
                      ssd_scan.ssd_scan_fwd.route_launches}), flush=True)
    _, caches = eng._prefill(prompt)
    pool = KVPool(cfg, args.batch, max_len, device="cuda")
    for slot in range(args.batch):
        pool.insert(slot, caches, args.prompt_len)
    token = torch.zeros((args.batch, 1), dtype=torch.long, device="cuda")

    def steps():
        c = pool.caches
        for _ in range(args.steps):
            _, c = eng._decode(token, c)
        pool.caches = c

    eng._decode(token, pool.caches)                     # warm up
    region(f"decode_b{args.batch}_x{args.steps}", steps)


if __name__ == "__main__":
    main()
