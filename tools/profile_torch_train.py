#!/usr/bin/env python3
"""Where the port's training step goes on one GPU, at full width.

    python3 tools/profile_torch_train.py [--arch mamba2-370m] [--depth N]
        [--batch 8] [--seq 4096] [--frames 16]

Trains ``--arch`` (mamba2-370m, qwen3-14b with e.g. ``--depth 4 --batch
1``, or transformer2d-720m, the 2D video DiT, at ``--batch`` (default 1)
x ``--frames`` x ``--seq`` patches; ``--depth`` defaults to the config's
own).  Runs one warm-up step and then one AdamW step of
``make_train_step`` (loss and grads through the kernels, checkpointed
periods, then the optimizer) under ``torch.profiler``, and prints the
device time by kernel group (the SSD scan kernel, the flash-attention
kernel, matmuls, the rest), the top kernels, the top operators by the
device time of the kernels they launched themselves (forward ops as
``aten::*``, backward ops under the autograd node that ran them), the
device busy share (device kernel time over host wall time, both after a
synchronize), each kernel's launches by route and the peak device
memory.  For the DiT it also reports, from CUDA events around each call
(so on the device's clock, gaps included), flash attention's forward
kernel and its backward recompute through ``attention_ref`` split by the
attended axis (spatial: length ``--seq``; temporal: ``--frames``), and
AdamW.  For a model with SSM layers it then times one layer's SSD scan
at the same shape, forward (the kernel) and backward (the f32 chunked
reference) apart, with CUDA events, on x, b and c sliced from one (B, L,
d_inner + 2 G S) tensor as ``models/ssm.py`` slices them from the conv
output.  Random weights from seed 0 and lm_shift batches, as in
``chip_smoke.py`` (video batches for the DiT, whose modulation keeps its
adaLN-zero init: the step runs the same kernels at the same shapes).
"""
import argparse
import dataclasses
import functools
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    reset_launches, ssd_scan_fwd)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer2d as t2d  # noqa: E402
from repro_torch.optim.adamw import OptConfig, init_opt_state  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

GROUPS = [("ssd_scan", re.compile(r"ssd_scan")),
          ("flash_attention", re.compile(r"flash_fwd")),
          ("matmul", re.compile(r"gemm|xmma|nvjet|cutlass|sm90_|cublas",
                                re.I))]


def group_of(name: str) -> str:
    for g, pat in GROUPS:
        if pat.search(name):
            return g
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m",
                    choices=("mamba2-370m", "qwen3-14b",
                             "transformer2d-720m"))
    ap.add_argument("--depth", type=int, default=None,
                    help="layers (default: the config's)")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (default 8; the DiT's videos: 1)")
    ap.add_argument("--seq", type=int, default=4096,
                    help="tokens (the DiT: patches a frame)")
    ap.add_argument("--frames", type=int, default=16,
                    help="the DiT's frames")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: CUDA is not available")
    spec = configs.get(args.arch)
    cfg = dataclasses.replace(spec.config,
                              n_layers=args.depth or spec.config.n_layers)
    dit = spec.family == "t2d"
    batch_size = args.batch or (1 if dit else 8)
    ocfg = OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=10)
    if dit:
        params = t2d.init_t2d(0, cfg, device="cuda")
        loss_fn = functools.partial(t2d.t2d_loss, cfg=cfg)
        dcfg = DataConfig(task="video", batch=batch_size,
                          temporal=args.frames, spatial=args.seq,
                          in_dim=cfg.in_dim)

        def data(s):
            return t2d.model_dtype_batch(make_batch(dcfg, s), cfg)
        shape = f"b{batch_size}_t{args.frames}_s{args.seq}"
    else:
        params = lm.init_lm(0, cfg, device="cuda")
        loss_fn = functools.partial(lm.lm_loss, cfg=cfg)
        dcfg = DataConfig(task="lm_shift", vocab=cfg.vocab, seq=args.seq,
                          batch=batch_size)

        def data(s):
            return make_batch(dcfg, s)
        shape = f"b{batch_size}_s{args.seq}"
    state = init_opt_state(params, ocfg)
    step = make_train_step(loss_fn, ocfg)
    params, state, _ = step(params, state, data(0))   # warm up
    batch = data(1)
    spans = Spans(args.seq, args.frames) if dit else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fa.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels, counts, ops = {}, {}, {}
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3
            counts[ev.key] = counts.get(ev.key, 0) + ev.count
        elif dev_us > 0:
            ops[ev.key] = ops.get(ev.key, 0.0) + dev_us / 1e3
    groups = {}
    for k, ms in kernels.items():
        groups[group_of(k)] = groups.get(group_of(k), 0.0) + ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "region": f"train_step_{args.arch}_d{cfg.n_layers}_{shape}",
        "loss": float(metrics["loss"]), "wall_ms": wall_ms,
        "peak_memory_gb": peak_gb,
        **({"spans_ms": spans.close()} if spans else {}),
        "device_ms": busy, "device_busy_share": busy / wall_ms,
        "groups_ms": groups, "kernel_launches": sum(counts.values()),
        "ssd_scan_launches_by_route": dict(ssd_scan_fwd.route_launches),
        "flash_attention_launches_by_route":
            dict(fa.flash_attention_fwd.route_launches),
        "top_kernels_ms": [[k[:80], ms, counts[k]] for k, ms in top],
        "top_ops_self_device_ms": [[k[:80], ms] for k, ms in top_ops]}),
        flush=True)
    del params, state, batch
    torch.cuda.empty_cache()
    if getattr(cfg, "ssm_cfg", None) is not None:
        ssd_layer(cfg, batch_size, args.seq)


class Spans:
    """CUDA events around every flash-attention forward launch and
    backward recompute, keyed by the attended length (``spatial``, the
    patches; ``temporal``, the frames), and around AdamW: device-clock
    milliseconds summed per key once ``close`` restores the wrapped
    functions."""

    def __init__(self, spatial: int, frames: int):
        self.names = {spatial: "spatial", frames: "temporal"}
        self.events = []
        self.saved = [(ops, "flash_attention_fwd"),
                      (ops._FlashAttention, "backward"),
                      (trainer, "apply_adamw")]
        self.saved = [(obj, name, obj.__dict__[name])
                      for obj, name in self.saved]
        fwd, bwd, adamw = (fn for _, _, fn in self.saved)
        ops.flash_attention_fwd = self.wrap(
            fwd, lambda q, *a, **kw: f"K1_{self.name(q)}")
        ops._FlashAttention.backward = staticmethod(self.wrap(
            bwd.__func__, lambda ctx, g: f"attention_ref_backward_"
                                         f"{self.name(g)}"))
        trainer.apply_adamw = self.wrap(adamw, lambda *a, **kw: "adamw")

    def name(self, t) -> str:
        return self.names.get(t.shape[2], f"length_{t.shape[2]}")

    def wrap(self, fn, key):
        def inner(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events.append((key(*a, **kw), start, end))
            return out
        return inner

    def close(self) -> dict:
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)
        torch.cuda.synchronize()
        out = {}
        for key, start, end in self.events:
            out[key] = out.get(key, 0.0) + start.elapsed_time(end)
            out[f"{key}_calls"] = out.get(f"{key}_calls", 0) + 1
        return out


def ssd_layer(cfg, batch: int, seq: int) -> None:
    """One layer's SSD scan at the step's shape: the kernel forward, and
    the backward through the f32 chunked reference, timed apart."""
    sc = cfg.ssm_cfg
    g = torch.Generator(device="cuda").manual_seed(0)
    h, p, s, ng, di = (sc.n_heads, sc.head_dim, sc.d_state, sc.n_groups,
                       sc.d_inner)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    xbc = r(batch, seq, di + 2 * ng * s).to(cfg.dtype).requires_grad_(True)
    dt = torch.nn.functional.softplus(r(batch, seq, h)).to(cfg.dtype)
    dt.requires_grad_(True)
    a = (-torch.exp(0.5 * r(h))).requires_grad_(True)
    d = torch.ones(h, device="cuda", requires_grad=True)
    cot = r(batch, seq, h, p).to(cfg.dtype)

    def fwd():
        x = xbc[..., :di].reshape(batch, seq, h, p)
        bm = xbc[..., di:di + ng * s].reshape(batch, seq, ng, s)
        cm = xbc[..., di + ng * s:].reshape(batch, seq, ng, s)
        return ssd_scan(x, dt, a, bm, cm, d, chunk=sc.chunk)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (xbc, dt, a, d), cot)

    out = {}
    for name, fn in (("forward_ms", fwd), ("forward_backward_ms", fwd_bwd)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 3
        out[name.replace("_ms", "_peak_gb")] = (
            torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps({"region": f"ssd_scan_one_layer_b{batch}_s{seq}",
                      **out}), flush=True)


if __name__ == "__main__":
    main()
