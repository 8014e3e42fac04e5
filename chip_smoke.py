#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, over the
   kernel test cases and every shape the served trace gives it;
4. time each kernel, its plain version and one PyTorch library call that
   computes the same function (a yardstick the port never calls);
5. qwen3-14b at full width, random weights from a seeded generator:
   at depth 2, prefill logits through the kernel against the plain path
   at the longest prompt and at a ragged one;
   at depth 40, eight requests through ``ContinuousScheduler`` with every
   launch counter set to 0 just before and read just after;
6. the serve CLI (``repro_torch.launch.serve``) at SMOKE size;
7. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import qwen3_14b  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_plain)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousScheduler  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet, dense)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# B, Hq, Hkv, Sq, Skv, D, causal, window, softcap (tests/test_kernels.py)
ATTN_CASES = [
    (2, 4, 4, 128, 128, 64, False, None, None),
    (1, 8, 2, 256, 256, 32, True, None, None),
    (1, 4, 1, 100, 100, 64, True, 37, None),
    (1, 2, 2, 64, 192, 64, False, None, 30.0),
    (2, 6, 3, 80, 80, 16, True, None, None),
    (1, 2, 2, 1, 300, 64, True, None, None),
    (1, 4, 4, 128, 128, 128, True, 64, 50.0),
]
# |kernel - plain| <= rel * (the row's max |plain|) + abs.  Both compute in
# f32 from the same inputs, so in bf16 they differ by one rounding of the
# output: one ulp, at most 2**-7 |x|.  The bar allows two.
TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -6, 1e-6)}

N_REQUESTS, MAX_BATCH, NEW_TOKENS = 8, 4, 32
PROMPT_LENS = np.linspace(512, 2048, N_REQUESTS).astype(int).tolist()


def prefill_case(s: int):
    """One qwen3-14b prefill layer's attention at an s-token prompt."""
    return (1, 40, 8, s, s, 128, True, None, None)


# the serving slice: the longest prompt's prefill layer, 2048 tokens
SLICE = prefill_case(max(PROMPT_LENS))


def log(*a):
    print(*a, flush=True)


def card_facts() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def attn_inputs(case, dtype, seed):
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def attn_kw(case, q_offset=None):
    _, _, _, sq, skv, _, causal, window, softcap = case
    if q_offset is None:
        q_offset = skv - sq if causal else 0
    return dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)


def check_attention(case, dtype, seed, q_offset=None) -> float:
    q, k, v = attn_inputs(case, dtype, seed)
    kw = attn_kw(case, q_offset)
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw).float()
    diff = (got.float() - want).abs()
    rel, atol = TOL[dtype]
    bar = rel * want.abs().amax(dim=-1, keepdim=True) + atol
    err, worst = float(diff.max()), float((diff / bar).max())
    log(f"  {tuple(case)} {str(dtype)[6:]} q_offset={kw['q_offset']}: "
        f"max |kernel - plain| = {err:.3e} ({worst:.3f} of the bar)")
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {worst} of the bar {TOL[dtype]}")
    return err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(case, dtype) -> dict:
    """Least time on the card: q, k, v read once and o written once, over
    the memory rate; 4 * D FLOP per visible (query, key) pair over the
    peak rate of the input type."""
    b, hq, hkv, sq, skv, d = case[:6]
    kw = attn_kw(case)
    qp = kw["q_offset"] + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    vis = torch.ones(sq, skv, dtype=torch.bool)
    if kw["causal"]:
        vis &= kp <= qp
    if kw["window"] is not None:
        vis &= kp > qp - kw["window"]
    flops = 4 * d * b * hq * int(vis.sum())
    item = torch.finfo(dtype).bits // 8
    nbytes = item * d * (2 * b * hq * sq + 2 * b * hkv * skv)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def sdpa(q, k, v):
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def full_width_prefill_check(cfg, lens, device="cuda") -> None:
    """Depth-2 qwen3-14b: last-position prefill logits through the kernel
    against the plain path, relative to the largest logit."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    for s in lens:
        tok = torch.randint(0, cfg.vocab, (1, s), generator=g, device=device)
        with torch.no_grad():
            got, _ = lm.forward_prefill(params, tok, cfg2, backend="kernel")
            want, _ = lm.forward_prefill(params, tok, cfg2, backend="ref")
        rel = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        log(f"  depth-2 prefill logits at {s} tokens: max |kernel - plain| "
            f"/ max |logit| = {rel:.3e}")
        if not rel <= 2e-2:
            raise AssertionError(f"depth-2 prefill logits disagree at {s} "
                                 f"tokens: {rel}")
    del params
    torch.cuda.empty_cache()


def full_width_serve(cfg, device="cuda") -> dict:
    """Depth-40 qwen3-14b behind ContinuousScheduler: 8 requests, prompts
    spread over 512-2048 tokens, 32 new tokens each, all arriving at 0."""
    t0 = time.perf_counter()
    params = lm.init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    log(f"  init {lm.param_counts(cfg)['total'] / 1e9:.2f}B params in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(params, cfg, max_len=max(PROMPT_LENS) + NEW_TOKENS,
                        device=device)
    bad = torch.zeros((), dtype=torch.long, device=device)

    def watch(step):
        def inner(*a):
            logits, caches = step(*a)
            bad.add_((~torch.isfinite(logits)).sum())
            return logits, caches
        return inner

    eng._prefill, eng._decode = watch(eng._prefill), watch(eng._decode)
    g = torch.Generator(device=device).manual_seed(3)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,), generator=g,
                                         device=device),
                    max_new_tokens=NEW_TOKENS, request_id=i)
            for i, n in enumerate(PROMPT_LENS)]
    sched = ContinuousScheduler(eng, max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    eng.serve(reqs, continuous=True, scheduler=sched)
    torch.cuda.synchronize()
    launches = flash_attention_fwd.launches
    summary = sched.metrics.summary()
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prefills = summary["prefills"]
    log(f"  launches: flash_attention_fwd {launches} over {prefills} "
        f"prefills of {cfg.n_layers} layers")
    if launches != cfg.n_layers * prefills or prefills != N_REQUESTS:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"expected {cfg.n_layers} x {N_REQUESTS}")
    for r in reqs:
        if r.result is None or len(r.generated) != NEW_TOKENS:
            raise AssertionError(f"request {r.request_id} did not finish "
                                 f"with {NEW_TOKENS} tokens")
    if int(bad):
        raise AssertionError(f"{int(bad)} non-finite logits")
    log("  metrics " + json.dumps(summary, sort_keys=True))
    del params, eng, sched
    torch.cuda.empty_cache()
    return {"launches": launches, "metrics": summary}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("[1] device")
    facts = card_facts()
    log(facts)

    log("[2] build")
    t0 = time.perf_counter()
    report = build.build()
    log(f"  built {sorted(report) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3] kernels against their plain versions")
    for i, case in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(case, dtype, seed=i)
    for dtype in (torch.float32, torch.bfloat16):   # fully masked rows -> 0
        check_attention((1, 2, 2, 96, 96, 64, True, None, None), dtype,
                        seed=50, q_offset=-40)
    slice_err = max(check_attention(prefill_case(s), torch.bfloat16,
                                    seed=100 + s) for s in PROMPT_LENS)

    log("[4] timing at the slice's shape, bf16")
    q, k, v = attn_inputs(SLICE, torch.bfloat16, seed=7)
    kw = attn_kw(SLICE)
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), iters=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=10)
    library_ms = time_ms(lambda: sdpa(q, k, v), iters=50)
    bound = attention_bound_ms(SLICE, torch.bfloat16)
    log(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"scaled_dot_product_attention {library_ms:.4f} ms  "
        f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
        f"{bound['flops']:.3e} FLOP, {bound['bytes']:.3e} B)")
    del q, k, v

    log("[5] qwen3-14b at full width")
    cfg = qwen3_14b.CONFIG
    full_width_prefill_check(cfg, (max(PROMPT_LENS), PROMPT_LENS[1]))
    served = full_width_serve(cfg)

    log("[6] serve CLI at SMOKE size")
    from repro_torch.launch.serve import main as serve_main
    reqs = serve_main(["--arch", "qwen3-14b", "--continuous", "--batch", "4",
                       "--prompt-len", "16", "--new-tokens", "8"])
    if any(len(r.generated) != 8 for r in reqs):
        raise AssertionError("serve CLI requests did not finish")

    log(facts)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "launches": served["launches"], "max_abs_err": slice_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": library_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
