#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. each kernel against its plain PyTorch version on the card, logging
   the route each case took: flash attention (K1) over its test cases and
   every shape the served trace gives it (``sm90`` for bf16 at head dims
   64, 72 and 128, ``cuda_cores`` otherwise); the SSD scan (K2) over its test
   cases, the training slice's full-width shape and a ragged length at
   that width, one row, a part chunk and two B/C groups (``sm90`` for
   bf16 at P 64, S 128, chunk 128, ``cuda_cores`` otherwise), and the
   slice on ``cuda_cores`` in bf16 too; and K1 at head dim 72, non-causal,
   at the 2D DiT's shapes, bf16 on ``sm90`` and f32 on ``cuda_cores``:
   spatial (a few folded frames, 16 heads, 4096 patches), temporal (4096
   folded patches, 16 heads, the frames) and a ragged length;
4. time each kernel, its plain version and, where one exists, one PyTorch
   library call that computes the same function (a yardstick the port
   never calls); K1's routed kernel and the library call three times each
   in turns (medians), and its ``cuda_cores`` kernel; K2 on ``sm90`` and
   on ``cuda_cores`` three times each in turns (medians); K1 at the DiT's
   spatial shape and at one temporal layer's, on ``sm90`` and on
   ``cuda_cores``, against ``scaled_dot_product_attention``, three times
   each in turns (medians);
5. qwen3-14b serving at full width, random weights from a seeded
   generator: at depth 2, prefill logits through the kernel against the
   plain path at the longest prompt and at a ragged one (bar 2e-2 of the
   largest logit); at depth 40, eight requests (prompts 512-2048 tokens,
   32 new tokens each, 4 slots, all arriving at 0) through
   ``ContinuousScheduler`` with every launch counter set to 0 just before
   and read just after; K1 must launch 40 x 8 = 320 times, every launch on
   the ``sm90`` route;
6. the serve CLI (``repro_torch.launch.serve``) at SMOKE size;
7. mamba2-370m training at full width: at depth 2, ``lm_loss`` and every
   gradient through the kernel against the plain path (bars 1e-4 of the
   loss, 2e-2 of each leaf's max |plain|); at depth 48, six AdamW steps
   of the port's ``Trainer`` at batch 8 x 4096 tokens, with the launch
   counters set to 0 just before and read just after; K2 must launch
   2 x 48 x 6 = 576 times (forward and checkpointed recompute), every
   launch on the ``sm90`` route;
8. the train CLI (``repro_torch.launch.train``) at SMOKE size, where the
   loss must fall;
9. mamba2-370m serving at full width: at depth 2, prefill logits at the
   longest prompt and then 8 greedy decode steps, kernel path against
   plain (bar 2e-2 of the largest logit); one layer's prefill state
   (``ssd_final_state``) against the sequential ``ssd_ref`` at the longest
   prompt (bar 1e-4 of its max); at depth 48, the same eight-request trace
   as phase 5; K2 must launch 48 x 8 = 384 times (one per layer per
   prefill; decode runs in plain PyTorch), every launch on ``sm90``;
10. qwen3-14b training at full width, cut to depth 4 of 40 (AdamW's f32
    moments and master copy for all 14.8B parameters would exceed one
    card): at depth 2, ``lm_loss`` and every gradient through the kernel
    against the plain path at 1 x 4096 tokens (phase 7's bars); at depth
    4, four AdamW steps of the ``Trainer`` at 1 x 4096 tokens; K1 must
    launch 2 x 4 x 4 = 32 times (forward and checkpointed recompute; the
    backward recomputes through ``attention_ref`` and launches none),
    every launch on ``sm90``;
11. the serve CLI with mamba2-370m and the train CLI with qwen3-14b at
    SMOKE size, where the loss must fall;
12. transformer2d-720m (the paper's 2D video DiT) training at full width,
    every block's modulation drawn from seeded normals (adaLN-zero's init
    makes every block the identity, with attention and MLP gradients of
    exactly 0): at depth 2, ``t2d_loss`` and every gradient through the
    kernel against the plain path at 1 x 4 frames x 4096 patches (phase
    7's bars); at depth 28, four AdamW steps of the ``Trainer`` at 1 x 16
    frames x 4096 patches, every group of 2 pairs checkpointed; K1 must
    launch 2 x 28 x 4 = 224 times, every launch on ``sm90`` (``DIT_ROUTE``)
    at head dim 72; then the train CLI with the DiT at SMOKE size;
13. transformer2d-720m under DSP on a ``("data", "model")`` process mesh:
    (a) at world size 1 over NCCL, phase 12's four steps again (same
    init, batches and Trainer) with the mesh: the losses must equal phase
    12's within 1e-4 relative, every rank's ``torch.distributed`` calls
    are counted (``core.dsp``) with the counters set to 0 just before and
    read just after, and must be exactly the planned all-to-alls (28 a
    forward from the executor's accounting, times forward, checkpointed
    recompute and backward: 3 x 28 x 4 = 336) and one all-reduce a step;
    K1 must launch 224 times, all ``sm90`` at head dim 72; one
    switch of the (1, 16, 4096, 1152) stream is timed with its parts;
    (b) 4 processes sharing the card over gloo (NCCL refuses two ranks on
    one GPU) on a (1, 4) mesh, each this script again with
    ``--dsp-rank``: every rank's depth-2 loss and grads at 1 x 16 x 4096
    against (a)'s path at depth 2 (phase 7's bars), the gathered depth-28
    forward against (a)'s within 2e-2 of its largest |value|, and per rank
    exactly the planned all-to-alls and K1 launches.  gloo takes the
    card's tensors itself; a collective it refused would fail the run;
14. transformer2d-720m under the paper's embedded-SP baselines and DSP's
    overlapped switch (``SP_MODES``: ``ulysses``, ``ulysses_fused``,
    ``ring``, ``megatron``, ``hybrid`` on the ``("sp_out", "sp_in")``
    grid, and ``dsp`` with ``overlap="chunked"``): (a) at world size 1
    over NCCL, for each mode the depth-2 loss and grads at 1 x 4 x 4096
    against plan ``none``'s plain path (phase 7's bars), the depth-28
    forward at 1 x 16 x 4096 against plan ``none``'s within 2e-2 of its
    largest |value|, and 2 Trainer steps at depth 28 (step 2's time logged
    beside phase 12's); (b) 4 processes sharing the card over gloo, each
    this script with ``--sp-rank``, every mode's depth-2 loss and grads
    and gathered depth-28 forward against (a)'s.  Around every run the
    counters are set to 0 just before and read just after: each rank's
    collectives, their bytes (``core.dsp.volume``) and K1's launches must
    be exactly the contract's (``sp_contract``; PERF.md §6), every K1
    launch on ``sm90`` at head dim 72; (b) logs Table 3's bytes per
    rank at n = 4;
15. a ``{"kernels": [...]}`` line, whose ``launches`` sum each kernel's
    counts over the paths above (K1 320 + 32 + 224 + 224 + phase 14's
    training runs, 112 per mode, 56 for ring and hybrid; K2 576 + 384)
    and whose ``launches_by_route`` split that sum by the route each
    launch took (every one ``sm90``), then the last line ``{"ok": true,
    "device": {...}}``.

Each phase's header logs the seconds since the start, and every time
logged carries the card's name and power limit.
"""
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    mamba2_370m, qwen3_14b, transformer2d_720m)
from repro_torch.core import dsp  # noqa: E402
from repro_torch.core.layout import from_mesh  # noqa: E402
from repro_torch.core.schedule import ScheduleExecutor  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ROUTES, flash_attention_fwd, flash_attention_plain, reset_launches)
from repro_torch.kernels.ref import ssd_final_state, ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    reset_launches as reset_ssd_launches, route_for as ssd_route,
    ssd_scan_fwd, ssd_scan_plain)
from repro_torch.launch.mesh import (  # noqa: E402
    BACKEND_OF, make_mesh, make_sp2d_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import transformer2d as t2d  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import ContinuousScheduler  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig, allreduce_grads)

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

# B, L, H, P, G, S, chunk (tests/test_kernels.py SSD_CASES)
SSD_CASES = [
    (2, 128, 4, 16, 2, 32, 64),
    (1, 64, 2, 32, 1, 16, 16),
    (1, 200, 4, 16, 4, 32, 64),
    (2, 96, 8, 8, 2, 64, 32),
]
# the training slice: one mamba2-370m layer's scan at train_4k's sequence,
# batch 8; and a ragged length at the same width
SSD_SLICE = (8, 4096, 32, 64, 1, 128, 128)
SSD_RAGGED = (8, 4000, 32, 64, 1, 128, 128)
# more of the sm90 route in bf16: one row, a part chunk, two B/C groups
SSD_SM90_EDGES = [(2, 1, 4, 64, 1, 128, 128), (2, 100, 4, 64, 1, 128, 128),
                  (2, 1000, 4, 64, 2, 128, 128)]
# mamba2 depth-2 loss and grads, kernel against plain: the loss's
# |delta| / |loss| and every grad leaf's max |delta| / max |plain|
LOSS_BAR, GRAD_BAR = 1e-4, 2e-2

# serving, depth 2, kernel against plain: logits within this share of the
# largest logit, at prefill and at each of DECODE_CHECK_STEPS decode steps
LOGIT_BAR, DECODE_CHECK_STEPS = 2e-2, 8
# one mamba2-370m layer's prefill state, ssd_final_state against the
# sequential ssd_ref: max |delta| / max |ssd_ref|, f32 sums in another
# order over the prompt
STATE_BAR = 1e-4

N_REQUESTS, MAX_BATCH, NEW_TOKENS = 8, 4, 32
# the training slices: train_4k's sequence at batch 8 (of its 256, one
# card) for mamba2-370m; at batch 1 and depth 4 of 40 for qwen3-14b, whose
# f32 AdamW state at full depth (14.8B params x 12 B) exceeds one card
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4096, 6
QWEN_TRAIN_BATCH, QWEN_TRAIN_DEPTH, QWEN_TRAIN_STEPS = 1, 4, 4
PROMPT_LENS = np.linspace(512, 2048, N_REQUESTS).astype(int).tolist()
# the DiT training slice: video_0.5m's 4096 patches a frame at batch 1 (of
# its 32) and 16 frames (of its 128), cut to fit one card (PERF.md §4);
# every group of 2 block pairs checkpointed; the depth-2 check at 4 frames
DIT_BATCH, DIT_FRAMES, DIT_PATCHES, DIT_STEPS = 1, 16, 4096, 4
DIT_REMAT_GROUP, DIT_CHECK_FRAMES = 2, 4
# the DSP phase: phase 12's training at world size 1 over NCCL, whose
# losses must equal phase 12's (the switch only moves bytes there); then
# DSP_RANKS processes sharing the card over gloo on a (1, DSP_RANKS) mesh:
# depth-2 loss and grads against the world-1 path (phase 7's bars), and
# the depth-28 forward against world 1 within DSP_OUT_BAR of its largest
# |value| (bf16 activations, summed in another order)
DSP_RANKS, DSP_LOSS_BAR, DSP_OUT_BAR = 4, 1e-4, 2e-2
# the baselines phase: the paper's embedded-SP modes and DSP's overlapped
# switch, each at world size 1 over NCCL (depth-2 grads against plan
# none's plain path at phase 7's bars, the depth-28 forward against plan
# none's within DSP_OUT_BAR, SP_TRAIN_STEPS Trainer steps at depth 28), then
# over DSP_RANKS processes sharing the card over gloo against world 1
SP_MODES = (("ulysses", None), ("ulysses_fused", None), ("ring", None),
            ("megatron", None), ("hybrid", None), ("dsp", "chunked"))
SP_TRAIN_STEPS = 2


def prefill_case(s: int):
    """One qwen3-14b prefill layer's attention at an s-token prompt."""
    return (1, 40, 8, s, s, 128, True, None, None)


# the serving slice: the longest prompt's prefill layer, 2048 tokens
SLICE = prefill_case(max(PROMPT_LENS))
# K1 at the DiT's head dim 72 (1152 / 16), non-causal: a spatial layer's
# attention over 2 folded frames, a temporal layer's over the 4096 folded
# patches of DIT_FRAMES frames, and a ragged length
DIT_HEADS, DIT_DH = 16, 72
DIT_TEMPORAL = (DIT_PATCHES, DIT_HEADS, DIT_HEADS, DIT_FRAMES, DIT_FRAMES,
                DIT_DH, False, None, None)
DIT_ATTN_CASES = [
    (2, DIT_HEADS, DIT_HEADS, DIT_PATCHES, DIT_PATCHES, DIT_DH, False, None,
     None),
    DIT_TEMPORAL,
    (1, 3, 3, 100, 100, DIT_DH, False, None, None)]
# K1's timing shape on the DiT path: 4 of a spatial layer's folded frames
# (the kernel's time grows with their count)
DIT_SLICE = (4, DIT_HEADS, DIT_HEADS, DIT_PATCHES, DIT_PATCHES, DIT_DH,
             False, None, None)
# the route every K1 launch of the DiT (bf16 at head dim 72) must take
DIT_ROUTE = "sm90"


# the card's name and power limit (phase 1), logged beside every time
CARD = "card not read yet"


def log(*a):
    print(*a, flush=True)


def log_t(*a):
    """``log`` with the card's name and power limit after the line."""
    log(*a, f"[{CARD}]")


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


def attn_worst_share(got, want, dtype) -> float:
    """The largest share of K1's bar ``TOL[dtype]`` over the output: per
    (b, h, row), |delta| <= rel * the row's max |plain| + abs."""
    want_f = want.float()
    diff = (got.float() - want_f).abs()
    rel, atol = TOL[dtype]
    bar = rel * want_f.abs().amax(dim=-1, keepdim=True) + atol
    return float((diff / bar).max())


def check_attention(case, dtype, seed, q_offset=None) -> float:
    """K1 against flash_attention_plain under ``attn_worst_share``'s bar,
    on the route ``ROUTES`` gives the case; the launch must take it."""
    q, k, v = attn_inputs(case, dtype, seed)
    kw = attn_kw(case, q_offset)
    route = ROUTES[(dtype, case[5])]
    before = flash_attention_fwd.route_launches[route]
    got = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    if flash_attention_fwd.route_launches[route] != before + 1:
        raise AssertionError(f"{case} {dtype} did not take route {route}")
    want = flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    worst = attn_worst_share(got, want, dtype)
    log(f"  {tuple(case)} {str(dtype)[6:]} q_offset={kw['q_offset']} "
        f"route={route}: max |kernel - plain| = {err:.3e} ({worst:.3f} of "
        f"the bar)")
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


def ssd_inputs(case, dtype, seed):
    """As tests/test_kernels.py builds them, in the kernel layout that
    ``kernels.ops.ssd_scan`` forms: xdt = x dt, da = dt a (float32)."""
    b, l, h, p, g, s, _ = case
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = r(b, l, h, p).to(dtype)
    dt = F.softplus(r(b, l, h)).to(dtype)
    a = -torch.exp(0.5 * r(h))
    bm, cm = r(b, l, g, s).to(dtype), r(b, l, g, s).to(dtype)
    xdt = (x * dt[..., None]).transpose(1, 2).contiguous()
    da = (dt * a).transpose(1, 2).contiguous()
    return (xdt, da, bm.transpose(1, 2).contiguous(),
            cm.transpose(1, 2).contiguous())


def ssd_worst_share(got, want) -> float:
    """The largest share of K2's bar over the output.  f32: max |delta| <=
    1e-4 max |plain| over the whole output (the two add the chunks in
    different orders and y grows with L).  bf16: per (b, h, l) row over P,
    |delta| <= 2**-6 the row's max |plain| + 1e-6, two ulps of one
    rounding, as K1's bar."""
    want_f = want.float()
    diff = (got.float() - want_f).abs()
    if want.dtype == torch.float32:
        bar = 1e-4 * want_f.abs().max()
    else:
        bar = 2.0 ** -6 * want_f.abs().amax(dim=-1, keepdim=True) + 1e-6
    return float((diff / bar).max())


def check_ssd(case, dtype, seed, route=None) -> float:
    """K2 against ssd_scan_plain under ``ssd_worst_share``'s bar, on
    ``route`` or, by default, the route ``ssd_route`` gives the case; the
    launch must take it."""
    xdt, da, b, c = ssd_inputs(case, dtype, seed)
    _, _, _, p, _, s, chunk = case
    route = route or ssd_route(dtype, p, s, chunk)
    before = ssd_scan_fwd.route_launches[route]
    got = ssd_scan_fwd(xdt, da, b, c, chunk=chunk, route=route)
    torch.cuda.synchronize()
    if ssd_scan_fwd.route_launches[route] != before + 1:
        raise AssertionError(f"ssd {case} {dtype} did not take route {route}")
    want = ssd_scan_plain(xdt, da, b, c, chunk=chunk)
    err = float((got.float() - want.float()).abs().max())
    worst = ssd_worst_share(got, want)
    log(f"  ssd {tuple(case)} {str(dtype)[6:]} route={route}: max |kernel "
        f"- plain| = {err:.3e} ({worst:.3f} of the bar)")
    if not worst <= 1.0:
        raise AssertionError(f"ssd_scan disagrees with its plain version at "
                             f"{case} {dtype}: {worst} of the bar")
    return err


def ssd_bound_ms(case, dtype) -> dict:
    """Least time on the card, the larger of two.  Operations, over the
    peak rate of the input type, for a chunk of n rows: c b^T over its
    causal triangle, 2S n(n+1)/2 FLOP once per B/C group (the group's
    heads share it); per head, the masked product with xdt, 2P n(n+1)/2,
    and the inter-chunk output and the state update, 2 x 2nPS.  Bytes,
    over the memory rate: xdt, da, b, c read once and y written once."""
    b, l, h, p, g, s, q = case
    tri = sum(n * (n + 1) for n in (min(q, l - i) for i in range(0, l, q)))
    flops = b * (g * s * tri + h * (p * tri + 4 * p * s * l))
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (2 * b * h * l * p + 2 * b * g * l * s) + 4 * b * h * l
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def ptxas_report(log_text: str) -> list:
    """``-Xptxas -v``'s registers and spills (and any warning), one line
    per kernel instantiation, named by its mangled symbol's tail."""
    out, entry = [], "?"
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            tags = [t for t in ("flash_fwd", "ssd_scan") if t in entry]
            entry = entry[entry.rfind(tags[0]):] if tags else entry[-48:]
        elif "registers" in line or "spill" in line or "arning" in line:
            out.append(f"{entry.split('EEEv')[0]}: "
                       f"{line.replace('ptxas info    :', '').strip()}")
    return out


def sdpa(q, k, v, causal=True):
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def logit_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def full_width_prefill_check(cfg, lens, decode_steps=0,
                             device="cuda") -> None:
    """Depth-2 ``cfg``: last-position prefill logits through the kernel
    against the plain path, relative to the largest logit; then
    ``decode_steps`` greedy decode steps from each path's caches."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    g = torch.Generator(device=device).manual_seed(2)
    for s in lens:
        tok = torch.randint(0, cfg.vocab, (1, s), generator=g, device=device)
        with torch.no_grad():
            got, c_got = lm.forward_prefill(params, tok, cfg2,
                                            backend="kernel")
            want, c_want = lm.forward_prefill(params, tok, cfg2,
                                              backend="ref")
            gaps = [logit_gap(got, want)]
            for _ in range(decode_steps):
                nxt = torch.argmax(want[:, -1], dim=-1)[:, None]
                got, c_got = lm.forward_decode(params, nxt, c_got, cfg2)
                want, c_want = lm.forward_decode(params, nxt, c_want, cfg2)
                gaps.append(logit_gap(got, want))
        log(f"  depth-2 prefill logits at {s} tokens: max |kernel - plain| "
            f"/ max |logit| = {gaps[0]:.3e}" + (
                f"; then {decode_steps} decode steps, worst "
                f"{max(gaps[1:]):.3e}" if decode_steps else ""))
        if not max(gaps) <= LOGIT_BAR:
            raise AssertionError(f"depth-2 prefill or decode logits disagree "
                                 f"at {s} tokens: {gaps}")
    del params
    torch.cuda.empty_cache()


def ssd_state_check(cfg, device="cuda") -> float:
    """One mamba2-370m layer's prefill state at the longest prompt:
    ``ssd_final_state`` (the closed form the prefill takes) against the
    sequential ``ssd_ref``, on bf16 inputs with the init's decay rates."""
    sc = cfg.ssm_cfg
    l, h = max(PROMPT_LENS), sc.n_heads
    gen = torch.Generator(device=device).manual_seed(4)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)
    x = r(1, l, h, sc.head_dim).bfloat16()
    dt = F.softplus(r(1, l, h)).bfloat16()
    a = -torch.linspace(1.0, 16.0, h, device=device)
    b, c = (r(1, l, sc.n_groups, sc.d_state).bfloat16() for _ in range(2))
    got = ssd_final_state(x, dt, a, b, c)
    _, want = ssd_ref(x, dt, a, b, c, return_state=True)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  prefill state at {l} tokens, one layer (1, {h}, {sc.head_dim}, "
        f"{sc.d_state}): max |closed form - ssd_ref| / max |ssd_ref| = "
        f"{rel:.3e}")
    if not rel <= STATE_BAR:
        raise AssertionError(f"prefill state disagrees with ssd_ref: {rel}")
    return rel


def full_width_serve(cfg, kernel, device="cuda") -> dict:
    """``cfg`` at full depth behind ContinuousScheduler: 8 requests, prompts
    spread over 512-2048 tokens, 32 new tokens each, all arriving at 0.
    ``kernel`` (K1's or K2's wrapper) must launch once per layer per
    prefill, every launch on the ``sm90`` route."""
    t0 = time.perf_counter()
    params = lm.init_lm(0, cfg, device=device)
    torch.cuda.synchronize()
    log_t(f"  init {lm.param_counts(cfg)['total'] / 1e9:.2f}B params in "
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
    reset_launches()
    reset_ssd_launches()
    eng.serve(reqs, continuous=True, scheduler=sched)
    torch.cuda.synchronize()
    launches = kernel.launches
    routes = dict(kernel.route_launches)
    summary = sched.metrics.summary()
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    prefills = summary["prefills"]
    log(f"  launches: {kernel.__name__} {launches} over {prefills} "
        f"prefills of {cfg.n_layers} layers, by route {routes}; "
        f"flash_attention_fwd {flash_attention_fwd.launches}, ssd_scan_fwd "
        f"{ssd_scan_fwd.launches} in all")
    if launches != cfg.n_layers * prefills or prefills != N_REQUESTS:
        raise AssertionError(f"{kernel.__name__} launched {launches} times, "
                             f"expected {cfg.n_layers} x {N_REQUESTS}")
    if routes["sm90"] != launches:
        raise AssertionError(f"not every prefill launch took the sm90 "
                             f"route: {routes}")
    for r in reqs:
        if r.result is None or len(r.generated) != NEW_TOKENS:
            raise AssertionError(f"request {r.request_id} did not finish "
                                 f"with {NEW_TOKENS} tokens")
    if int(bad):
        raise AssertionError(f"{int(bad)} non-finite logits")
    log_t("  metrics " + json.dumps(summary, sort_keys=True))
    del params, eng, sched
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": nonzero(routes),
            "metrics": summary}


def leaf_paths(tree, path="") -> list:
    """The key paths of ``lm.tree_leaves``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [q for k in tree for q in leaf_paths(tree[k], f"{path}/{k}")]
    return [path]


def loss_grads_gap(params, batch, cfg, loss_fn=lm.lm_loss) -> dict:
    """``loss_fn`` (``lm_loss`` or ``t2d_loss``) and every gradient with the
    kernels against the plain path: the loss's |delta| / |loss|, and the
    worst grad leaf's max |delta| / max |plain| with that leaf's path."""
    def loss_and_grads(backend):
        leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
        loss, _ = loss_fn(leaves, batch, cfg, backend=backend)
        return loss.detach(), torch.autograd.grad(loss,
                                                  lm.tree_leaves(leaves))

    loss_k, grads_k = loss_and_grads("kernel")
    loss_r, grads_r = loss_and_grads("ref")
    shares = [float((gk.float() - gr.float()).abs().max()
                    / gr.float().abs().max().clamp_min(1e-30))
              for gk, gr in zip(grads_k, grads_r)]
    worst = int(np.argmax(shares))
    return {"loss": float(loss_r),
            "loss_rel": float((loss_k - loss_r).abs() / loss_r.abs()),
            "grad_rel": shares[worst], "leaf": leaf_paths(params)[worst],
            "leaves": len(shares)}


def gap_passes(gap) -> bool:
    return gap["loss_rel"] <= LOSS_BAR and gap["grad_rel"] <= GRAD_BAR


def full_width_grads_check(cfg, batch_size, device="cuda") -> None:
    """Depth-2 ``cfg``, ``batch_size`` x 4096 tokens, under ``gap_passes``.
    Both backends take the backward through the same plain reference
    (``ssd_chunked_ref``, ``attention_ref``); only the forward kernel
    differs, by bf16 roundings."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = lm.init_lm(0, cfg2, device=device)
    batch = make_batch(DataConfig(task="lm_random", vocab=cfg.vocab,
                                  seq=TRAIN_SEQ, batch=batch_size), 0,
                       device=device)
    gap = loss_grads_gap(params, batch, cfg2)
    log(f"  depth-2 loss {gap['loss']:.6f}: |kernel - plain| / |loss| = "
        f"{gap['loss_rel']:.3e}; worst grad leaf {gap['leaf']} max |delta| "
        f"/ max |plain| = {gap['grad_rel']:.3e} over {gap['leaves']} leaves")
    if not gap_passes(gap):
        raise AssertionError(f"depth-2 loss or grads disagree: {gap}")
    del params
    torch.cuda.empty_cache()


def full_width_train(cfg, kernel, batch_size, n_steps,
                     device="cuda") -> dict:
    """``cfg``: ``n_steps`` AdamW steps of the port's Trainer at
    ``batch_size`` x 4096 tokens on lm_shift batches, under
    ``run_trainer``'s checks with every launch on the ``sm90`` route."""
    dcfg = DataConfig(task="lm_shift", vocab=cfg.vocab, seq=TRAIN_SEQ,
                      batch=batch_size)
    return run_trainer(
        lambda: lm.init_lm(0, cfg, device=device),
        lambda p, b: lm.lm_loss(p, b, cfg, backend="kernel"),
        lambda s: make_batch(dcfg, s, device=device), kernel,
        tokens=batch_size * TRAIN_SEQ, n_steps=n_steps,
        n_layers=cfg.n_layers, route="sm90", device=device)


def run_trainer(init, loss_fn, data_fn, kernel, *, tokens, n_steps,
                n_layers, route, device="cuda", mesh=None,
                launches_per_step=None) -> dict:
    """``n_steps`` AdamW steps of the port's Trainer from ``init()``'s
    params, with every launch counter set to 0 just before and read just
    after.  ``kernel`` (K1's or K2's wrapper) must launch
    ``launches_per_step`` times a step (by default twice per layer: the
    forward and the checkpointed recompute; the backward goes through a
    plain reference), every launch on ``route``; every loss and grad norm
    must be finite.  Logs each step, the median step time of the steps
    after the first, ``tokens`` per step over it, and the peak device
    memory.  With ``mesh`` the Trainer runs on it, and the
    ``torch.distributed`` calls of the run and their bytes are returned by
    kind."""
    if launches_per_step is None:
        launches_per_step = 2 * n_layers
    t0 = time.perf_counter()
    params = init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.tree_leaves(params))
    log_t(f"  init {n_params / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.1f} s")
    trainer = Trainer(
        loss_fn=loss_fn, params=params,
        opt_cfg=OptConfig(peak_lr=3e-4, warmup_steps=2, total_steps=n_steps),
        cfg=TrainerConfig(total_steps=n_steps, log_every=1),
        data_fn=data_fn, device=device, mesh=mesh)
    del params
    steps = []
    inner = trainer.step_fn

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        steps.append({"seconds": time.perf_counter() - t,
                      "loss": float(out[2]["loss"]),
                      "grad_norm": float(out[2]["grad_norm"])})
        return out
    trainer.step_fn = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_ssd_launches()
    reset_launches()
    dsp.reset_calls()
    out = trainer.run()
    torch.cuda.synchronize()
    collectives, volume = dict(dsp.calls), dict(dsp.volume)
    launches = kernel.launches
    routes = dict(kernel.route_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, st in enumerate(steps):
        log_t(f"  step {i + 1}: loss {st['loss']:.6f}  grad norm "
              f"{st['grad_norm']:.6f}  {st['seconds'] * 1e3:.2f} ms")
    warm = sorted(st["seconds"] for st in steps[1:])
    step_s = warm[len(warm) // 2]
    summary = {"step_ms_first": steps[0]["seconds"] * 1e3,
               "step_ms_median": step_s * 1e3,
               "step_ms_range": [warm[0] * 1e3, warm[-1] * 1e3],
               "tokens_per_s": tokens / step_s,
               "peak_memory_gb": peak_gb,
               "losses": [st["loss"] for st in steps],
               "grad_norms": [st["grad_norm"] for st in steps]}
    log(f"  launches: {kernel.__name__} {launches} over {n_steps} steps of "
        f"{n_layers} layers (forward + checkpointed recompute), by route "
        f"{routes}; flash_attention_fwd {flash_attention_fwd.launches} "
        f"(by head dim {nonzero(flash_attention_fwd.head_dim_launches)}), "
        f"ssd_scan_fwd {ssd_scan_fwd.launches} in all")
    log_t("  metrics " + json.dumps(summary, sort_keys=True))
    if launches != launches_per_step * n_steps:
        raise AssertionError(f"{kernel.__name__} launched {launches} times, "
                             f"expected {launches_per_step} x {n_steps}")
    if routes[route] != launches:
        raise AssertionError(f"not every training launch of "
                             f"{kernel.__name__} took the {route} route: "
                             f"{routes}")
    if len(out["history"]) != n_steps or not all(
            np.isfinite(st["loss"]) and np.isfinite(st["grad_norm"])
            for st in steps):
        raise AssertionError(f"non-finite training step: {steps}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "routes": nonzero(routes),
            "metrics": summary, "collectives": collectives, "volume": volume}


def nonzero(counts: dict) -> dict:
    return {k: n for k, n in counts.items() if n}


def by_route(runs) -> dict:
    """The launches of ``runs`` (each with its ``routes``) summed by route."""
    total = {}
    for run in runs:
        for route, n in run["routes"].items():
            total[route] = total.get(route, 0) + n
    return total


def perturb_modulation(params, seed: int):
    """Draw every block's modulation projection from seeded normals (w at
    0.5 / sqrt(d), b at 0.1), in place.  adaLN-zero's init leaves it at 0,
    which makes each block the identity and every attention and MLP
    gradient exactly 0: a kernel-against-plain check there compares
    zeros."""
    for i, kind in enumerate(("spatial", "temporal")):
        proj = params["layers"][kind]["mod"]["proj"]
        g = torch.Generator(device=proj["w"].device).manual_seed(seed + i)
        d = proj["w"].shape[-2]
        for name, scale in (("w", 0.5 / math.sqrt(d)), ("b", 0.1)):
            t = proj[name]
            t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                    * scale)
    return params


def dit_batch(cfg, frames: int, step: int, device="cuda") -> dict:
    """A video batch at DIT_BATCH x ``frames`` x DIT_PATCHES, x and target
    in the model dtype."""
    dcfg = DataConfig(task="video", batch=DIT_BATCH, temporal=frames,
                      spatial=DIT_PATCHES, in_dim=cfg.in_dim)
    return t2d.model_dtype_batch(make_batch(dcfg, step, device=device), cfg)


def dit_grads_check(cfg, device="cuda") -> dict:
    """Depth-2 (one pair) ``cfg`` at DIT_CHECK_FRAMES frames, modulation
    perturbed: ``t2d_loss`` and every grad through K1 against the plain
    path, under ``gap_passes``."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
    gap = loss_grads_gap(params, dit_batch(cfg, DIT_CHECK_FRAMES, 0, device),
                         cfg2, loss_fn=t2d.t2d_loss)
    log(f"  depth-2 loss {gap['loss']:.6f} at {DIT_BATCH} x "
        f"{DIT_CHECK_FRAMES} x {DIT_PATCHES}: |kernel - plain| / |loss| = "
        f"{gap['loss_rel']:.3e}; worst grad leaf {gap['leaf']} max |delta| "
        f"/ max |plain| = {gap['grad_rel']:.3e} over {gap['leaves']} leaves")
    if not gap_passes(gap):
        raise AssertionError(f"depth-2 DiT loss or grads disagree: {gap}")
    del params
    torch.cuda.empty_cache()
    return gap


def dit_train(cfg, device="cuda") -> dict:
    """``cfg`` at full depth: DIT_STEPS AdamW steps at DIT_BATCH x
    DIT_FRAMES x DIT_PATCHES, modulation perturbed, remat group
    DIT_REMAT_GROUP; every K1 launch on DIT_ROUTE at head dim 72."""
    route = ROUTES[(cfg.dtype, cfg.dh)]
    if route != DIT_ROUTE or cfg.dh != DIT_DH:
        raise AssertionError(f"the DiT's K1 route is {route} at {cfg.dh}, "
                             f"expected {DIT_ROUTE} at {DIT_DH}")
    log(f"  remat_group {DIT_REMAT_GROUP} ({cfg.n_layers // 2} pairs, "
        f"{cfg.n_layers // 2 // DIT_REMAT_GROUP} checkpointed groups)")
    trained = run_trainer(
        lambda: perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6),
        lambda p, b: t2d.t2d_loss(p, b, cfg, backend="kernel",
                                  remat_group=DIT_REMAT_GROUP),
        lambda s: dit_batch(cfg, DIT_FRAMES, s, device), flash_attention_fwd,
        tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES, n_steps=DIT_STEPS,
        n_layers=cfg.n_layers, route=DIT_ROUTE, device=device)
    dims = nonzero(flash_attention_fwd.head_dim_launches)
    if dims != {DIT_DH: trained["launches"]}:
        raise AssertionError(f"K1 launches by head dim {dims}, expected "
                             f"all at {DIT_DH}")
    return trained


def planned_a2a(cfg, n: int, *, passes: int, backward: bool) -> int:
    """All-to-alls a rank issues for ``passes`` forward passes of ``cfg``
    at DIT_BATCH x DIT_FRAMES x DIT_PATCHES over ``n`` model ranks, and one
    backward when ``backward``, from the explicit executor's accounting of
    the planned schedule."""
    ps = t2d.dsp_schedule(cfg, n, t_len=DIT_FRAMES, s_len=DIT_PATCHES,
                          batch=DIT_BATCH)
    ex = ScheduleExecutor(ps, backend="explicit")
    n_pairs = cfg.n_layers // 2
    fwd = ex.expected_collectives(n_pairs).get("all-to-all", 0)
    bwd = ex.expected_bwd_collectives(n_pairs).get("all-to-all", 0)
    return passes * fwd + (bwd if backward else 0)


def dsp_grads(cfg, mesh, device="cuda"):
    """Depth-2 (one pair) ``cfg`` at DIT_BATCH x DIT_FRAMES x DIT_PATCHES,
    modulation perturbed as phase 12's check: this rank's
    ``t2d_loss(mesh=mesh)`` and its grads, summed over the world in one
    all-reduce.  Returns (loss, [f32 grad leaves])."""
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
    batch = t2d.shard_video_batch(dit_batch(cfg, DIT_FRAMES, 0, device), mesh)
    leaves = lm.tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = t2d.t2d_loss(leaves, batch, cfg2, backend="kernel", mesh=mesh)
    grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
    loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
        lambda p: next(grads), leaves))
    return loss, lm.tree_leaves(grads)


def dsp_forward(cfg, mesh, device="cuda"):
    """``make_spmd_forward(mode="dsp")`` at full depth over phase 12's
    first batch, taken whole by every rank; returns the rank's shard."""
    params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
    batch = dit_batch(cfg, DIT_FRAMES, 0, device)
    fwd = t2d.make_spmd_forward(cfg, mesh, mode="dsp", backend="kernel")
    with torch.no_grad():
        return fwd(params, batch["x"], batch["t"])


def time_switch(mesh, shape, device="cuda") -> dict:
    """One planned switch (T -> S) of the DiT's residual stream at
    ``shape`` on ``mesh``'s model group, and its parts: the all-to-all
    alone on a buffer of the same bytes, and the permute-copies a
    ``DSP_RANKS``-way switch of the same stream adds per rank (its T
    shard's S chunks moved to the front, the received chunks merged into
    T).  CUDA events, medians of 3 runs of 10."""
    g = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    b, t, s, c = shape
    n, t_loc = DSP_RANKS, t // DSP_RANKS
    part = x[:, :t_loc]
    group = mesh.get_group("model")

    def permute():
        send = part.reshape(b, t_loc, n, s // n, c).movedim(2, 0).contiguous()
        return send.movedim(0, 1).reshape(b, t, s // n, c)

    fns = {"switch": lambda: dsp.dynamic_switch(x, 1, 2, group),
           "all_to_all": lambda: dist.all_to_all_single(
               out, flat, group=group),
           "permute_copies": permute}
    ms = {k: float(np.median([time_ms(f, iters=10, warmup=2)
                              for _ in range(3)])) for k, f in fns.items()}
    nbytes = x.numel() * x.element_size()
    log_t(f"  one switch of {tuple(shape)} bf16 ({nbytes / 1e6:.1f} MB) at "
          f"world size {dist.get_world_size()}: {ms['switch']:.4f} ms; the "
          f"all-to-all alone {ms['all_to_all']:.4f} ms "
          f"({2 * nbytes / ms['all_to_all'] / 1e6:.1f} GB/s read + "
          f"written); the permute-copies of a {DSP_RANKS}-way switch's "
          f"{tuple(part.shape)} shard {ms['permute_copies']:.4f} ms")
    return {"bytes": nbytes, **{f"{k}_ms": v for k, v in ms.items()}}


def dsp_world_of_one(cfg, phase12: dict, work: str, device="cuda") -> dict:
    """(a) Phase 12's training at world size 1 on a (1, 1) mesh over NCCL:
    the same init, batches and steps through the Trainer with the mesh.
    Every planned switch is issued (an NCCL all-to-all of one rank); the
    losses must equal phase 12's within DSP_LOSS_BAR relative, the
    all-to-alls must be exactly what the executor plans (forward,
    checkpointed recompute and backward each step), the grads take one
    all-reduce a step, and K1 launches as in phase 12.  Then the references
    of (b): the depth-2 loss and grads and the depth-28 forward on this
    path, written to ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store1"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), torch.device(device).type)
        planned = DIT_STEPS * planned_a2a(cfg, 1, passes=2, backward=True)
        log(f"  mesh (1, 1) over {backend}; planned all-to-alls: "
            f"{DIT_STEPS} steps x (2 forward passes + 1 backward) x "
            f"{planned // DIT_STEPS // 3} = {planned}")
        trained = run_trainer(
            lambda: perturb_modulation(t2d.init_t2d(0, cfg, device=device),
                                       6),
            lambda p, b: t2d.t2d_loss(p, b, cfg, backend="kernel",
                                      remat_group=DIT_REMAT_GROUP, mesh=mesh),
            lambda st: t2d.shard_video_batch(
                dit_batch(cfg, DIT_FRAMES, st, device), mesh),
            flash_attention_fwd, tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES,
            n_steps=DIT_STEPS, n_layers=cfg.n_layers, route=DIT_ROUTE,
            device=device, mesh=mesh)
        dims = nonzero(flash_attention_fwd.head_dim_launches)
        if dims != {cfg.dh: trained["launches"]}:
            raise AssertionError(f"K1 launches by head dim {dims}")
        calls = trained["collectives"]
        log(f"  torch.distributed calls: {calls}")
        if calls != {"all-to-all": planned, "all-reduce": DIT_STEPS}:
            raise AssertionError(f"collectives {calls}, planned "
                                 f"{planned} all-to-alls and {DIT_STEPS} "
                                 f"all-reduces")
        losses = trained["metrics"]["losses"]
        ref = phase12["metrics"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        log_t(f"  losses {losses} against phase 12's {ref}: worst "
              f"|delta| / |loss| = {rel:.3e}; step (median) "
              f"{trained['metrics']['step_ms_median']:.2f} ms against "
              f"phase 12's {phase12['metrics']['step_ms_median']:.2f} ms")
        if not rel <= DSP_LOSS_BAR:
            raise AssertionError(f"world-1 DSP losses {losses} differ from "
                                 f"phase 12's {ref}")
        switch = time_switch(mesh, (DIT_BATCH, DIT_FRAMES, DIT_PATCHES,
                                   cfg.d_model), device)
        loss, grads = dsp_grads(cfg, mesh, device)
        torch.save({"loss": loss.cpu(), "grads": [g.cpu() for g in grads]},
                   os.path.join(work, "ref_grads.pt"))
        del grads
        torch.save(dsp_forward(cfg, mesh, device).cpu(),
                   os.path.join(work, "ref_out.pt"))
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {**trained, "planned_a2a": planned, "switch": switch}


def dsp_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``dsp_four_ranks`` as ``chip_smoke.py
    --dsp-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors on
    a (1, world) mesh.  Checks its depth-2 loss and grads against (a)'s,
    writes its depth-28 forward shard, and writes what it counted to
    ``<dir>/rank<rank>.json``."""
    job = json.load(open(os.path.join(work, "job.json")))
    device = job["device"]
    cfg = dataclasses.replace(
        transformer2d_720m.CONFIG, **job["cfg"],
        dtype=getattr(torch, job["dtype"].split(".")[-1]))
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store4"), world), rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"),
                         torch.device(device).type, backend="gloo")
        res = {"coord": from_mesh(mesh).sp_index}
        ref = torch.load(os.path.join(work, "ref_grads.pt"))
        for name, run in (("grads", lambda: dsp_grads(cfg, mesh, device)),
                          ("forward", lambda: dsp_forward(cfg, mesh, device))):
            reset_launches()
            dsp.reset_calls()
            t0 = time.perf_counter()
            got = run()
            if device == "cuda":
                torch.cuda.synchronize()
            res[name] = {"seconds": time.perf_counter() - t0,
                         "calls": dict(dsp.calls),
                         "k1": flash_attention_fwd.launches,
                         "k1_routes": nonzero(
                             flash_attention_fwd.route_launches)}
            if name == "grads":
                loss, grads = got
                shares = [float((g.cpu() - w).abs().max()
                                / w.abs().max().clamp_min(1e-30))
                          for g, w in zip(grads, ref["grads"])]
                res[name].update(
                    loss=float(loss), loss_rel=float(
                        (loss.cpu() - ref["loss"]).abs() / ref["loss"].abs()),
                    grad_rel=max(shares), leaves=len(shares))
                del grads
            else:
                torch.save(got.cpu(), os.path.join(work, f"out{rank}.pt"))
                res[name]["shape"] = list(got.shape)
        json.dump(res, open(os.path.join(work, f"rank{rank}.json"), "w"))
    finally:
        dist.destroy_process_group()


def dsp_four_ranks(cfg, work: str, device="cuda") -> dict:
    """(b) DSP_RANKS processes sharing the card over gloo on a (1,
    DSP_RANKS) mesh (a 4-rank NCCL group cannot be built on one card).
    Checks layouts and values, not speed: every rank's depth-2 loss and
    grads against (a)'s within phase 7's bars; the gathered depth-28
    forward against (a)'s within DSP_OUT_BAR of its largest |value|; per
    rank exactly the planned all-to-alls and K1 launches, all
    DIT_ROUTE."""
    with open(os.path.join(work, "job.json"), "w") as f:
        json.dump({"device": device, "dtype": str(cfg.dtype),
                   "cfg": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                           "d_ff": cfg.d_ff, "in_dim": cfg.in_dim}}, f)
    t0 = time.perf_counter()
    # each rank is this script again, as started (sys.argv[0])
    procs = [subprocess.Popen([sys.executable, os.path.abspath(sys.argv[0]),
                               "--dsp-rank", str(r), str(DSP_RANKS), work])
             for r in range(DSP_RANKS)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"a DSP rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
             for r in range(DSP_RANKS)]
    # depth 2: the forward, its checkpointed recompute and the backward;
    # K1 in each block's forward and recompute
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    want = {"grads": ({"all-to-all": planned_a2a(cfg2, DSP_RANKS, passes=2,
                                                 backward=True),
                       "all-reduce": 1}, 2 * cfg2.n_layers),
            "forward": ({"all-to-all": planned_a2a(cfg, DSP_RANKS, passes=1,
                                                   backward=False)},
                        cfg.n_layers)}
    log(f"  planned per rank: {want}")
    for r, res in enumerate(ranks):
        g, f = res["grads"], res["forward"]
        log_t(f"  rank {r} (gloo on {device} tensors): depth-2 loss "
              f"{g['loss']:.6f}, |delta| / |loss| against world 1 "
              f"{g['loss_rel']:.3e}, worst grad leaf {g['grad_rel']:.3e} "
              f"over {g['leaves']} leaves, in {g['seconds']:.1f} s, calls "
              f"{g['calls']}, K1 {g['k1']} {g['k1_routes']}; depth-"
              f"{cfg.n_layers} forward {f['shape']} in {f['seconds']:.1f} s, "
              f"calls {f['calls']}, K1 {f['k1']} {f['k1_routes']}")
        if not (g["loss_rel"] <= LOSS_BAR and g["grad_rel"] <= GRAD_BAR):
            raise AssertionError(f"rank {r}'s depth-2 loss or grads "
                                 f"disagree with world 1: {g}")
        for name, (calls, k1) in want.items():
            if (res[name]["calls"] != calls or res[name]["k1"] != k1
                    or res[name]["k1_routes"] != {DIT_ROUTE: k1}):
                raise AssertionError(f"rank {r} {name}: {res[name]}, "
                                     f"planned {calls} and {k1} K1 "
                                     f"launches")
    order = sorted(range(DSP_RANKS), key=lambda r: ranks[r]["coord"])
    got = torch.cat([torch.load(os.path.join(work, f"out{r}.pt"))
                     for r in order], dim=1).float()
    want = torch.load(os.path.join(work, "ref_out.pt")).float()
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  depth-{cfg.n_layers} forward, {DSP_RANKS} ranks gathered "
        f"{tuple(got.shape)} against world 1: max |delta| / max |world 1| "
        f"= {rel:.3e}")
    if not (got.shape == want.shape and torch.isfinite(got).all()
            and rel <= DSP_OUT_BAR):
        raise AssertionError(f"the {DSP_RANKS}-rank forward disagrees with "
                             f"world 1: {rel}")
    return {"ranks": ranks, "out_rel": rel}


# ---------------------------------------------------------------------------
# Phase 14: the embedded-SP baselines and DSP's overlapped switch
# ---------------------------------------------------------------------------

def sp_label(mode: str, overlap) -> str:
    return mode if overlap is None else f"{mode}+{overlap}"


def sp_meshes(world: int, device: str, backend=None) -> dict:
    """The meshes of phase 14 over ``world`` ranks: ``("data", "model")``
    of (1, world) and, for ``hybrid``, the SP grid ``make_sp2d_mesh`` of
    (2, world / 2), (1, 1) at one rank."""
    outer = 2 if world > 1 else 1
    return {"1d": make_mesh((1, world), ("data", "model"), device,
                            backend=backend),
            "2d": make_sp2d_mesh(outer, world // outer, device_type=device,
                                 backend=backend)}


def sp_mesh_of(meshes: dict, mode: str):
    return meshes["2d" if mode == "hybrid" else "1d"]


def sp_contract(cfg, mode: str, overlap, n: int, outer: int, frames: int):
    """The contract table of PERF.md §6: a rank's {kind: (calls, bytes)} in
    one forward of ``cfg`` at DIT_BATCH x ``frames`` x DIT_PATCHES over
    ``n`` SP ranks (``outer`` of them across ``sp_out`` for hybrid), the
    same in its backward (each collective's transpose; a ring's last hop
    carries blocks nothing reads, so its backward has n - 1 hops a
    stream), and K1's launches a forward.  Bytes as ``core.dsp.volume``
    counts them; M is the residual stream, kv = 2M the K + V of one
    attention (MHA, heads x head dim = d)."""
    p = cfg.n_layers // 2
    item = cfg.dtype.itemsize
    m = DIT_BATCH * frames * DIT_PATCHES * cfg.d_model * item
    kv = 2 * DIT_BATCH * frames * DIT_PATCHES * cfg.kvh * cfg.dh * item
    a2a, perm = "all-to-all", "collective-permute"
    if overlap is not None:
        fwd = {perm: (2 * (n - 1) * p, 2 * m // n * (n - 1) // n * p)}
        bwd = fwd
    elif mode == "dsp":
        fwd = bwd = {a2a: (2 * p, 2 * m // n * p)}
    elif mode in ("ulysses", "ulysses_fused"):
        k = 4 if mode == "ulysses" else 2
        fwd = bwd = {a2a: (k * p, (2 * m + kv) // n * p)}
    elif mode == "ring":
        fwd = {perm: (2 * n * p, kv * p)}
        bwd = {perm: (2 * (n - 1) * p, kv * (n - 1) // n * p)}
    elif mode == "megatron":
        fwd = bwd = {"all-gather": (4 * p, 4 * m * p),
                     "reduce-scatter": (4 * p, 4 * m * p)}
    else:
        inner = (4 * p, (2 * m + kv) // n * p)
        fwd = {a2a: inner, perm: (2 * outer * p, kv * outer // n * p)}
        bwd = {a2a: inner, perm: (2 * (outer - 1) * p,
                                  kv * (outer - 1) // n * p)}
    k1 = p if mode in ("ring", "hybrid") else 2 * p
    return fwd, bwd, k1


def sp_expected(cfg, mode: str, overlap, n: int, outer: int, frames: int, *,
                passes: int, backward: bool, bucket: int = 0):
    """A rank's {kind: [calls, bytes]} and K1 launches over ``passes``
    forward passes (the forward and the checkpointed recompute), the
    backward when ``backward``, and with ``bucket`` one all-reduce of that
    many f32 gradients (2 x its bytes)."""
    fwd, bwd, k1 = sp_contract(cfg, mode, overlap, n, outer, frames)
    out = {}
    for rows, times in ((fwd, passes), (bwd, int(backward))):
        for kind, (c, b) in rows.items():
            got = out.setdefault(kind, [0, 0])
            got[0] += c * times
            got[1] += b * times
    if bucket:
        out["all-reduce"] = [1, 2 * 4 * bucket]
    return {k: v for k, v in out.items() if v[0]}, k1 * passes


def reset_counts() -> None:
    reset_launches()
    dsp.reset_calls()


def read_counts() -> dict:
    """The run's {kind: [calls, bytes]} and K1's launches by route and by
    head dim, read after a synchronise."""
    torch.cuda.synchronize()
    return {"calls": {k: [dsp.calls.get(k, 0), dsp.volume.get(k, 0)]
                      for k in sorted(set(dsp.calls) | set(dsp.volume))},
            "k1": flash_attention_fwd.launches,
            "k1_routes": nonzero(flash_attention_fwd.route_launches),
            "k1_dims": {str(d): n for d, n in nonzero(
                flash_attention_fwd.head_dim_launches).items()}}


def check_counts(what: str, got: dict, calls: dict, k1: int) -> None:
    """``got`` (``read_counts``) must be exactly ``calls`` and ``k1``
    launches, all on DIT_ROUTE at the DiT's head dim."""
    if (got["calls"] != calls or got["k1"] != k1
            or got["k1_routes"] != ({DIT_ROUTE: k1} if k1 else {})
            or got["k1_dims"] != ({str(DIT_DH): k1} if k1 else {})):
        raise AssertionError(f"{what}: counted {got}, the contract says "
                             f"{calls} and {k1} K1 launches on {DIT_ROUTE} "
                             f"at head dim {DIT_DH}")


def sp_grads(cfg2, params2, batch, mesh, mode: str, overlap):
    """This rank's ``t2d_loss(mesh=..., mode=..., overlap=...)`` on its
    shard of ``batch`` and its grads, summed over the world in one
    all-reduce.  Returns (loss, [f32 grad leaves])."""
    local = t2d.shard_video_batch(batch, mesh)
    leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True), params2)
    loss, _ = t2d.t2d_loss(leaves, local, cfg2, backend="kernel", mesh=mesh,
                           mode=mode, overlap=overlap)
    grads = iter(torch.autograd.grad(loss, lm.tree_leaves(leaves)))
    loss, grads = allreduce_grads(loss.detach(), lm.tree_map(
        lambda p: next(grads), leaves))
    return loss, lm.tree_leaves(grads)


def grads_gap(loss, grads, ref_loss, ref_grads) -> dict:
    """|loss - ref| / |ref|, and the worst leaf's max |delta| / max |ref|,
    on the device of ``grads``."""
    shares = []
    for g, w in zip(grads, ref_grads):
        w = w.to(g.device).float()
        shares.append(float((g.float() - w).abs().max()
                            / w.abs().max().clamp_min(1e-30)))
    ref_loss = ref_loss.float().to(loss.device)
    return {"loss": float(loss), "loss_rel": float(
                (loss.float() - ref_loss).abs() / ref_loss.abs()),
            "grad_rel": max(shares), "leaves": len(shares)}


def sp_world_of_one(cfg, phase12: dict, work: str, device="cuda") -> dict:
    """(a) Each mode of SP_MODES at world size 1 over NCCL (``hybrid`` on a
    (1, 1) SP grid): the depth-2 ``t2d_loss`` and every grad at
    DIT_CHECK_FRAMES frames against plan ``none``'s plain path (phase 7's
    bars); the depth-28 forward at DIT_FRAMES frames against plan
    ``none``'s within DSP_OUT_BAR of its largest |value|; SP_TRAIN_STEPS
    Trainer steps at depth 28.  Around each, the counters set to 0 just
    before and read just after: the collectives and bytes and K1's
    launches must be the contract's at n = 1.  Writes (b)'s references to
    ``work``."""
    backend = BACKEND_OF[torch.device(device).type]
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store14a"), 1), rank=0, world_size=1)
    try:
        meshes = sp_meshes(1, torch.device(device).type)
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        params2 = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
        batch2 = dit_batch(cfg, DIT_CHECK_FRAMES, 0, device)
        leaves = lm.tree_map(lambda p: p.detach().requires_grad_(True),
                             params2)
        ref_loss, _ = t2d.t2d_loss(leaves, batch2, cfg2, backend="ref")
        ref_grads = torch.autograd.grad(ref_loss, lm.tree_leaves(leaves))
        ref_loss = ref_loss.detach()
        del leaves
        bucket2 = sum(p.numel() for p in lm.tree_leaves(params2)) + 1
        params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
        bucket = sum(p.numel() for p in lm.tree_leaves(params)) + 1
        batch = dit_batch(cfg, DIT_FRAMES, 0, device)
        with torch.no_grad():
            ref_out = t2d.forward(params, batch["x"], batch["t"], cfg,
                                  backend="kernel").float()
        torch.cuda.empty_cache()
        results = {}
        for mode, overlap in SP_MODES:
            label = sp_label(mode, overlap)
            mesh = sp_mesh_of(meshes, mode)
            log(f"  {label} on {tuple(mesh.mesh_dim_names)} "
                f"{tuple(mesh.shape)} ({elapsed()})")
            res = {}
            reset_counts()
            loss, grads = sp_grads(cfg2, params2, batch2, mesh, mode, overlap)
            got = read_counts()
            gap = grads_gap(loss, grads, ref_loss, ref_grads)
            log(f"    depth-2 loss {gap['loss']:.6f} at {DIT_BATCH} x "
                f"{DIT_CHECK_FRAMES} x {DIT_PATCHES} against plan none's "
                f"plain path: |delta| / |loss| {gap['loss_rel']:.3e}, worst "
                f"grad leaf {gap['grad_rel']:.3e} of its max over "
                f"{gap['leaves']} leaves; counted {got}")
            if not (gap["loss_rel"] <= LOSS_BAR and gap["grad_rel"]
                    <= GRAD_BAR):
                raise AssertionError(f"{label}: depth-2 loss or grads "
                                     f"disagree with plan none: {gap}")
            check_counts(f"{label} depth 2", got, *sp_expected(
                cfg2, mode, overlap, 1, 1, DIT_CHECK_FRAMES, passes=2,
                backward=True, bucket=bucket2))
            torch.save({"loss": loss.cpu(), "grads": [g.cpu() for g in grads]},
                       os.path.join(work, f"{label}.grads.pt"))
            del grads
            reset_counts()
            with torch.no_grad():
                out = t2d.make_spmd_forward(cfg, mesh, mode=mode,
                                            overlap=overlap, backend="kernel")(
                    params, batch["x"], batch["t"])
            got = read_counts()
            rel = float((out.float() - ref_out).abs().max()
                        / ref_out.abs().max())
            log(f"    depth-{cfg.n_layers} forward {tuple(out.shape)} against "
                f"plan none's: max |delta| / max |none| = {rel:.3e}; counted "
                f"{got}")
            if not (torch.isfinite(out).all() and rel <= DSP_OUT_BAR):
                raise AssertionError(f"{label}: depth-{cfg.n_layers} forward "
                                     f"disagrees with plan none: {rel}")
            check_counts(f"{label} depth {cfg.n_layers}", got, *sp_expected(
                cfg, mode, overlap, 1, 1, DIT_FRAMES, passes=1,
                backward=False))
            torch.save(out.cpu(), os.path.join(work, f"{label}.out.pt"))
            del out
            torch.cuda.empty_cache()
            per_step, k1_step = sp_expected(
                cfg, mode, overlap, 1, 1, DIT_FRAMES, passes=2, backward=True,
                bucket=bucket)
            trained = run_trainer(
                lambda: perturb_modulation(
                    t2d.init_t2d(0, cfg, device=device), 6),
                lambda p, b, mesh=mesh, mode=mode, overlap=overlap:
                    t2d.t2d_loss(p, b, cfg, backend="kernel",
                                 remat_group=DIT_REMAT_GROUP, mesh=mesh,
                                 mode=mode, overlap=overlap),
                lambda st, mesh=mesh: t2d.shard_video_batch(
                    dit_batch(cfg, DIT_FRAMES, st, device), mesh),
                flash_attention_fwd,
                tokens=DIT_BATCH * DIT_FRAMES * DIT_PATCHES,
                n_steps=SP_TRAIN_STEPS, n_layers=cfg.n_layers,
                route=DIT_ROUTE, device=device, mesh=mesh,
                launches_per_step=k1_step)
            got = {"calls": {k: [trained["collectives"].get(k, 0),
                                 trained["volume"].get(k, 0)]
                             for k in sorted(set(trained["collectives"])
                                             | set(trained["volume"]))},
                   "k1": trained["launches"], "k1_routes": nonzero(
                       flash_attention_fwd.route_launches),
                   "k1_dims": {str(d): n for d, n in nonzero(
                       flash_attention_fwd.head_dim_launches).items()}}
            want = {k: [c * SP_TRAIN_STEPS, b * SP_TRAIN_STEPS]
                    for k, (c, b) in per_step.items()}
            check_counts(f"{label} training", got, want,
                         k1_step * SP_TRAIN_STEPS)
            step_ms = trained["metrics"]["step_ms_median"]
            ref_ms = phase12["metrics"]["step_ms_median"]
            lo, hi = phase12["metrics"]["step_ms_range"]
            log_t(f"    {label}: step 2 of {SP_TRAIN_STEPS} {step_ms:.2f} ms "
                  f"against plan none's {ref_ms:.2f} ms (phase 12, median of "
                  f"steps 2-{DIT_STEPS}, spread {lo:.2f}-{hi:.2f} ms; one "
                  f"step here, so a gap inside that spread ranks nothing): "
                  f"{100 * (step_ms / ref_ms - 1):+.2f}%; counted {got}")
            res.update(gap=gap, out_rel=rel, step_ms=step_ms,
                       launches=trained["launches"],
                       routes=trained["routes"],
                       peak_memory_gb=trained["metrics"]["peak_memory_gb"])
            results[label] = res
        del params, params2, ref_grads, ref_out
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"modes": results, "bucket2": bucket2}


def sp_rank_main(rank: int, world: int, work: str) -> None:
    """One of (b)'s ranks, started by ``sp_four_ranks`` as ``chip_smoke.py
    --sp-rank <rank> <world> <dir>``: gloo over the card's CUDA tensors.
    For each mode of SP_MODES, its depth-2 loss and grads against (a)'s,
    its depth-28 forward shard written to ``<dir>``, and what it counted
    around each, to ``<dir>/sp_rank<rank>.json``."""
    job = json.load(open(os.path.join(work, "job14.json")))
    device = job["device"]
    cfg = dataclasses.replace(
        transformer2d_720m.CONFIG, **job["cfg"],
        dtype=getattr(torch, job["dtype"].split(".")[-1]))
    full_f32()
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(work, "store14b"), world), rank=rank, world_size=world)
    try:
        meshes = sp_meshes(world, torch.device(device).type, backend="gloo")
        cfg2 = dataclasses.replace(cfg, n_layers=2)
        params2 = perturb_modulation(t2d.init_t2d(0, cfg2, device=device), 5)
        batch2 = dit_batch(cfg, DIT_CHECK_FRAMES, 0, device)
        params = perturb_modulation(t2d.init_t2d(0, cfg, device=device), 6)
        batch = dit_batch(cfg, DIT_FRAMES, 0, device)
        results = {}
        for mode, overlap in SP_MODES:
            label = sp_label(mode, overlap)
            mesh = sp_mesh_of(meshes, mode)
            ref = torch.load(os.path.join(work, f"{label}.grads.pt"))
            res = {"coord": from_mesh(mesh).sp_index}
            reset_counts()
            t0 = time.perf_counter()
            loss, grads = sp_grads(cfg2, params2, batch2, mesh, mode, overlap)
            res["grads"] = {**read_counts(), **grads_gap(
                loss, grads, ref["loss"], ref["grads"]),
                "seconds": time.perf_counter() - t0}
            del grads, ref
            reset_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = t2d.make_spmd_forward(cfg, mesh, mode=mode,
                                            overlap=overlap, backend="kernel")(
                    params, batch["x"], batch["t"])
            res["forward"] = {**read_counts(), "shape": list(out.shape),
                              "seconds": time.perf_counter() - t0}
            torch.save(out.cpu(), os.path.join(work, f"{label}.out{rank}.pt"))
            del out
            results[label] = res
        json.dump(results, open(os.path.join(work, f"sp_rank{rank}.json"),
                                "w"))
    finally:
        dist.destroy_process_group()


def sp_four_ranks(cfg, bucket2: int, work: str, device="cuda") -> dict:
    """(b) DSP_RANKS processes sharing the card over gloo, each mode on a
    (1, DSP_RANKS) mesh (``hybrid`` on the (2, DSP_RANKS / 2) SP grid).
    Checks layouts and values, not speed: every rank's depth-2 loss and
    grads against (a)'s within phase 7's bars; the gathered depth-28
    forward against (a)'s within DSP_OUT_BAR of its largest |value|; per
    rank exactly the contract's collectives, bytes and K1 launches.  Logs
    each mode's bytes per rank beside ``per_device_bytes``: Table 3 at n =
    DSP_RANKS.  ``bucket2`` is the depth-2 model's gradient count, plus
    one for the loss, that the grads' all-reduce sums."""
    with open(os.path.join(work, "job14.json"), "w") as f:
        json.dump({"device": device, "dtype": str(cfg.dtype),
                   "cfg": {"n_layers": cfg.n_layers,
                           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                           "d_ff": cfg.d_ff, "in_dim": cfg.in_dim}}, f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--sp-rank", str(r), str(DSP_RANKS), work])
             for r in range(DSP_RANKS)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log_t(f"  {DSP_RANKS} ranks exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s")
    if any(rcs):
        raise AssertionError(f"an SP rank failed: exit codes {rcs}")
    ranks = [json.load(open(os.path.join(work, f"sp_rank{r}.json")))
             for r in range(DSP_RANKS)]
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    n, p = DSP_RANKS, cfg.n_layers // 2
    m = DIT_BATCH * DIT_FRAMES * DIT_PATCHES * cfg.d_model * cfg.dtype.itemsize
    table = {}
    for mode, overlap in SP_MODES:
        label = sp_label(mode, overlap)
        outer = 2 if mode == "hybrid" else 1
        want_g = sp_expected(cfg2, mode, overlap, n, outer, DIT_CHECK_FRAMES,
                             passes=2, backward=True, bucket=bucket2)
        want_f = sp_expected(cfg, mode, overlap, n, outer, DIT_FRAMES,
                             passes=1, backward=False)
        for r, rank in enumerate(ranks):
            g, f = rank[label]["grads"], rank[label]["forward"]
            log_t(f"  {label} rank {r} (gloo on {device} tensors): depth-2 "
                  f"|delta loss| / |loss| against world 1 {g['loss_rel']:.3e},"
                  f" worst grad leaf {g['grad_rel']:.3e} in "
                  f"{g['seconds']:.1f} s, counted {g['calls']} K1 {g['k1']};"
                  f" depth-{cfg.n_layers} forward {f['shape']} in "
                  f"{f['seconds']:.1f} s, counted {f['calls']} K1 {f['k1']}")
            if not (g["loss_rel"] <= LOSS_BAR and g["grad_rel"] <= GRAD_BAR):
                raise AssertionError(f"{label} rank {r}: depth-2 loss or "
                                     f"grads disagree with world 1: {g}")
            check_counts(f"{label} rank {r} depth 2", g, *want_g)
            check_counts(f"{label} rank {r} depth {cfg.n_layers}", f,
                         *want_f)
        order = sorted(range(n), key=lambda r: ranks[r][label]["coord"])
        got = torch.cat([torch.load(os.path.join(work, f"{label}.out{r}.pt"))
                         for r in order], dim=1).float()
        want = torch.load(os.path.join(work, f"{label}.out.pt")).float()
        rel = float((got - want).abs().max() / want.abs().max())
        strategy = "ulysses" if mode == "ulysses_fused" else mode
        stages = 2 * p if mode == "megatron" else p
        analytic = stages * dsp.per_device_bytes(strategy, m, n, outer=outer)
        if overlap is not None:
            analytic = analytic * (n - 1) / n
        moved = sum(b for _, b in ranks[0][label]["forward"]["calls"].values())
        table[label] = {"bytes": moved, "analytic": analytic, "out_rel": rel}
        log(f"  {label}: depth-{cfg.n_layers} forward, {n} ranks gathered "
            f"{tuple(got.shape)} against world 1: max |delta| / max |world "
            f"1| = {rel:.3e}; bytes per rank {moved} against "
            f"per_device_bytes {analytic:.0f} ({moved / analytic:.2f})")
        if not (got.shape == want.shape and torch.isfinite(got).all()
                and rel <= DSP_OUT_BAR):
            raise AssertionError(f"{label}: the {n}-rank forward disagrees "
                                 f"with world 1: {rel}")
        if moved != analytic:
            raise AssertionError(f"{label}: {moved} bytes per rank, "
                                 f"per_device_bytes says {analytic}")
    log(f"  Table 3 at n = {n}, bytes per rank of one depth-{cfg.n_layers} "
        f"forward: " + json.dumps({k: v["bytes"] for k, v in table.items()}))
    return table


def train_cli(train_main, arch: str) -> None:
    """The train CLI at SMOKE size for 30 steps; the loss must fall."""
    hist = train_main(["--arch", arch, "--steps", "30"])["history"]
    log(f"  {arch}: loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}")
    if not hist[-1][1] < hist[0][1]:
        raise AssertionError(f"train CLI loss did not fall for {arch}: "
                             f"{hist}")


def time_dit_attention(shape) -> dict:
    """K1 at a DiT ``shape`` in bf16 on its route (DIT_ROUTE) and on
    ``cuda_cores``, and ``scaled_dot_product_attention``, three times each
    in turns (medians); the plain version once, and the bound."""
    q, k, v = attn_inputs(shape, torch.bfloat16, seed=9)
    kw = attn_kw(shape)
    route = ROUTES[(torch.bfloat16, shape[5])]
    if route != DIT_ROUTE:
        raise AssertionError(f"K1 at {shape[:6]} takes {route}, expected "
                             f"{DIT_ROUTE}")
    fns = {route: lambda: flash_attention_fwd(q, k, v, **kw),
           "cuda_cores": lambda: flash_attention_fwd(
               q, k, v, route="cuda_cores", **kw),
           "library": lambda: sdpa(q, k, v, causal=False)}
    runs = {who: [] for who in fns}
    for order in ((route, "cuda_cores", "library"),
                  ("library", "cuda_cores", route),
                  (route, "library", "cuda_cores")):
        for who in order:
            runs[who].append(time_ms(
                fns[who], iters=5 if who == "cuda_cores" else 20, warmup=1))
    ms, cuda_cores_ms, library_ms = (float(np.median(runs[w])) for w in fns)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=3,
                       warmup=1)
    bound = attention_bound_ms(shape, torch.bfloat16)
    log_t(f"  DiT {shape[:6]} non-causal: kernel ({route}) runs "
          f"{runs[route]}  cuda_cores runs {runs['cuda_cores']}  library "
          f"runs {runs['library']}")
    log_t(f"  DiT {shape[:6]}: kernel ({route}) {ms:.4f} ms  cuda_cores "
          f"kernel {cuda_cores_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"scaled_dot_product_attention {library_ms:.4f} ms  bound "
          f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['flops']:.3e} FLOP, {bound['bytes']:.3e} B; the kernel at "
          f"{bound['flops'] / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound['bound_ms'] / ms:.1f}% of the bound)")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(shape[:6]), "route": route, "ms": ms,
            "cuda_cores_ms": cuda_cores_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"]}


T0 = time.perf_counter()


def full_f32() -> None:
    """No TF32: float32 products in full precision, as the plain versions
    and the references are held to."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def elapsed() -> str:
    return f"t = {time.perf_counter() - T0:.1f} s, {CARD}"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    full_f32()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("[1] device")
    global CARD
    facts = CARD = card_facts()
    log(facts)

    log(f"[2] build ({elapsed()})")
    t0 = time.perf_counter()
    report = build.build()
    log_t(f"  built {sorted(report) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        for line in ptxas_report(r["log"]):
            log(f"  {name}: {line}")

    log(f"[3] kernels against their plain versions ({elapsed()})")
    for i, case in enumerate(ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_attention(case, dtype, seed=i)
    for dtype in (torch.float32, torch.bfloat16):   # fully masked rows -> 0
        check_attention((1, 2, 2, 96, 96, 64, True, None, None), dtype,
                        seed=50, q_offset=-40)
    slice_err = max(check_attention(prefill_case(s), torch.bfloat16,
                                    seed=100 + s) for s in PROMPT_LENS)
    for i, case in enumerate(SSD_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_ssd(case, dtype, seed=200 + i)
    ssd_err = check_ssd(SSD_SLICE, torch.bfloat16, seed=210)
    check_ssd(SSD_RAGGED, torch.bfloat16, seed=211)
    for i, case in enumerate(SSD_SM90_EDGES):
        check_ssd(case, torch.bfloat16, seed=213 + i)
    check_ssd(SSD_SLICE, torch.bfloat16, seed=210, route="cuda_cores")
    for case in (SSD_SLICE, SSD_RAGGED):
        check_ssd(case, torch.float32, seed=212)
    for i, case in enumerate(DIT_ATTN_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_attention(case, dtype, seed=300 + i)
            if i == 0 and dtype == torch.bfloat16:
                dit_err = err

    log(f"[4] timing at the slice's shape, bf16 ({elapsed()})")
    q, k, v = attn_inputs(SLICE, torch.bfloat16, seed=7)
    kw = attn_kw(SLICE)
    route = ROUTES[(torch.bfloat16, SLICE[5])]
    # the kernel and the library call in turns (k, l, l, k, k, l): medians
    runs = {"kernel": [], "library": []}
    for who in ("kernel", "library", "library", "kernel", "kernel",
                "library"):
        fn = ((lambda: flash_attention_fwd(q, k, v, **kw)) if who == "kernel"
              else (lambda: sdpa(q, k, v)))
        runs[who].append(time_ms(fn, iters=50))
    ms, library_ms = (float(np.median(runs[w])) for w in ("kernel", "library"))
    cuda_cores_ms = time_ms(lambda: flash_attention_fwd(
        q, k, v, route="cuda_cores", **kw), iters=20)
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=10)
    bound = attention_bound_ms(SLICE, torch.bfloat16)
    log_t(f"  kernel ({route}) runs {runs['kernel']}  library runs "
          f"{runs['library']}")
    log_t(f"  kernel ({route}) {ms:.4f} ms  cuda_cores kernel "
          f"{cuda_cores_ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"scaled_dot_product_attention {library_ms:.4f} ms  "
          f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
          f"{bound['flops']:.3e} FLOP, {bound['bytes']:.3e} B; the kernel "
          f"at {bound['flops'] / ms / 1e9:.1f} TFLOP/s)")
    del q, k, v
    xdt, da, b, c = ssd_inputs(SSD_SLICE, torch.bfloat16, seed=8)
    ssd_route_slice = ssd_route(torch.bfloat16, SSD_SLICE[3], *SSD_SLICE[5:])
    # the routed kernel and the cuda_cores one in turns: medians
    ssd_runs = {ssd_route_slice: [], "cuda_cores": []}
    for who in (ssd_route_slice, "cuda_cores", "cuda_cores",
                ssd_route_slice, ssd_route_slice, "cuda_cores"):
        ssd_runs[who].append(time_ms(
            lambda: ssd_scan_fwd(xdt, da, b, c, chunk=128, route=who),
            iters=20 if who == "sm90" else 5))
    ssd_ms, ssd_cuda_cores_ms = (float(np.median(ssd_runs[w]))
                                 for w in (ssd_route_slice, "cuda_cores"))
    ssd_plain_ms = time_ms(lambda: ssd_scan_plain(xdt, da, b, c, chunk=128),
                           iters=5)
    ssd_bound = ssd_bound_ms(SSD_SLICE, torch.bfloat16)
    log_t(f"  ssd_scan kernel ({ssd_route_slice}) runs "
          f"{ssd_runs[ssd_route_slice]}  cuda_cores runs "
          f"{ssd_runs['cuda_cores']}")
    log_t(f"  ssd_scan kernel ({ssd_route_slice}) {ssd_ms:.4f} ms  cuda_cores "
          f"kernel {ssd_cuda_cores_ms:.4f} ms  plain {ssd_plain_ms:.4f} ms  "
          f"library none  bound {ssd_bound['bound_ms']:.4f} ms "
          f"({ssd_bound['bound_by']}: {ssd_bound['flops']:.3e} FLOP, "
          f"{ssd_bound['bytes']:.3e} B; the kernel at "
          f"{ssd_bound['bytes'] / ssd_ms / 1e6:.1f} GB/s)")
    del xdt, da, b, c
    torch.cuda.empty_cache()
    dit = time_dit_attention(DIT_SLICE)
    dit_temporal = time_dit_attention(DIT_TEMPORAL)

    log(f"[5] qwen3-14b serving at full width ({elapsed()})")
    cfg = qwen3_14b.CONFIG
    full_width_prefill_check(cfg, (max(PROMPT_LENS), PROMPT_LENS[1]))
    served = full_width_serve(cfg, flash_attention_fwd)

    log(f"[6] serve CLI at SMOKE size ({elapsed()})")
    from repro_torch.launch.serve import main as serve_main
    reqs = serve_main(["--arch", "qwen3-14b", "--continuous", "--batch", "4",
                       "--prompt-len", "16", "--new-tokens", "8"])
    if any(len(r.generated) != 8 for r in reqs):
        raise AssertionError("serve CLI requests did not finish")

    log(f"[7] mamba2-370m training at full width ({elapsed()})")
    mcfg = mamba2_370m.CONFIG
    full_width_grads_check(mcfg, batch_size=2)
    trained = full_width_train(mcfg, ssd_scan_fwd, TRAIN_BATCH, TRAIN_STEPS)

    log(f"[8] train CLI at SMOKE size ({elapsed()})")
    from repro_torch.launch.train import main as train_main
    train_cli(train_main, "mamba2-370m")

    log(f"[9] mamba2-370m serving at full width ({elapsed()})")
    full_width_prefill_check(mcfg, (max(PROMPT_LENS),),
                             decode_steps=DECODE_CHECK_STEPS)
    ssd_state_check(mcfg)
    m_served = full_width_serve(mcfg, ssd_scan_fwd)

    log(f"[10] qwen3-14b training at full width, depth {QWEN_TRAIN_DEPTH} "
        f"({elapsed()})")
    full_width_grads_check(cfg, batch_size=QWEN_TRAIN_BATCH)
    q_trained = full_width_train(
        dataclasses.replace(cfg, n_layers=QWEN_TRAIN_DEPTH),
        flash_attention_fwd, QWEN_TRAIN_BATCH, QWEN_TRAIN_STEPS)

    log(f"[11] serve CLI (mamba2-370m) and train CLI (qwen3-14b) at SMOKE "
        f"size ({elapsed()})")
    reqs = serve_main(["--arch", "mamba2-370m", "--continuous", "--batch",
                       "4", "--prompt-len", "16", "--new-tokens", "8"])
    if any(len(r.generated) != 8 for r in reqs):
        raise AssertionError("serve CLI requests did not finish")
    train_cli(train_main, "qwen3-14b")

    log(f"[12] transformer2d-720m training at full width ({elapsed()})")
    dcfg = transformer2d_720m.CONFIG
    dit_grads_check(dcfg)
    dit_trained = dit_train(dcfg)
    train_cli(train_main, "transformer2d-720m")

    log(f"[13] transformer2d-720m under DSP ({elapsed()})")
    with tempfile.TemporaryDirectory() as work:
        log("  (a) world size 1 over NCCL, full width and depth")
        dsp_trained = dsp_world_of_one(dcfg, dit_trained, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo "
            f"({elapsed()})")
        dsp_four_ranks(dcfg, work)
    log(f"  done ({elapsed()})")

    log(f"[14] transformer2d-720m under the embedded-SP baselines and the "
        f"overlapped switch ({elapsed()})")
    with tempfile.TemporaryDirectory() as work:
        log("  (a) world size 1 over NCCL, full width")
        sp = sp_world_of_one(dcfg, dit_trained, work)
        log(f"  (b) {DSP_RANKS} ranks on the card over gloo ({elapsed()})")
        sp_four_ranks(dcfg, sp["bucket2"], work)
    sp_launches = sum(r["launches"] for r in sp["modes"].values())
    dit_runs = [dit_trained, dsp_trained, *sp["modes"].values()]
    k1_routes = by_route([served, q_trained] + dit_runs)
    log(f"  done ({elapsed()})")

    log(facts)
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention.py:36",
        "launches": (served["launches"] + q_trained["launches"]
                     + dit_trained["launches"] + dsp_trained["launches"]
                     + sp_launches),
        "launches_by_route": k1_routes,
        "max_abs_err": slice_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": library_ms,
        "kernel_route": route, "cuda_cores_ms": cuda_cores_ms,
        "dit": {**dit, "launches": dit_trained["launches"],
                "dsp_launches": dsp_trained["launches"],
                "sp_launches": {k: r["launches"]
                                for k, r in sp["modes"].items()},
                "launches_by_route": by_route(dit_runs),
                "max_abs_err": dit_err, "temporal": dit_temporal}}, {
        "name": "ssd_scan_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:35",
        "launches": trained["launches"] + m_served["launches"],
        "launches_by_route": by_route([trained, m_served]),
        "max_abs_err": ssd_err,
        "ms": ssd_ms, "plain_ms": ssd_plain_ms,
        "bound_ms": ssd_bound["bound_ms"], "bound_by": ssd_bound["bound_by"],
        "library_ms": None, "kernel_route": ssd_route_slice,
        "cuda_cores_ms": ssd_cuda_cores_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dsp-rank"]:
        dsp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--sp-rank"]:
        sp_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
