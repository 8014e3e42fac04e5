"""Guards of the port's two rules: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import qwen3_14b
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine

from _torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), bad)
assert not bad, bad
for want in ("repro_torch.serving.scheduler", "repro_torch.train.trainer",
             "repro_torch.kernels.ssd_scan",
             "repro_torch.models.transformer2d", "repro_torch.core.plan",
             "repro_torch.core.schedule", "repro_torch.core.dsp",
             "repro_torch.launch.mesh", "repro_torch.core.overlap",
             "repro_torch.core.ring", "repro_torch.core.ulysses",
             "repro_torch.core.megatron_sp", "repro_torch.core.layout",
             "repro_torch.analysis.roofline",
             "repro_torch.parallel.partition",
             "repro_torch.train.checkpoint", "repro_torch.optim.compress",
             "repro_torch.serving.engine", "repro_torch.serving.kv_pool",
             "repro_torch.serving.block_pool",
             "repro_torch.serving.prefix_tree", "repro_torch.launch.serve",
             "repro_torch.models.moe", "repro_torch.configs.starcoder2_7b",
             "repro_torch.configs.gemma2_2b",
             "repro_torch.configs.qwen2_moe_a2_7b",
             "repro_torch.configs.mistral_large_123b",
             "repro_torch.configs.arctic_480b",
             "repro_torch.models.encdec",
             "repro_torch.configs.seamless_m4t_large_v2",
             "repro_torch.configs.pixtral_12b",
             "repro_torch.configs.jamba_1_5_large_398b"):
    assert want in mods, (want, mods)
from repro_torch.core.schedule import ScheduleExecutor2D
from repro_torch.models.transformer2d import (
    dsp2d_schedule, forward2d, make_spmd_forward2d, stages2d)
from repro_torch.launch.mesh import elastic_submesh, resolve_topology
from repro_torch.models.lm import serve_contract, sharded_argmax, with_patches
from repro_torch.models.encdec import argmax, decode_step, prefill
from repro_torch.parallel.partition import (
    BLOCK_DIM, assert_kv_cache_on_mesh, cache_pspecs, read_specs, reshard,
    store_contract, whole_params)
from repro_torch.models.transformer2d import param_contract, step_contract
from repro_torch.serving import (GARBAGE_BLOCK, BlockPool, PagedScheduler,
                                 PrefixTree)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT_WORKERS = r"""
import json, runpy, sys
out = {}
for path in sys.argv[1:]:
    # each worker starts from no JAX and no JAX package in sys.modules
    for m in [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]:
        del sys.modules[m]
    try:
        runpy.run_path(path, run_name="gloo_worker")
        out[path] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    except Exception as e:
        out[path] = [f"raised {e!r}"]
print(json.dumps(out))
"""

WORKERS = ["_torch_dsp_worker.py", "_torch_sp_worker.py",
           "_torch_l2d_worker.py", "_torch_lmdsp_worker.py",
           "_torch_zero_worker.py", "_torch_ckpt_worker.py",
           "_torch_serve_worker.py", "_torch_paged_worker.py",
           "_torch_t2d_zero_worker.py", "_torch_moe_ep_worker.py",
           "_torch_tp_worker.py", "_torch_encdec_worker.py",
           "_torch_moe_tp_worker.py", "_torch_moe_serve_worker.py",
           "_torch_encdec_serve_worker.py", "_torch_vlm_worker.py",
           "_torch_jamba_worker.py"]


@pytest.fixture(scope="module")
def worker_imports():
    """Each gloo worker loaded in turn in one subprocess (the JAX modules
    cleared from ``sys.modules`` before each): {worker: the JAX and JAX
    package modules it loaded, or what it raised}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    paths = [os.path.join(ROOT, "tests", w) for w in WORKERS]
    out = subprocess.run([sys.executable, "-c", _IMPORT_WORKERS, *paths],
                         cwd=os.path.join(ROOT, "tests"), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    return {os.path.basename(k): v for k, v in got.items()}


@pytest.mark.parametrize("worker", WORKERS)
def test_gloo_workers_import_no_jax_and_no_repro(worker_imports, worker):
    """The port's side of each multi-process check (a gloo rank) loads, with
    the helpers it shares with its JAX side, nothing of JAX or of the JAX
    package: the JAX side runs in its own subprocess."""
    assert worker_imports[worker] == [], worker_imports[worker]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    cfg = qwen3_14b.SMOKE
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_paged_caches(cfg, 1, 16, 16, 2)
    params = lm.init_lm(0, cfg, device="cpu")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(params, cfg, **kw)
    assert ServingEngine(params, cfg, device="cpu").device.type == "cpu"


def test_serve_cli_defaults_to_cuda(no_cuda):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "qwen3-14b"])


def test_training_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs import mamba2_370m
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch.train import main
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = mamba2_370m.SMOKE
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(0, cfg)
    params = lm.init_lm(0, cfg, device="cpu")
    kw = dict(loss_fn=None, params=params, opt_cfg=OptConfig(),
              cfg=TrainerConfig(), data_fn=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(**kw)
    assert Trainer(device="cpu", **kw).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(DataConfig(), 0)
    assert make_batch(DataConfig(), 0, device="cpu")["tokens"].device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "mamba2-370m"])


def test_cuda_mesh_needs_cuda(no_cuda):
    """``make_mesh`` and ``submesh`` on ``cuda`` raise without CUDA, before
    any process group is asked for."""
    from repro_torch.launch.mesh import make_mesh, submesh
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 4), ("data", "model"), "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        submesh(4)


def test_flash_attention_kernel_path_takes_gradients(monkeypatch):
    """The kernel route of ``ops.flash_attention`` no longer raises when a
    gradient is asked for: the kernel runs the forward once (a plain
    stand-in here, as the CPU has no kernel) and the backward recomputes
    through ``attention_ref`` without launching it again."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_plain
    calls = []

    def stand_in(q, k, v, **kw):
        calls.append(all(t.is_contiguous() for t in (q, k, v)))
        return flash_attention_plain(q, k, v, **kw)

    monkeypatch.setattr(ops, "_use_plain", lambda t, backend: False)
    monkeypatch.setattr(ops, "flash_attention_fwd", stand_in)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).requires_grad_(True)
               for shape in ((1, 4, 12, 16), (1, 2, 12, 16), (1, 2, 12, 16)))
    kw = dict(causal=True, window=5, softcap=20.0, scale=0.3)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    out = ops.flash_attention(strided, k, v, **kw)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert calls == [True]
    want = torch.autograd.grad(ref.attention_ref(q, k, v, **kw).square()
                               .sum(), (q, k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_cli_flags_of_the_checkpoint_slice_are_ported(tmp_path):
    """The train CLI's ``--ckpt-dir``, ``--resume``, ``--grad-compress``
    and ``--replan`` and the serve CLI's ``--ckpt-dir``, ``--mode``,
    ``--topology``, ``--data`` and ``--replan`` no longer exit "not yet
    ported" (at world size 1 the mesh flags serve unsharded); ``--devices``
    still does in both, naming ``torchrun --nproc-per-node``."""
    from repro_torch.launch import serve, train
    base = ["--arch", "mamba2-370m", "--device", "cpu", "--steps", "0"]
    for flags in (["--ckpt-dir", str(tmp_path)], ["--resume"],
                  ["--grad-compress"], ["--replan", "1"]):
        assert train.main(base + flags)["final_step"] == 0
    assert serve.main(["--arch", "mamba2-370m", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "4",
                       "--new-tokens", "2", "--ckpt-dir",
                       str(tmp_path)]).shape == (1, 2)
    with pytest.raises(SystemExit, match="not yet ported; torchrun "
                       "--nproc-per-node"):
        train.main(base + ["--devices", "4"])
    sbase = ["--arch", "qwen3-14b", "--device", "cpu", "--batch", "2",
             "--prompt-len", "4", "--new-tokens", "2"]
    want = serve.main(sbase)
    for flags in (["--mode", "dsp"], ["--mode", "none"],
                  ["--topology", "uniform"], ["--data", "1"],
                  ["--replan", "1"]):
        assert torch.equal(serve.main(sbase + flags), want)
    with pytest.raises(SystemExit, match="not yet ported; torchrun "
                       "--nproc-per-node"):
        serve.main(sbase + ["--devices", "4"])
