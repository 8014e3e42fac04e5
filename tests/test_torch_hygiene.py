"""Guards of the port's two rules: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless the caller asks for
the CPU."""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import qwen3_14b
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine

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
             "repro_torch.core.megatron_sp",
             "repro_torch.analysis.roofline"):
    assert want in mods, (want, mods)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    cfg = qwen3_14b.SMOKE
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_caches(cfg, 1, 8)
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
