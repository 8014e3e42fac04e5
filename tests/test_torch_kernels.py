"""The port's flash-attention plain version and attention oracle against the
JAX package: the same numpy inputs through ``repro.kernels.ops.
flash_attention`` (the Pallas kernel, interpret mode on CPU) and
``repro_torch.kernels.ops.flash_attention`` (a CPU tensor takes the CUDA
kernel's plain version).  Tolerances as in tests/test_kernels.py: f32 sums
differ only in order (2e-5), bf16 outputs round once (2e-2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from test_kernels import ATTN_CASES

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_plain_matches_pallas(case, dt):
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    jdt, tdt, tol = DTYPES[dt]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, sq, skv, d),
                                        jdt, tdt)
    qoff = skv - sq if causal else 0
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    want = jops.flash_attention(jq, jk, jv, **kw)
    got = tops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fully_masked_rows_output_zero(dt):
    """Causal with a negative q_offset leaves the first rows no visible key:
    the kernel (and so its plain version) outputs 0 there, where
    ``attention_ref`` averages V uniformly."""
    jdt, tdt, tol = DTYPES[dt]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(1, 2, 2, 16, 16, 16, seed=3),
                                        jdt, tdt)
    kw = dict(causal=True, q_offset=-4)
    want = jops.flash_attention(jq, jk, jv, **kw)
    got = tops.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert not _np(got)[:, :, :4].any()
    avg = _np(tref.attention_ref(tq, tk, tv, **kw))[:, :, :4]
    assert np.abs(avg).max() > 0.01


@pytest.mark.parametrize("case", ATTN_CASES[2:4])   # window, softcap
def test_attention_ref_matches_jax(case):
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, sq, skv, d, 1),
                                        jnp.float32, torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.3,
              q_offset=skv - sq if causal else 0)
    np.testing.assert_allclose(_np(tref.attention_ref(tq, tk, tv, **kw)),
                               _np(jref.attention_ref(jq, jk, jv, **kw)),
                               atol=2e-5, rtol=2e-5)


def test_ref_backend_and_cpu_take_the_plain_version():
    _, (tq, tk, tv) = _both(_inputs(1, 4, 2, 24, 24, 32), jnp.float32,
                            torch.float32)
    before = flash_attention_fwd.launches
    want = flash_attention_plain(tq, tk, tv, causal=True)
    for backend in ("kernel", "ref"):
        got = tops.flash_attention(tq, tk, tv, causal=True, backend=backend)
        assert torch.equal(got, want)
    assert flash_attention_fwd.launches == before
    with pytest.raises(ValueError):
        tops.flash_attention(tq, tk, tv, backend="pallas")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the CUDA kernel or raises; it never computes on
    the CPU itself."""
    _, (tq, tk, tv) = _both(_inputs(1, 2, 2, 8, 8, 16), jnp.float32,
                            torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(tq, tk, tv)


def test_build_names_libraries_by_source_hash(monkeypatch, tmp_path):
    """Libraries land in the repo's ignored build/ dir under a name that
    changes with the sources; with no nvcc the build says so."""
    from repro_torch.kernels import build
    path = build.lib_path("flash_attention")
    assert path.parent == build.BUILD_DIR and path.parent.parts[-2] == "build"
    assert path == build.lib_path("flash_attention")
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "flash_attention.cu").write_text("// edited\n")
    monkeypatch.setattr(build, "CSRC", src)
    assert build.lib_path("flash_attention") != path
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
