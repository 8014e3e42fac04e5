"""The port's SSD scan and Mamba-2 block against the JAX package: the same
numpy inputs through ``repro.kernels.ops.ssd_scan`` (the Pallas kernel,
interpret mode on CPU) and ``repro_torch.kernels.ops.ssd_scan`` (a CPU
tensor takes the CUDA kernel's plain version).  Bars as in
tests/test_kernels.py: max |delta| / max |want| < 1e-5 in f32 (sums in
another order), < 3e-2 in bf16 (inputs and outputs round); gradients and
the block within 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import mamba2_370m as jconf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro_torch import bridge
from repro_torch.configs import mamba2_370m as tconf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
from repro_torch.models import ssm as TS
from test_kernels import SSD_CASES

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(b, l, h, p, g, s, seed=0):
    """x, dt (softplus), a (< 0), b, c, d_skip as float32 numpy."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((b, l, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    a = -np.exp(0.5 * rng.standard_normal(h))
    bm = rng.standard_normal((b, l, g, s))
    cm = rng.standard_normal((b, l, g, s))
    d = rng.standard_normal(h)
    return [t.astype(np.float32) for t in (x, dt, a, bm, cm, d)]


def _both(arrays, jdt, tdt):
    """x, dt, b, c in the working dtype; a and d_skip stay float32."""
    cast = (True, True, False, True, True, False)
    return ([jnp.asarray(t, jdt if c else jnp.float32)
             for t, c in zip(arrays, cast)],
            [torch.from_numpy(t).to(tdt if c else torch.float32)
             for t, c in zip(arrays, cast)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ssd_scan_matches_pallas(case, dt):
    b, l, h, p, g, s, chunk = case
    jdt, tdt, tol = DTYPES[dt]
    jin, tin = _both(_inputs(b, l, h, p, g, s), jdt, tdt)
    want = jops.ssd_scan(*jin, chunk=chunk)
    got = tops.ssd_scan(*tin, chunk=chunk)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert _rel(got, want) < tol


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_ref_matches_jax(with_state):
    """The sequential oracle, with a carried initial state and the final
    state returned."""
    b, l, h, p, g, s = 2, 24, 4, 8, 2, 16
    (jx, jdt, ja, jb, jc, jd), (tx, tdt, ta, tb, tc, td) = _both(
        _inputs(b, l, h, p, g, s, seed=1), jnp.float32, torch.float32)
    init = (np.random.RandomState(2).standard_normal((b, h, p, s))
            .astype(np.float32) if with_state else None)
    jy, jst = jref.ssd_ref(jx, jdt, ja, jb, jc, d_skip=jd, return_state=True,
                           init_state=None if init is None
                           else jnp.asarray(init))
    ty, tst = tref.ssd_ref(tx, tdt, ta, tb, tc, d_skip=td, return_state=True,
                           init_state=None if init is None
                           else torch.from_numpy(init))
    assert _rel(ty, jy) < 1e-5 and _rel(tst, jst) < 1e-5
    assert tuple(tst.shape) == (b, h, p, s)
    assert torch.equal(tref.ssd_ref(tx, tdt, ta, tb, tc, d_skip=td,
                                    init_state=None if init is None
                                    else torch.from_numpy(init)), ty)


@pytest.mark.parametrize("case", SSD_CASES[:2] + SSD_CASES[3:])
def test_ssd_chunked_ref_matches_jax(case):
    b, l, h, p, g, s, chunk = case
    (jx, jdt, ja, jb, jc, jd), (tx, tdt, ta, tb, tc, td) = _both(
        _inputs(b, l, h, p, g, s, seed=3), jnp.float32, torch.float32)
    want = jax.jit(functools.partial(jref.ssd_chunked_ref, chunk=chunk))(
        jx, jdt, ja, jb, jc, d_skip=jd)
    got = tref.ssd_chunked_ref(tx, tdt, ta, tb, tc, d_skip=td, chunk=chunk)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_ssd_chunk_invariance(chunk):
    """Any chunk gives the sequential recurrence (as JAX's
    test_ssd_chunk_invariance: atol 1e-4, rtol 1e-3)."""
    arrays = _inputs(1, 128, 2, 16, 1, 32, seed=4)
    (jx, jdt, ja, jb, jc, _), (tx, tdt, ta, tb, tc, _) = _both(
        arrays, jnp.float32, torch.float32)
    want = jref.ssd_ref(jx, jdt, ja, jb, jc)
    got = tops.ssd_scan(tx, tdt, ta, tb, tc, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-3)


def test_ssd_plain_pads_and_slices():
    """A ragged L runs as the zero-padded sequence, sliced back: the plain
    version at L=200 (chunk 64) equals it run on the inputs padded to 256,
    and the padded rows leave the state alone."""
    b, l, h, p, g, s, chunk = SSD_CASES[2]
    x, dt, a, bm, cm, _ = (torch.from_numpy(t)
                           for t in _inputs(b, l, h, p, g, s, seed=5))
    xdt = (x * dt[..., None]).transpose(1, 2).contiguous()
    da = (dt * a).transpose(1, 2).contiguous()
    bt, ct = bm.transpose(1, 2).contiguous(), cm.transpose(1, 2).contiguous()
    y = ssd_scan_plain(xdt, da, bt, ct, chunk=chunk)
    assert tuple(y.shape) == (b, h, l, p)
    pad = 256 - l
    yp = ssd_scan_plain(F.pad(xdt, (0, 0, 0, pad)), F.pad(da, (0, pad)),
                        F.pad(bt, (0, 0, 0, pad)), F.pad(ct, (0, 0, 0, pad)),
                        chunk=chunk)
    assert torch.allclose(yp[:, :, :l], y, atol=1e-6, rtol=1e-6)
    assert not yp[:, :, l:].any()
    want = tref.ssd_ref(x, dt, a, bm, cm).transpose(1, 2)
    np.testing.assert_allclose(_np(y), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", [SSD_CASES[1], SSD_CASES[2]])
@pytest.mark.parametrize("skip", [True, False])
def test_ssd_scan_grads_match_jax(case, skip):
    """Gradients w.r.t. x, dt, a, b, c (and d_skip) against jax.grad
    through JAX's custom VJP: both recompute through the chunked ref."""
    b, l, h, p, g, s, chunk = case
    arrays = _inputs(b, l, h, p, g, s, seed=6)
    cot = np.random.RandomState(7).standard_normal((b, l, h, p)).astype(
        np.float32)
    jin, tin = _both(arrays, jnp.float32, torch.float32)
    n = 6 if skip else 5

    def jloss(*args):
        return jnp.sum(jops.ssd_scan(*args, chunk=chunk) * cot)

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(n))))(*jin[:n])
    tin = [t.requires_grad_(True) for t in tin[:n]]
    (tops.ssd_scan(*tin, chunk=chunk) * torch.from_numpy(cot)).sum().backward()
    for name, t, want in zip(("x", "dt", "a", "b", "c", "d_skip"), tin, jg):
        assert _rel(t.grad, want) < 1e-4, name


def test_ref_backend_and_cpu_take_the_plain_version():
    _, tin = _both(_inputs(1, 40, 2, 8, 1, 16, seed=8), jnp.float32,
                   torch.float32)
    before = ssd_scan_fwd.launches
    want = tops.ssd_scan(*tin, chunk=16, backend="ref")
    assert torch.equal(tops.ssd_scan(*tin, chunk=16), want)
    assert ssd_scan_fwd.launches == before
    with pytest.raises(ValueError):
        tops.ssd_scan(*tin, chunk=16, backend="pallas")
    with pytest.raises(ValueError):
        tops.ssd_scan(*tin, chunk=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the CUDA kernel or raises; it never computes on
    the CPU itself."""
    xdt = torch.zeros(1, 2, 16, 8)
    da = torch.zeros(1, 2, 16)
    bm = torch.zeros(1, 1, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fwd(xdt, da, bm, bm, chunk=16)


def test_chip_smoke_ssd_bar_discriminates():
    """The bar chip_smoke holds K2 to (its plain version as the stand-in
    for the kernel here) passes a reordering of the same sums and fails a
    dropped row of b, in f32 and bf16, and a 1% error in one input row in
    f32."""
    import chip_smoke
    b, l, h, p, g, s = 2, 300, 4, 64, 1, 128
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, a, bm, cm, _ = (torch.from_numpy(t) for t in
                               _inputs(b, l, h, p, g, s, seed=10))
        dt = dt.to(dtype)
        xdt = (x.to(dtype) * dt[..., None]).transpose(1, 2).contiguous()
        da = (dt * a).transpose(1, 2).contiguous()
        bt = bm.to(dtype).transpose(1, 2).contiguous()
        ct = cm.to(dtype).transpose(1, 2).contiguous()
        want = ssd_scan_plain(xdt, da, bt, ct, chunk=128)
        share = chip_smoke.ssd_worst_share
        assert share(ssd_scan_plain(xdt, da, bt, ct, chunk=64), want) < 0.5
        dropped = bt.clone()
        dropped[:, :, 127] = 0
        assert share(ssd_scan_plain(xdt, da, dropped, ct, chunk=128),
                     want) > 10
        if dtype == torch.float32:
            off = xdt.clone()
            off[:, :, 150] *= 1.01
            assert share(ssd_scan_plain(off, da, bt, ct, chunk=128),
                         want) > 5


def test_build_compiles_the_ssd_source():
    from repro_torch.kernels import build
    assert (build.CSRC / "ssd_scan.cu").is_file()
    path = build.lib_path("ssd_scan")
    assert path.name.startswith("libssd_scan-") and path.suffix == ".so"
    assert path.parent == build.BUILD_DIR


# ---------------------------------------------------------------------------
# The Mamba-2 block at mamba2 SMOKE geometry (f32, chunk 16)
# ---------------------------------------------------------------------------

SCFG_J, SCFG_T = jconf.SMOKE.ssm_cfg, tconf.SMOKE.ssm_cfg


@pytest.fixture(scope="module")
def block_params():
    jp = JS.init_ssm(jax.random.PRNGKey(3), SCFG_J)
    return jp, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_ssm_block_matches_jax(block_params):
    jp, tp = block_params
    x = np.random.RandomState(9).standard_normal(
        (2, 40, SCFG_J.d_model)).astype(np.float32)
    want = JS.ssm_block(jp, jnp.asarray(x), SCFG_J, backend="pallas")
    got = TS.ssm_block(tp, torch.from_numpy(x), SCFG_T)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_init_ssm_matches_jax_tree():
    jp = JS.init_ssm(jax.random.PRNGKey(0), SCFG_J)
    gen = torch.Generator().manual_seed(0)
    tp = TS.init_ssm(gen, SCFG_T)
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype.name),
                                    jp)
    from repro_torch.models.lm import tree_map
    assert tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), tp) == \
        shapes
    for k in ("a_log", "dt_bias", "d_skip", "conv_b"):
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6)


def test_bridge_keeps_ssm_leaf_dtypes():
    """A bf16 mamba2 tree crosses over with its dtypes: a_log, dt_bias and
    d_skip stay float32, conv_w and the linears take the model dtype."""
    jp = JS.init_ssm(jax.random.PRNGKey(1), SCFG_J, dtype=jnp.bfloat16)
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    for k in ("a_log", "dt_bias", "d_skip"):
        assert tp[k].dtype == torch.float32, k
    for leaf in (tp["conv_w"], tp["conv_b"], tp["in_proj"]["w"],
                 tp["out_proj"]["w"], tp["norm"]["scale"]):
        assert leaf.dtype == torch.bfloat16
    assert torch.equal(tp["in_proj"]["w"].float(),
                       torch.from_numpy(np.asarray(jp["in_proj"]["w"],
                                                   np.float32)))
