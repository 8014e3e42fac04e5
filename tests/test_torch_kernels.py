"""The port's flash-attention plain version and attention oracle against the
JAX package: the same numpy inputs through ``repro.kernels.ops.
flash_attention`` (the Pallas kernel, interpret mode on CPU) and
``repro_torch.kernels.ops.flash_attention`` (a CPU tensor takes the CUDA
kernel's plain version).  Tolerances as in tests/test_kernels.py: f32 sums
differ only in order (2e-5), bf16 outputs round once (2e-2).  Also the route
table between the two CUDA kernels, their build names, and what
chip_smoke.py's bf16 bar catches in the tensor-core kernel's arithmetic.
Gradients: the port's autograd ``Function`` against JAX's custom VJP, both
recomputing through their ``attention_ref`` (f32, 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                 flash_attention_plain)
from test_kernels import ATTN_CASES
from _torch_threads import one_thread  # noqa: E402,F401

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


# GQA causal, MQA + window, softcap over cross lengths, decode-like Sq = 1
# at q_offset 299, everything on
GRAD_CASES = [ATTN_CASES[i] for i in (1, 2, 3, 5, 6)]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_flash_attention_grads_match_jax(case):
    """dq, dk, dv of ``ops.flash_attention`` (the plain forward on CPU
    tensors, the backward through ``attention_ref``) against JAX's
    ``custom_vjp`` (the Pallas forward in interpret mode, the backward
    through its ``attention_ref``), for one random cotangent."""
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    arrays = _inputs(b, hq, hkv, sq, skv, d, seed=4)
    cot = np.random.RandomState(5).standard_normal(
        (b, hq, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=skv - sq if causal else 0)
    jin, tin = _both(arrays, jnp.float32, torch.float32)
    want = jax.grad(lambda *a: jnp.sum(jops.flash_attention(*a, **kw) * cot),
                    argnums=(0, 1, 2))(*jin)
    tin = [t.requires_grad_(True) for t in tin]
    got = torch.autograd.grad(tops.flash_attention(*tin, **kw), tin,
                              torch.from_numpy(cot))
    for name, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == w.shape, name
        err = np.abs(_np(g) - _np(w)).max() / np.abs(_np(w)).max()
        assert err < 1e-5, (name, err)


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


# ---------------------------------------------------------------------------
# Routing between the two CUDA kernels, and what the bf16 bar discriminates
# for the tensor-core design
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_table_sends_bf16_at_64_and_128_to_sm90(dtype, d):
    """bf16 at head dims 64, 72 (the 2D DiT's) and 128 takes the tensor
    cores; f32 and every other head dim the CUDA cores."""
    want = ("sm90" if dtype == torch.bfloat16 and d in (64, 72, 128)
            else "cuda_cores")
    assert fa.ROUTES[(dtype, d)] == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 72)])
def test_kernel_wrapper_refuses_cpu_tensors_on_every_route(dtype, d):
    """Either route launches its CUDA kernel or raises; neither computes on
    the CPU, and a refused call counts no launch."""
    _, (tq, tk, tv) = _both(_inputs(1, 2, 1, 8, 8, d), jnp.float32, dtype)
    before = dict(fa.flash_attention_fwd.route_launches)
    for route in (None, "sm90", "cuda_cores"):
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_fwd(tq, tk, tv, causal=True, route=route)
    assert fa.flash_attention_fwd.route_launches == before


def test_reset_launches_zeroes_the_total_and_every_route():
    fa.flash_attention_fwd.launches = 3
    fa.flash_attention_fwd.route_launches["sm90"] = 3
    fa.reset_launches()
    assert fa.flash_attention_fwd.launches == 0
    assert fa.flash_attention_fwd.route_launches == {"sm90": 0,
                                                     "cuda_cores": 0}


def test_build_names_the_sm90_library_by_source_hash(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    assert (build.CSRC / "flash_attention_sm90.cu").is_file()
    path = build.lib_path("flash_attention_sm90")
    assert path.name.startswith("libflash_attention_sm90-")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.lib_path("flash_attention_sm90")
    src = tmp_path / "csrc"
    src.mkdir()
    for f in build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    assert build.lib_path("flash_attention_sm90") == path
    (src / "flash_attention_sm90.cu").write_text("// edited\n")
    assert build.lib_path("flash_attention_sm90") != path


def _sm90_emulation(q, k, v, *, causal=False, window=None, softcap=None,
                    q_offset=0, bk=128, drop_tile=None, causal_shift=0,
                    qk_cols=None, pv_cols=None, scale_d=None):
    """The sm90 kernel's arithmetic in plain PyTorch: q, k and v
    zero-padded from D to wgmma's K step (16: 72 -> 80) with the scale
    from the true D, online softmax over BK-wide key tiles in f32, P
    rounded to the input dtype (bf16) before P V, f32 accumulation, one
    division by l at the end, O cut back to D, out in the input dtype.
    Faults the bar must catch: ``drop_tile`` skips one key tile,
    ``causal_shift`` moves the causal edge, ``qk_cols`` runs Q K^T over
    only that many columns, ``pv_cols`` forms only that many columns of
    O, ``scale_d`` takes the scale from another head dim."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dp = -(-d // 16) * 16
    pad = [torch.nn.functional.pad(t.float(), (0, dp - d)) for t in (q, k, v)]
    qf = pad[0].reshape(b, hkv, hq // hkv, sq, dp)
    kf, vf = pad[1], pad[2]
    if qk_cols is not None:
        kf = torch.cat([kf[..., :qk_cols],
                        torch.zeros_like(kf[..., qk_cols:])], dim=-1)
    scale = (d if scale_d is None else scale_d) ** -0.5
    qpos = (q_offset + torch.arange(sq))[:, None]
    m = torch.full((b, hkv, hq // hkv, sq, 1), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for t, k0 in enumerate(range(0, skv, bk)):
        if t == drop_tile:
            continue
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kt) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        vis = torch.ones(sq, kt.shape[2], dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos + causal_shift
        if window is not None:
            vis &= kpos > qpos - window
        s = s.masked_fill(~vis, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhgqk,bhkd->bhgqd",
                                     p.to(q.dtype).float(), vt)
        m = m_new
    o = o / torch.where(l == 0, torch.ones_like(l), l)
    if pv_cols is not None:
        o[..., pv_cols:] = 0
    return o[..., :d].reshape(b, hq, sq, d).to(q.dtype)


def _bf16_case(case, seed):
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    _, (tq, tk, tv) = _both(_inputs(b, hq, hkv, sq, skv, d, seed),
                            jnp.float32, torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=skv - sq if causal else 0)
    return (tq, tk, tv), kw


# qwen3-14b prefill layers at three of the served prompt lengths (the
# longest, a ragged one, the shortest), narrowed from 40/8 heads to 2/1
SERVED_NARROW = [(1, 2, 1, s, s, 128, True, None, None)
                 for s in (2048, 1389, 512)]
# the 2D DiT's K1 shapes at head dim 72, non-causal, narrowed from 16 heads
# to 2: spatial (a folded frame, 4096 patches), temporal (folded patches,
# 16 frames) and chip_smoke's ragged case
DIT_NARROW = [(1, 2, 2, 4096, 4096, 72, False, None, None),
              (256, 2, 2, 16, 16, 72, False, None, None),
              (1, 3, 3, 100, 100, 72, False, None, None)]


@pytest.mark.parametrize("case", SERVED_NARROW + list(ATTN_CASES)
                         + DIT_NARROW)
def test_chip_smoke_attention_bar_passes_the_sm90_arithmetic(case):
    """Rounding P to bf16 before P V, the one rounding the sm90 kernel adds
    to the plain version's, stays under half of chip_smoke's unchanged bf16
    bar: the outputs differ by at most the one-ulp flip of their final
    rounding, which reads just under 0.5 of the bar (two ulps of the row's
    max), and never by a second ulp.  Padding D = 72 to 80 adds zeros."""
    import chip_smoke
    (tq, tk, tv), kw = _bf16_case(case, seed=11)
    want = flash_attention_plain(tq, tk, tv, **kw)
    got = _sm90_emulation(tq, tk, tv, **kw)
    assert chip_smoke.attn_worst_share(got, want, torch.bfloat16) < 0.5


# faults at the longest served shape, then (with a head dim) at the DiT's
# spatial one: Q K^T over D / 16 = 4 K steps (64 columns), P V at n64, and
# the scale from the padded 80
FAULTS = [dict(drop_tile=0), dict(drop_tile=7), dict(causal_shift=-1),
          dict(causal_shift=1), dict(qk_cols=64), dict(pv_cols=64),
          dict(scale_d=80)]


@pytest.mark.parametrize("fault", FAULTS)
def test_chip_smoke_attention_bar_catches_a_dropped_tile_or_shifted_mask(
        fault):
    """The same arithmetic with one key tile dropped, or the causal edge
    one key off, exceeds the bar at the longest served shape by a clear
    factor; so does the D = 72 arithmetic at the DiT's spatial shape with
    Q K^T cut to 64 columns, O to 64 columns, or the scale from 80."""
    import chip_smoke
    head_dim = {"qk_cols", "pv_cols", "scale_d"} & set(fault)
    case = DIT_NARROW[0] if head_dim else SERVED_NARROW[0]
    (tq, tk, tv), kw = _bf16_case(case, seed=12)
    want = flash_attention_plain(tq, tk, tv, **kw)
    got = _sm90_emulation(tq, tk, tv, **kw, **fault)
    assert chip_smoke.attn_worst_share(got, want, torch.bfloat16) > 10


@pytest.mark.parametrize("case", DIT_NARROW)
def test_sm90_padded_arithmetic_matches_pallas_in_f32(case):
    """The sm90 kernel's arithmetic at D = 72 (zero-padded to 80, scale
    from 72, O cut back), in f32 and so before any bf16 rounding, against
    JAX's Pallas kernel in interpret mode: the sums differ only in order
    (1e-5)."""
    b, hq, hkv, sq, skv, d, causal, window, softcap = case
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs(b, hq, hkv, sq, skv, d, 13),
                                        jnp.float32, torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=0)
    want = jops.flash_attention(jq, jk, jv, **kw)
    got = _sm90_emulation(tq, tk, tv, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("budget,slices", [(1, 5), (2 * 4 * 24 * 24 * 4, 3)])
def test_backward_recompute_over_batch_slices_matches_one_slice(
        monkeypatch, budget, slices):
    """With ``BACKWARD_SCORE_BYTES`` patched small, the backward recomputes
    through ``attention_ref`` over several slices of the batch dim (one
    sequence each, or two of the 5), and the grads equal those of one
    recompute of the whole batch."""
    b, hq, hkv, s, d = 5, 4, 2, 24, 16
    arrays = _inputs(b, hq, hkv, s, s, d, seed=8)
    cot = torch.from_numpy(np.random.RandomState(9).standard_normal(
        (b, hq, s, d)).astype(np.float32))
    kw = dict(causal=True, window=9, softcap=20.0)

    def grads():
        tin = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        return torch.autograd.grad(tops.flash_attention(*tin, **kw), tin, cot)

    whole = grads()
    calls = []
    ref_fn = tops._ref.attention_ref

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return ref_fn(*a, **k)

    monkeypatch.setattr(tops._ref, "attention_ref", counted)
    monkeypatch.setattr(tops, "BACKWARD_SCORE_BYTES", budget)
    sliced = grads()
    assert len(calls) == slices and sum(calls) == b
    for g, w in zip(sliced, whole):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_backward_recompute_is_one_slice_at_batch_one(monkeypatch):
    """qwen3-14b training's shape (batch 1, 40 heads, 4096 tokens: 2.7 GB of
    scores, over the budget) still recomputes in one slice: a slice holds
    at least one sequence."""
    calls = []

    def stand_in(q, k, v, **kw):
        calls.append(q.shape[0])
        return q * 1.0

    monkeypatch.setattr(tops._ref, "attention_ref", stand_in)
    assert 4 * 40 * 4096 * 4096 > tops.BACKWARD_SCORE_BYTES
    q = torch.zeros((1, 40, 4096, 1), requires_grad=True)
    kv = torch.zeros((1, 8, 4096, 1))
    out = tops._FlashAttention.apply(q, kv, kv, {}, True)
    out.sum().backward()
    assert calls == [1]


# K1's function with a softcap or a window: the cases phase 4 times against
# ``flex_attention`` in place of ``scaled_dot_product_attention``
LIBRARY_CASES = [(1, 4, 2, 48, 96, 32, True, 20, 2.0),
                 (1, 2, 2, 64, 64, 16, False, None, 3.0),
                 (2, 4, 1, 40, 40, 32, True, 9, None)]


@pytest.mark.parametrize("case", LIBRARY_CASES)
def test_chip_smoke_library_attention_is_k1s_function(case):
    """``chip_smoke.library_attention`` (``flex_attention`` with the
    softcap as its score_mod and the causal and window limits at
    ``q_offset`` as its block mask), run eagerly in float32, within 1e-5
    of the largest |value| of K1's plain version."""
    import chip_smoke
    b, hq, hkv, sq, skv, d = case[:6]
    g = torch.Generator().manual_seed(14)
    q = torch.randn((b, hq, sq, d), generator=g)
    k, v = (torch.randn((b, hkv, skv, d), generator=g) for _ in range(2))
    want = flash_attention_plain(q, k, v, **chip_smoke.attn_kw(case))
    got = chip_smoke.library_attention(case, compile=False)(q, k, v)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("budget,groups", [(1, [1, 1, 1]),
                                           (2 * 2 * 24 * 24 * 4, [2, 1])])
def test_backward_recompute_over_head_groups_matches_one_slice(
        monkeypatch, budget, groups):
    """With ``BACKWARD_HEAD_SCORE_BYTES`` patched small, each sequence
    recomputes over groups of its K/V heads with their q heads (GQA 6/3:
    one K/V head a group, or two and then one), and the grads equal
    those of one recompute of the whole batch."""
    b, hq, hkv, s, d = 2, 6, 3, 24, 16
    arrays = _inputs(b, hq, hkv, s, s, d, seed=10)
    cot = torch.from_numpy(np.random.RandomState(11).standard_normal(
        (b, hq, s, d)).astype(np.float32))
    kw = dict(causal=True, window=9, softcap=20.0)

    def grads():
        tin = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        return torch.autograd.grad(tops.flash_attention(*tin, **kw), tin, cot)

    whole = grads()
    calls = []
    ref_fn = tops._ref.attention_ref

    def counted(*a, **k):
        calls.append((a[0].shape[0], a[0].shape[1], a[1].shape[1]))
        return ref_fn(*a, **k)

    monkeypatch.setattr(tops._ref, "attention_ref", counted)
    monkeypatch.setattr(tops, "BACKWARD_HEAD_SCORE_BYTES", budget)
    sliced = grads()
    assert calls == [(b, 2 * n, n) for n in groups]
    for g, w in zip(sliced, whole):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
