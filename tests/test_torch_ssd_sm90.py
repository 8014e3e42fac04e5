"""The SSD scan's two CUDA routes, on the CPU: the route table, the
wrappers' refusal of CPU tensors, the route counters, the sm90 library's
build name, the strides the sm90 kernel's tensor maps take, and what
chip_smoke.py's bf16 bar discriminates in the sm90 kernel's arithmetic.

The sm90 kernel (``csrc/ssd_scan_sm90.cu``) cannot run here, so
``_sm90_emulation`` repeats its arithmetic in plain PyTorch: c b^T of bf16
inputs accumulated in f32, the decayed M, w = exp(cum_Q - cum) xdt and the
state's operand copy each as a bf16 hi + lo pair, the state itself carried
in f32, y rounded once.  Against ``ssd_scan_plain`` it stays under half of
``chip_smoke.ssd_worst_share``'s bf16 bar; with a dropped inter-chunk term,
an undecayed state or the causal edge one row off it exceeds ten times it.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as K
from repro_torch.kernels.ssd_scan import ssd_scan_fwd, ssd_scan_plain
from test_torch_ssd import _inputs

SHAPES = [(64, 128, 128), (64, 128, 64), (32, 128, 128), (64, 64, 128),
          (16, 32, 64), (8, 16, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_table_sends_bf16_at_the_mamba2_shape_to_sm90(dtype, shape):
    want = ("sm90" if dtype == torch.bfloat16 and shape == (64, 128, 128)
            else "cuda_cores")
    assert K.route_for(dtype, *shape) == want


def _kernel_inputs(b, l, h, p, g, s, dtype, seed=0):
    """xdt, da, b, c in the kernel layout, as ``kernels.ops`` forms them."""
    x, dt, a, bm, cm, _ = (torch.from_numpy(t)
                           for t in _inputs(b, l, h, p, g, s, seed))
    dt = dt.to(dtype)
    xdt = (x.to(dtype) * dt[..., None]).transpose(1, 2).contiguous()
    da = (dt * a).transpose(1, 2).contiguous()
    return (xdt, da, bm.to(dtype).transpose(1, 2).contiguous(),
            cm.to(dtype).transpose(1, 2).contiguous())


@pytest.mark.parametrize("dtype,p,s", [(torch.bfloat16, 64, 128),
                                       (torch.float32, 64, 128),
                                       (torch.bfloat16, 16, 32)])
def test_kernel_wrapper_refuses_cpu_tensors_on_every_route(dtype, p, s):
    """Either route launches its CUDA kernel or raises; neither computes on
    the CPU, and a refused call counts no launch."""
    xdt, da, b, c = _kernel_inputs(1, 16, 2, p, 1, s, dtype)
    before = (ssd_scan_fwd.launches, dict(ssd_scan_fwd.route_launches))
    for route in (None, "sm90", "cuda_cores"):
        with pytest.raises(ValueError, match="CUDA"):
            ssd_scan_fwd(xdt, da, b, c, chunk=128, route=route)
    assert (ssd_scan_fwd.launches,
            dict(ssd_scan_fwd.route_launches)) == before


def test_reset_launches_zeroes_the_total_and_every_route():
    ssd_scan_fwd.launches = 5
    ssd_scan_fwd.route_launches["sm90"] = 3
    ssd_scan_fwd.route_launches["cuda_cores"] = 2
    K.reset_launches()
    assert ssd_scan_fwd.launches == 0
    assert ssd_scan_fwd.route_launches == {"sm90": 0, "cuda_cores": 0}


def test_build_names_the_sm90_library_by_source_hash(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    assert (build.CSRC / "ssd_scan_sm90.cu").is_file()
    path = build.lib_path("ssd_scan_sm90")
    assert path.name.startswith("libssd_scan_sm90-")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.lib_path("ssd_scan_sm90")
    src = tmp_path / "csrc"
    src.mkdir()
    for f in build.CSRC.iterdir():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    assert build.lib_path("ssd_scan_sm90") == path
    (src / "ssd_scan_sm90.cu").write_text("// edited\n")
    assert build.lib_path("ssd_scan_sm90") != path


def test_tma_strides_take_the_model_layout_views():
    """mamba2's xdt (B, L, H, P) and the b/c slices of its conv output
    (B, L, D_xbc) go to the sm90 kernel as transposed views, strides and
    all; a dim of length 1 reports its contiguous stride."""
    bsz, l, h, p, g, s, d_inner = 2, 300, 4, 64, 1, 128, 2048
    xdt = torch.zeros(bsz, l, h, p, dtype=torch.bfloat16).transpose(1, 2)
    assert K._tma_strides("xdt", xdt) == [l * h * p, p, h * p]
    xbc = torch.zeros(bsz, l, d_inner + 2 * g * s, dtype=torch.bfloat16)
    bm = xbc[..., d_inner:d_inner + g * s].reshape(bsz, l, g, s)
    cm = xbc[..., d_inner + g * s:].reshape(bsz, l, g, s)
    row = d_inner + 2 * g * s
    for t in (bm, cm):
        assert K._tma_strides("b", t.transpose(1, 2)) == [l * row, l * s,
                                                          row]
    one = torch.zeros(1, l, h, p, dtype=torch.bfloat16).transpose(1, 2)
    assert K._tma_strides("xdt", one)[0] == h * l * p


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(1, 2, 40, 68, dtype=torch.bfloat16)[..., :64],
    lambda: torch.zeros(1, 2, 64, 40, dtype=torch.bfloat16).transpose(2, 3),
    lambda: torch.zeros(1, 2, 40 * 64 + 1,
                        dtype=torch.bfloat16)[..., 1:].reshape(1, 2, 40, 64),
], ids=["row_stride_68_not_16_bytes", "last_dim_strided", "base_unaligned"])
def test_tma_strides_refuse_what_a_tensor_map_cannot_take(make):
    with pytest.raises(ValueError, match="16 bytes|16-byte|unit-stride"):
        K._tma_strides("xdt", make())


def _hi_lo(t):
    """t as a bf16 hi + lo pair, each widened back to f32."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _sm90_emulation(xdt, da, b, c, *, split=True, drop_inter=None,
                    no_state_decay=False, causal_shift=0):
    """The sm90 kernel's arithmetic in plain PyTorch, chunk 128: rows past
    L zero (the tensor maps' fill); M, w and the state's operand copy as
    bf16 hi + lo pairs, two products each (``split=False``: one rounding
    each, lo = 0); the state in f32; y rounded once to bf16.
    ``drop_inter`` skips one chunk's inter-chunk term, ``no_state_decay``
    leaves out the state's exp(cum_Q) and ``causal_shift`` moves the
    causal edge: faults the bar must catch."""
    def pair(t):
        hi, lo = _hi_lo(t)
        return (hi, lo) if split else (hi, torch.zeros_like(lo))
    q = 128
    bs, h, l, p = xdt.shape
    g = b.shape[1]
    pad = (-l) % q
    xf = F.pad(xdt.float(), (0, 0, 0, pad))
    daf = F.pad(da.float(), (0, pad))
    bf = F.pad(b.float().repeat_interleave(h // g, dim=1), (0, 0, 0, pad))
    cf = F.pad(c.float().repeat_interleave(h // g, dim=1), (0, 0, 0, pad))
    rows = torch.arange(q)
    mask = rows[None, :] <= rows[:, None] + causal_shift
    state = xf.new_zeros((bs, h, p, b.shape[3]))
    ys = []
    for k, l0 in enumerate(range(0, l + pad, q)):
        x_c, b_c, c_c = (t[:, :, l0:l0 + q] for t in (xf, bf, cf))
        cum = torch.cumsum(daf[:, :, l0:l0 + q], dim=-1)
        total = cum[..., -1:]
        seg = cum[..., :, None] - cum[..., None, :]
        seg = torch.where(mask, seg, torch.full_like(seg, float("-inf")))
        m_hi, m_lo = pair((c_c @ b_c.transpose(-1, -2)) * torch.exp(seg))
        st_hi, st_lo = pair(state)
        y_inter = (c_c @ st_hi.transpose(-1, -2)
                   + c_c @ st_lo.transpose(-1, -2))
        if k == drop_inter:
            y_inter = torch.zeros_like(y_inter)
        ys.append(y_inter * torch.exp(cum)[..., None]
                  + (m_hi @ x_c + m_lo @ x_c))
        w_hi, w_lo = pair(torch.exp(total - cum)[..., None] * x_c)
        decay = 1.0 if no_state_decay else torch.exp(total)[..., None]
        state = (decay * state + w_hi.transpose(-1, -2) @ b_c
                 + w_lo.transpose(-1, -2) @ b_c)
    return torch.cat(ys, dim=2)[:, :, :l].to(xdt.dtype)


# B, L, H, P, G, S: one chunk's first row, shorter than a chunk, ragged
# lengths, a whole train_4k sequence narrowed from 32 heads to 2, and two
# B/C groups
SM90_CASES = [(1, 1, 2, 64, 1, 128), (1, 100, 2, 64, 1, 128),
              (1, 300, 2, 64, 1, 128), (1, 4000, 2, 64, 1, 128),
              (1, 4096, 2, 64, 1, 128), (1, 300, 4, 64, 2, 128)]


@pytest.mark.parametrize("case", SM90_CASES,
                         ids=lambda c: f"L{c[1]}_H{c[2]}_G{c[4]}")
def test_chip_smoke_ssd_bar_passes_the_sm90_arithmetic(case):
    """The roundings the sm90 kernel adds to the plain version's (each a
    hi + lo pair) stay under half of chip_smoke's unchanged bf16 bar: the
    outputs differ by at most the one-ulp flip of their final rounding."""
    import chip_smoke
    xdt, da, b, c = _kernel_inputs(*case, torch.bfloat16, seed=21)
    want = ssd_scan_plain(xdt, da, b, c, chunk=128)
    got = _sm90_emulation(xdt, da, b, c)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert chip_smoke.ssd_worst_share(got, want) < 0.5


@pytest.mark.parametrize("fault", [dict(drop_inter=5),
                                   dict(no_state_decay=True),
                                   dict(causal_shift=-1),
                                   dict(causal_shift=1)],
                         ids=["inter_chunk_dropped", "state_not_decayed",
                              "causal_edge_minus_1", "causal_edge_plus_1"])
def test_chip_smoke_ssd_bar_catches_the_sm90_faults(fault):
    """The same arithmetic with one chunk's inter-chunk term dropped, the
    state not decayed by exp(cum_Q), or the causal edge one row off,
    exceeds ten times the bar at the longest case."""
    import chip_smoke
    xdt, da, b, c = _kernel_inputs(*SM90_CASES[4], torch.bfloat16, seed=22)
    want = ssd_scan_plain(xdt, da, b, c, chunk=128)
    got = _sm90_emulation(xdt, da, b, c, **fault)
    assert chip_smoke.ssd_worst_share(got, want) > 10


def test_single_rounding_of_an_operand_would_break_half_the_bar():
    """Why the kernel splits its operands: the emulation with M, w and the
    state copy each rounded once to bf16 reaches half the bar at the full
    sequence, where the hi + lo pairs stay under it."""
    import chip_smoke
    xdt, da, b, c = _kernel_inputs(*SM90_CASES[4], torch.bfloat16, seed=21)
    want = ssd_scan_plain(xdt, da, b, c, chunk=128)
    share = chip_smoke.ssd_worst_share
    assert share(_sm90_emulation(xdt, da, b, c), want) < 0.5
    assert share(_sm90_emulation(xdt, da, b, c, split=False), want) >= 0.5
