"""The port's embedded-SP baselines and overlapped switch over
``torch.distributed`` against the JAX package's on the CPU: 4 gloo
processes (``tests/_torch_sp_worker.py``) on one ``FileStore``, and the
JAX side on 4 simulated devices in a subprocess (``tests/_torch_sp_jax.py``),
as ``tests/test_torch_dsp.py`` runs DSP.

The model is ``tests/md_scenarios.py``'s small DiT (4 blocks, d 64, 4
heads, d_ff 128, in_dim 16, f32; x of (2, 8, 16, 16)) with every block's
modulation drawn from seeded normals.  Each scenario
(``_torch_sp_jax.SCENARIOS``: ``ulysses``, ``ulysses_fused``, ``ring``,
``megatron``, ``dsp`` and ``dsp`` with ``overlap`` of ``chunked`` and
``double_buffer`` on (1, 4); ``megatron`` on (2, 2) over ``("data",
"model")``; ``hybrid`` on ``make_sp2d_mesh(2, 2)``) runs JAX's
``make_spmd_forward(mode=..., backend="ref")`` against the port's.  Bars:
outputs within 1e-5 of the largest |value| (f32, the same math summed in
another order); the loss, the sum of the output's squares, within 1e-5
relative; gradients, summed over the world, within 1e-4 of each leaf's
max against ``jax.grad``.  Collectives and bytes per rank are exact: the
contract below, from both packages' code.  The checks that raise are
``tests/test_torch_dsp.py::test_mode_checks_raise``."""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.analysis import roofline as JR
from repro.models import transformer2d as JT
from repro_torch.analysis import roofline as TR
from repro_torch.core import dsp
from repro_torch.core import megatron_sp
from repro_torch.core.overlap import OVERLAP_MODES, overlapped_switch
from repro_torch.core.ring import _block_attn, ring_attention, stream_bytes
from repro_torch.core.topology import Topology
from repro_torch.core.ulysses import attention_bytes
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import transformer2d as TT

HERE = os.path.dirname(__file__)
sys.path.insert(0, HERE)
from _torch_sp_jax import SCENARIOS  # noqa: E402
from test_torch_dsp import _flatten, _inputs, _perturbed_params  # noqa: E402

SRC = os.path.join(HERE, "..", "src")
WORLD = 4
PAIRS = 2
KINDS = ("all-to-all", "all-gather", "reduce-scatter", "all-reduce",
         "collective-permute")
# (data, SP) ranks of each mesh; hybrid's SP is (sp_out 2) x (sp_in 2)
GRID = {"1x4": (1, 4), "2x2": (2, 2), "sp2x2": (1, 4)}
OUTER = {"sp2x2": 2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the 4 gloo ranks and the JAX subprocess once, side by side."""
    work = str(tmp_path_factory.mktemp("sp"))
    params = _perturbed_params()
    rng = np.random.RandomState(3)
    inputs = {**_inputs(),
              "ring_q": rng.standard_normal((2, 16, 4, 8)).astype(np.float32),
              "ring_k": rng.standard_normal((2, 16, 2, 8)).astype(np.float32),
              "ring_v": rng.standard_normal((2, 16, 2, 8)).astype(np.float32)}
    np.savez(os.path.join(work, "params.npz"), **_flatten(params))
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    cmds = {"jax": [sys.executable, os.path.join(HERE, "_torch_sp_jax.py"),
                    work]}
    for r in range(WORLD):
        cmds[f"rank{r}"] = [sys.executable,
                            os.path.join(HERE, "_torch_sp_worker.py"),
                            str(r), str(WORLD), work]
    procs, logs = {}, {}
    try:
        for name, cmd in cmds.items():
            logs[name] = open(os.path.join(work, f"{name}.log"), "w+")
            procs[name] = subprocess.Popen(cmd, env=env, stdout=logs[name],
                                           stderr=subprocess.STDOUT)
        for name, p in procs.items():
            p.wait(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        logs[name].seek(0)
        text = logs[name].read()
        logs[name].close()
        assert p.returncode == 0, f"{name} failed:\n{text[-4000:]}"
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(WORLD)]
    return {"ranks": ranks, "jax": dict(np.load(os.path.join(work,
                                                              "jax.npz"))),
            "inputs": inputs}


def _counts(rank, key):
    """{kind: (calls, bytes)} of the kinds a rank issued."""
    calls, nbytes = rank[f"{key}/calls"], rank[f"{key}/bytes"]
    return {k: (int(c), int(b)) for k, c, b in zip(KINDS, calls, nbytes)
            if c or b}


def _stream_bytes(mesh):
    """M, the residual stream of one data-parallel group (f32), and kv, the
    K + V activations of one attention (2M: MHA, H * dh = d)."""
    dp = GRID[mesh][0]
    m = 2 // dp * 8 * 16 * 64 * 4
    return m, 2 * m


def contract(mode, overlap, n, outer, m, kv, pairs=PAIRS):
    """Per-rank {kind: (calls, bytes)} of one forward and of its backward
    (each collective's transpose: a switch's a switch, a gather's a
    reduce-scatter and back, a permute's the inverse permute).  The
    forward's rows are the contract table of PERF.md; a ring's last hop
    carries blocks nothing reads, so its backward has n - 1 hops a
    stream."""
    p = pairs
    a2a, perm = "all-to-all", "collective-permute"
    if mode == "dsp" and overlap is not None:
        fwd = {perm: (2 * (n - 1) * p, 2 * m // n * (n - 1) // n * p)}
        return fwd, fwd
    if mode == "dsp":
        fwd = {a2a: (2 * p, 2 * m // n * p)}
        return fwd, fwd
    if mode in ("ulysses", "ulysses_fused"):
        k = 4 if mode == "ulysses" else 2
        fwd = {a2a: (k * p, (2 * m + kv) // n * p)}
        return fwd, fwd
    if mode == "ring":
        return ({perm: (2 * n * p, kv * p)},
                {perm: (2 * (n - 1) * p, kv * (n - 1) // n * p)})
    if mode == "megatron":
        fwd = {"all-gather": (4 * p, 4 * m * p),
               "reduce-scatter": (4 * p, 4 * m * p)}
        return fwd, fwd
    assert mode == "hybrid"
    ulysses = (4 * p, (2 * m + kv) // n * p)
    return ({a2a: ulysses, perm: (2 * outer * p, kv * outer // n * p)},
            {a2a: ulysses, perm: (2 * (outer - 1) * p,
                                  kv * (outer - 1) // n * p)})


def _sum(*counts):
    out = {}
    for c in counts:
        for k, (calls, nbytes) in c.items():
            a, b = out.get(k, (0, 0))
            out[k] = (a + calls, b + nbytes)
    return out


def _assemble(ranks, name, mesh):
    dp, sp = GRID[mesh]
    rows = [[None] * sp for _ in range(dp)]
    for rank in ranks:
        d, s = rank[f"{name}/coord"].tolist()
        rows[d][s] = rank[f"{name}/out"]
    return np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)


# ---------------------------------------------------------------------------
# Every mode against JAX's make_spmd_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_output_matches_jax(runs, name):
    """The ranks' shards, gathered, equal JAX's global output within 1e-5
    of its largest |value|."""
    got = _assemble(runs["ranks"], name, SCENARIOS[name][2])
    want = runs["jax"][f"{name}/out"]
    assert got.shape == want.shape == (2, 8, 16, 16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_grads_match_jax(runs, name):
    """The sum of the output's squares: each rank's loss, summed over the
    world, within 1e-5 relative of JAX's; every gradient leaf, summed over
    the world, within 1e-4 of its max against ``jax.grad``."""
    jx = runs["jax"]
    want_loss = float(np.sum(jx[f"{name}/out"].astype(np.float64) ** 2))
    prefix = f"{name}/grad/"
    paths = [k[len(prefix):] for k in jx if k.startswith(prefix)]
    assert len(paths) == len(_flatten(_perturbed_params()))
    for rank in runs["ranks"]:
        loss = float(rank[f"{name}/loss"])
        assert abs(loss - want_loss) <= 1e-5 * want_loss, (loss, want_loss)
        for path in paths:
            g, w = rank[prefix + path], jx[prefix + path]
            assert g.shape == w.shape, path
            gap = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
            assert gap <= 1e-4, (path, gap)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_collectives_and_bytes_match_the_contract(runs, name):
    """Per rank, exactly: the forward's collectives and bytes as
    ``contract`` gives them, and the forward plus the backward's when the
    loss is differentiated."""
    mode, overlap, mesh = SCENARIOS[name]
    m, kv = _stream_bytes(mesh)
    fwd, bwd = contract(mode, overlap, GRID[mesh][1], OUTER.get(mesh, 1),
                        m, kv)
    for rank in runs["ranks"]:
        assert _counts(rank, f"{name}/fwd") == fwd
        assert _counts(rank, f"{name}/grad") == _sum(fwd, bwd)


@pytest.mark.parametrize("name", ["dsp", "ulysses", "ulysses_fused", "ring",
                                  "megatron", "megatron2x2", "hybrid"])
def test_bytes_over_analytic_is_one(runs, name):
    """A forward's bytes per rank over ``per_device_bytes`` for each stage
    the mode wraps (a layer pair for dsp, ulysses, ring and hybrid; each of
    its two blocks for megatron): 1.00."""
    mode, _, mesh = SCENARIOS[name]
    n, outer = GRID[mesh][1], OUTER.get(mesh, 1)
    m, kv = _stream_bytes(mesh)
    strategy = "ulysses" if mode == "ulysses_fused" else mode
    stages = 2 * PAIRS if mode == "megatron" else PAIRS
    want = stages * dsp.per_device_bytes(strategy, m, n, kv_bytes=kv,
                                         outer=outer)
    got = sum(b for _, b in _counts(runs["ranks"][0],
                                    f"{name}/fwd").values())
    assert f"{got / want:.2f}" == "1.00", (got, want)


@pytest.mark.parametrize("name", ["chunked", "double_buffer"])
def test_overlap_moves_n_minus_1_over_n_of_dsp(runs, name):
    """The overlapped switch keeps hop 0 local: a forward moves (n - 1)/n
    of DSP's bytes per rank."""
    dsp_bytes, got = (sum(b for _, b in _counts(runs["ranks"][0],
                                                f"{k}/fwd").values())
                      for k in ("dsp", name))
    assert got * WORLD == dsp_bytes * (WORLD - 1)


def test_table3_order(runs):
    """Per-rank bytes of one forward on the same workload (paper Table 3,
    ``tests/md_scenarios.py``): dsp < ulysses < megatron and dsp < ring."""
    vol = {name: sum(b for _, b in _counts(runs["ranks"][0],
                                           f"{name}/fwd").values())
           for name in ("dsp", "ulysses", "megatron", "ring")}
    assert vol["dsp"] < vol["ulysses"] < vol["megatron"], vol
    assert vol["dsp"] < vol["ring"], vol


# ---------------------------------------------------------------------------
# The overlapped switch and the ring over 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["chunked", "double_buffer"])
@pytest.mark.parametrize("hook", ["plain", "consume"])
def test_overlapped_switch_equals_dynamic_switch(runs, mode, hook):
    """On the (1, 4) model group, ``overlapped_switch(1 -> 2)`` equals
    ``dynamic_switch`` bit for bit, and so does its backward; with
    ``consume``, each source shard is consumed with its hop index.  3
    permutes forward, 3 backward, no all-to-all."""
    name = f"ovl/{mode}/{hook}"
    for rank in runs["ranks"]:
        assert bool(rank[f"{name}/equal"])
        assert bool(rank[f"{name}/grad_equal"])
        shard = 2 * 2 * 2 * 3 * 4          # one (2, 2, 2, 3) f32 chunk
        assert _counts(rank, name) == {"collective-permute": (6, 6 * shard)}


def test_ring_attention_causal_gqa_over_four_ranks(runs):
    """A causal ring over 4 ranks with 4 query and 2 K/V heads: the later
    ranks' blocks are fully masked for the earlier ranks' rows (the guard),
    and each rank's shard equals ``attention_ref`` of the whole sequence
    within 1e-5 of its largest |value|."""
    for rank in runs["ranks"]:
        got, want = rank["ringc/out"], rank["ringc/ref"]
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# One process: a world of one, the guards, the estimates
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process, on a FileStore."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield dist.new_group([0])
        finally:
            dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["chunked", "double_buffer"])
def test_overlapped_switch_at_one_rank(world_of_one, mode):
    """At one rank the overlapped switch issues nothing and equals the
    switch bit for bit (the tensor itself, or ``consume`` of it as hop 0),
    while ``dynamic_switch`` is still one all-to-all."""
    x = torch.randn(2, 3, 4, 5)
    dsp.reset_calls()
    want = dsp.dynamic_switch(x, 1, 2, world_of_one)
    assert dsp.calls == {"all-to-all": 1}
    dsp.reset_calls()
    assert torch.equal(overlapped_switch(x, 1, 2, world_of_one, mode=mode),
                       want)
    got = overlapped_switch(x, 1, 2, world_of_one, mode=mode,
                            consume=lambda s, t: s * 3.0 + t)
    assert torch.equal(got, want * 3.0)
    assert dsp.calls == {} and dsp.volume == {}
    with pytest.raises(ValueError, match="mode"):
        overlapped_switch(x, 1, 2, world_of_one, mode="eager")
    assert OVERLAP_MODES == (None, "chunked", "double_buffer")


@pytest.mark.parametrize("causal,hkv", [(False, 4), (True, 4), (True, 2),
                                        (False, 1)])
def test_ring_attention_at_one_rank(world_of_one, causal, hkv):
    """A ring of one: one hop of K and V each (2 permutes of their bytes),
    the output within 1e-5 of ``attention_ref``'s largest |value|."""
    g = torch.Generator().manual_seed(hkv)
    q = torch.randn(2, 12, 4, 8, generator=g)
    k, v = (torch.randn(2, 12, hkv, 8, generator=g) for _ in range(2))
    dsp.reset_calls()
    got = ring_attention(q, k, v, world_of_one, causal=causal)
    assert dsp.calls == {"collective-permute": 2}
    assert dsp.volume == {"collective-permute": 2 * k.numel() * 4}
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal).transpose(1, 2)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_block_attention_guards_fully_masked_rows():
    """A causal block whose keys all lie after the queries: every row is
    dead, with max 0, weight 0 and output 0 (no NaN)."""
    q, k = torch.randn(1, 3, 2, 4), torch.randn(1, 5, 2, 4)
    o, m, l, dead = _block_attn(q, k, k, torch.arange(3),
                                10 + torch.arange(5), 0.5, True)
    assert bool(dead.all())
    assert not (o.any() or m.any() or l.any())


def test_stage_flops_match_jax_and_price_on_the_h100():
    """``stage_flops`` of every DiT stage equals JAX's; the seconds divide
    them over the SP degree at the H100's bf16 peak (989e12, the data
    sheet), not the TPU's."""
    import jax.numpy as jnp
    kw = dict(t_len=16, s_len=4096, batch=1)
    jcfg = JT.T2DConfig(name="t", n_layers=4, d_model=1152, n_heads=16,
                        d_ff=4608, in_dim=64, dtype=jnp.bfloat16)
    tcfg = TT.T2DConfig(name="t", n_layers=4, d_model=1152, n_heads=16,
                        d_ff=4608, in_dim=64, dtype=torch.bfloat16)
    for js, ts in zip(JT.stages(jcfg, **kw), TT.stages(tcfg, **kw)):
        f = JR.stage_flops(js, jcfg)
        assert f > 0 and TR.stage_flops(ts, tcfg) == f
        assert TR.stage_compute_seconds(ts, tcfg, 4) == f / 4 / 989e12
    assert TR.PEAK_FLOPS == 989e12
    # a stage without a shape has no estimate: its switch stays exposed
    bare = TT.stages(tcfg)[0]
    assert TR.stage_flops(bare, tcfg) == 0.0
    attached = TR.attach_compute_seconds(TT.stages(tcfg, **kw), tcfg, 4)
    assert all(st.compute_seconds > 0 for st in attached)


@pytest.mark.parametrize("overlap", ["chunked", "double_buffer"])
def test_overlap_schedules_match_jax(overlap):
    """``dsp_schedule(overlap=...)`` and ``strategy_schedule`` give JAX's
    plans: the same dims, the mode stamped on the schedule, the same
    boundaries run overlapped."""
    import jax.numpy as jnp
    kw = dict(t_len=8, s_len=16, batch=2, overlap=overlap)
    jcfg = JT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                        d_ff=128, in_dim=16, dtype=jnp.float32)
    tcfg = TT.T2DConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                        d_ff=128, in_dim=16, dtype=torch.float32)
    for fn in ("dsp_schedule", "strategy_schedule"):
        want = getattr(JT, fn)(jcfg, 4, **kw).schedule
        got = getattr(TT, fn)(tcfg, 4, **kw).schedule
        assert got.dims == want.dims and got.overlap == want.overlap
        assert got.strategies == want.strategies
        assert ([got.overlap_mode(t) for t in range(len(got.dims))]
                == [want.overlap_mode(t) for t in range(len(want.dims))])
        assert any(got.overlap_mode(t) for t in range(len(got.dims)))


def test_volume_helpers_route_through_per_device_bytes():
    """``stream_bytes``, ``attention_bytes`` and ``block_bytes`` are Table
    3's constants; ``block_seconds`` prices an all-gather and a
    reduce-scatter of M on the topology."""
    m = 1000.0
    assert stream_bytes(m, 4) == 2 * m
    assert attention_bytes(m, 4) == m
    assert megatron_sp.block_bytes(m, 4) == 4 * m
    topo = Topology.uniform(4, bandwidth=1e9, latency=1e-6)
    assert megatron_sp.block_seconds(topo, m) == (
        topo.all_gather_seconds(m) + topo.reduce_scatter_seconds(m)) > 0


def test_ppermute_moves_every_rank_and_inverts_backward(world_of_one):
    """A permute of the whole group (at one rank, to itself) is one
    collective-permute of x's bytes each way; a perm that leaves a rank
    out raises before any call."""
    x = torch.randn(3, 4, requires_grad=True)
    dsp.reset_calls()
    y = dsp.ppermute(x, [(0, 0)], world_of_one)
    (y * 2.0).sum().backward()
    assert torch.equal(y, x) and torch.equal(x.grad, torch.full_like(x, 2.0))
    assert dsp.calls == {"collective-permute": 2}
    assert dsp.volume == {"collective-permute": 2 * x.numel() * 4}
    with pytest.raises(ValueError, match="not a permutation"):
        dsp.ppermute(x, [], world_of_one)
