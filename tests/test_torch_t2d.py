"""The port's 2D video DiT (``repro_torch.models.transformer2d``) against
the JAX package's on the CPU, at SMOKE size in float32: the layer helpers,
the positional embedding, flash attention at the DiT's head dim 72
(non-causal) and its gradients, one block along each axis, ``forward``,
``t2d_loss`` and every gradient leaf at ``mesh=None``, the parameter tree
and count, the kernel's launch count under checkpointing, the video
batches and the train CLI.

JAX runs the model with ``backend="ref"`` and K1 as its Pallas kernel in
interpret mode; the port's wrapper takes its plain version on CPU
tensors.  adaLN-zero initialises every block's modulation at 0, which
makes each block the identity and every attention and MLP gradient 0, so
each check first draws ``mod/proj`` from seeded normals, in numpy, for
both packages.  Tolerances: 1e-6 for the layer helpers (the same f32
arithmetic), 1e-5 for attention (sums in another order), loss 1e-5 and
each grad leaf 1e-4 of its max for the model."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import transformer2d_3b as jc3b
from repro.configs import transformer2d_720m as jc720
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import transformer2d as JT
from repro_torch import bridge, configs
from repro_torch.configs import transformer2d_3b as tc3b
from repro_torch.configs import transformer2d_720m as tc720
from repro_torch.data.pipeline import DataConfig, batch_for_arch, make_batch
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models import transformer2d as TT
from _torch_threads import one_thread  # noqa: E402,F401

CONFIGS = {"720m": (jc720, tc720), "3b": (jc3b, tc3b)}
LOSS_REL, LEAF_REL = 1e-5, 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _pairs(ttree, jtree, path=""):
    if isinstance(ttree, dict):
        assert set(ttree) == set(jtree), path
        for k in ttree:
            yield from _pairs(ttree[k], jtree[k], f"{path}/{k}")
    else:
        yield path, ttree, jtree


def _perturbed(cfg, seed=0):
    """JAX's init as numpy, every block's modulation drawn from normals."""
    tree = jax.tree_util.tree_map(
        np.asarray, JT.init_t2d(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(100 + seed)
    for kind in ("spatial", "temporal"):
        proj = tree["layers"][kind]["mod"]["proj"]
        d = proj["w"].shape[-2]
        proj["w"] = (rng.standard_normal(proj["w"].shape)
                     * 0.5 / np.sqrt(d)).astype(np.float32)
        proj["b"] = (rng.standard_normal(proj["b"].shape)
                     * 0.1).astype(np.float32)
    return tree


def _video(cfg, shape=(2, 4, 8), seed=1):
    rng = np.random.RandomState(seed)
    b, t, s = shape
    return {"x": rng.standard_normal((b, t, s, cfg.in_dim)).astype(np.float32),
            "t": rng.rand(b).astype(np.float32),
            "target": rng.standard_normal(
                (b, t, s, cfg.in_dim)).astype(np.float32)}


def _cross(tree):
    return bridge.params_from_numpy(tree, device="cpu")


# ---------------------------------------------------------------------------
# Layer helpers and the positional embedding
# ---------------------------------------------------------------------------

def test_patch_embed_matches_jax():
    rng = np.random.RandomState(0)
    p = {"proj": {"w": rng.standard_normal((16, 64)).astype(np.float32),
                  "b": rng.standard_normal((64,)).astype(np.float32)}}
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    want = JL.patch_embed(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x))
    got = TL.patch_embed(_cross(p), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    init = TL.init_patch_embed(torch.Generator().manual_seed(0), 16, 64)
    assert {k: tuple(v.shape) for k, v in init["proj"].items()} == \
        {"w": (16, 64), "b": (64,)}


def test_modulation_matches_jax():
    """Six (B, 1, C) chunks of silu(t_emb) @ w + b; the init is 0."""
    rng = np.random.RandomState(1)
    d = 32
    p = {"proj": {"w": rng.standard_normal((d, 6 * d)).astype(np.float32),
                  "b": rng.standard_normal((6 * d,)).astype(np.float32)}}
    t_emb = rng.standard_normal((3, d)).astype(np.float32)
    want = JL.modulation(jax.tree_util.tree_map(jnp.asarray, p),
                         jnp.asarray(t_emb))
    got = TL.modulation(_cross(p), torch.from_numpy(t_emb))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (3, 1, d)
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)
    init = TL.init_modulation(torch.Generator().manual_seed(0), d)
    assert tuple(init["proj"]["w"].shape) == (d, 6 * d)
    assert not init["proj"]["w"].any() and not init["proj"]["b"].any()


def test_timestep_embedding_matches_jax():
    """cos then sin (``_sincos`` is sin then cos)."""
    t = np.array([0.0, 0.25, 0.9, 37.0], np.float32)
    want = JL.timestep_embedding(jnp.asarray(t), 64)
    got = TL.timestep_embedding(torch.from_numpy(t), 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(got)[:, 0], np.cos(t), rtol=1e-6)
    np.testing.assert_allclose(_np(got)[:, 32], np.sin(t), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("t_off,s_off", [(0, 0), (3, 17)])
def test_add_pos_embed_matches_jax(t_off, s_off):
    cfg_j, cfg_t = jc720.SMOKE, tc720.SMOKE
    x = np.random.RandomState(2).standard_normal(
        (2, 5, 7, cfg_j.d_model)).astype(np.float32)
    want = JT.add_pos_embed(jnp.asarray(x), cfg_j, t_off, s_off)
    got = TT.add_pos_embed(torch.from_numpy(x), cfg_t, t_off, s_off)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    pe = _np(TT._sincos(torch.arange(3), 8))
    np.testing.assert_allclose(pe[:, 0], np.sin(np.arange(3)), rtol=1e-6)
    np.testing.assert_allclose(pe[:, 4], np.cos(np.arange(3)), rtol=1e-6)


# ---------------------------------------------------------------------------
# K1 at the DiT's head dim, non-causal
# ---------------------------------------------------------------------------

D72_CASES = [(2, 4, 100, 72), (1, 2, 256, 72)]


def _qkv(case, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(case).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", D72_CASES)
def test_flash_attention_plain_at_d72_matches_pallas(case):
    arrays = _qkv(case, 3)
    want = jops.flash_attention(*map(jnp.asarray, arrays), causal=False)
    got = flash_attention_plain(*map(torch.from_numpy, arrays), causal=False)
    got_op = tops.flash_attention(*map(torch.from_numpy, arrays))
    assert torch.equal(got, got_op)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", D72_CASES)
def test_flash_attention_grads_at_d72_match_jax(case):
    arrays = _qkv(case, 4)
    cot = np.random.RandomState(5).standard_normal(case).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jops.flash_attention(*a) * cot),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    tin = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad(tops.flash_attention(*tin), tin,
                              torch.from_numpy(cot))
    for name, g, w in zip("qkv", got, want):
        assert _rel(g, w) < 1e-5, name


# ---------------------------------------------------------------------------
# Blocks, forward, loss and grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [1, 2])
def test_t2d_block_matches_jax(axis):
    cfg_j, cfg_t = jc720.SMOKE, tc720.SMOKE
    tree = _perturbed(cfg_j)
    block = jax.tree_util.tree_map(lambda a: a[0], tree["layers"]["spatial"])
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 3, 5, cfg_j.d_model)).astype(np.float32)
    t_emb = rng.standard_normal((2, cfg_j.d_model)).astype(np.float32)
    want = JT.t2d_block(jax.tree_util.tree_map(jnp.asarray, block),
                        jnp.asarray(x), cfg_j, axis=axis,
                        t_emb=jnp.asarray(t_emb), backend="ref")
    got = TT.t2d_block(_cross(block), torch.from_numpy(x), cfg_t, axis=axis,
                       t_emb=torch.from_numpy(t_emb))
    assert _rel(got, want) < 1e-5
    # the perturbed modulation makes the block no identity
    assert _rel(got, x) > 1e-2


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_forward_matches_jax(arch):
    jconf, tconf = CONFIGS[arch]
    tree = _perturbed(jconf.SMOKE)
    b = _video(jconf.SMOKE)
    want = JT.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(b["x"]), jnp.asarray(b["t"]), jconf.SMOKE,
                      backend="ref")
    with torch.no_grad():
        got = TT.forward(_cross(tree), torch.from_numpy(b["x"]),
                         torch.from_numpy(b["t"]), tconf.SMOKE)
    assert tuple(got.shape) == want.shape == b["x"].shape
    assert _rel(got, want) < LOSS_REL


# (remat, remat_group, blocks): off; every pair checkpointed; groups of 2
# pairs, which need an even pair count
REMAT_CASES = [(False, 2, 2), (True, 1, 2), (True, 2, 4)]


@pytest.mark.parametrize("remat,group,blocks", REMAT_CASES,
                         ids=["no_remat", "group1", "group2"])
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_t2d_loss_and_grads_match_jax(arch, remat, group, blocks):
    jconf, tconf = CONFIGS[arch]
    cfg_j = dataclasses.replace(jconf.SMOKE, n_layers=blocks)
    cfg_t = dataclasses.replace(tconf.SMOKE, n_layers=blocks)
    tree = _perturbed(cfg_j, seed=blocks)
    b = _video(cfg_j, seed=7)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.t2d_loss(p, jb, cfg_j, backend="ref", remat=remat,
                              remat_group=group)[0]))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    tp = TLM.tree_map(lambda a: a.requires_grad_(True), _cross(tree))
    loss, aux = TT.t2d_loss(tp, {k: torch.from_numpy(v) for k, v in b.items()},
                            cfg_t, remat=remat, remat_group=group)
    assert aux == {}
    loss.backward()
    assert abs(loss.item() - float(jloss)) / abs(float(jloss)) < LOSS_REL
    n = 0
    for path, t, j in _pairs(tp, jgrads):
        assert _rel(t.grad, j) < LEAF_REL, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jgrads))
    attn = tp["layers"]["temporal"]["wq"]["w"].grad
    assert float(attn.abs().max()) > 0


@pytest.mark.parametrize("remat,group,blocks,launches", [
    (False, 2, 4, 4), (True, 2, 4, 8), (True, 1, 6, 12), (True, 2, 6, 12)])
def test_checkpointed_step_launches_the_kernel_twice_a_block(
        monkeypatch, remat, group, blocks, launches):
    """With a counting stand-in for the kernel on CPU tensors, a loss and
    backward launches it once per block in the forward and, when
    checkpointed, once more per block in the recompute (chip_smoke's
    2 x blocks x steps); the backward through ``attention_ref`` launches
    it never.  6 blocks (3 pairs) at group 2 fall back to groups of 1."""
    calls = []

    def stand_in(q, k, v, **kw):
        calls.append(q.shape[-1])
        return flash_attention_plain(q, k, v, **kw)

    monkeypatch.setattr(tops, "_use_plain", lambda t, backend: False)
    monkeypatch.setattr(tops, "flash_attention_fwd", stand_in)
    cfg = dataclasses.replace(tc720.SMOKE, n_layers=blocks)
    tp = TLM.tree_map(lambda a: a.requires_grad_(True),
                      TT.init_t2d(0, cfg, device="cpu"))
    batch = make_batch(DataConfig(task="video", batch=2, temporal=3,
                                  spatial=5, in_dim=cfg.in_dim), 0,
                       device="cpu")
    loss, _ = TT.t2d_loss(tp, batch, cfg, remat=remat, remat_group=group)
    assert len(calls) == blocks
    loss.backward()
    assert len(calls) == launches
    assert set(calls) == {cfg.dh}


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_config_tree_and_count_match_jax(arch):
    jconf, tconf = CONFIGS[arch]
    for name in ("CONFIG", "SMOKE"):
        j, t = getattr(jconf, name), getattr(tconf, name)
        for f in ("name", "n_layers", "d_model", "n_heads", "d_ff", "in_dim",
                  "head_dim", "mlp_kind", "modulate", "n_kv_heads"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert (j.dh, j.kvh) == (t.dh, t.kvh)
        assert jnp.dtype(j.dtype).name == str(t.dtype).split(".")[-1]
        assert TT.t2d_param_count(t) == JT.t2d_param_count(j)
    for cfg_j, cfg_t in ((jconf.SMOKE, tconf.SMOKE),
                         (dataclasses.replace(jconf.SMOKE, n_layers=4,
                                              dtype=jnp.bfloat16),
                          dataclasses.replace(tconf.SMOKE, n_layers=4,
                                              dtype=torch.bfloat16))):
        want = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), a.dtype.name),
            jax.eval_shape(lambda: JT.init_t2d(jax.random.PRNGKey(0),
                                               cfg_j)))
        tp = TT.init_t2d(0, cfg_t, device="cpu")
        assert TLM.tree_map(lambda a: (tuple(a.shape), str(a.dtype)[6:]),
                            tp) == want
        assert not tp["layers"]["spatial"]["mod"]["proj"]["w"].any()
    spec = configs.get(f"transformer2d-{arch}")
    assert spec.config is tconf.CONFIG and spec.family == "t2d"
    assert spec.source == "paper Table 4 (OpenSora variant)"
    assert spec.shapes() == jbase.T2D_SHAPES
    assert configs.SHAPES == jbase.SHAPES
    assert set(configs.get("qwen3-14b").shapes()) <= set(jbase.SHAPES)
    assert TT.t2d_param_count(tc720.CONFIG) == 670_334_976


@pytest.mark.parametrize("kw", [
    dict(mesh=object()), dict(mode="ulysses"), dict(topology=object()),
    dict(joint=True), dict(schedule=object()), dict(overlap="ring")])
def test_forward_raises_for_the_mesh_path(kw):
    """A mesh that is not one raises; without a mesh, a mode other than
    dsp or an overlap raises (they share the work over ranks), and the
    plan's arguments act on nothing, as in JAX (``tests/test_torch_dsp.py``
    and ``tests/test_torch_sp_baselines.py`` run the mesh path)."""
    cfg = tc720.SMOKE
    params = TT.init_t2d(0, cfg, device="cpu")
    x = torch.randn((1, 2, 3, cfg.in_dim), generator=torch.Generator()
                    .manual_seed(0))
    if "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            TT.forward(params, x, None, cfg, **kw)
    elif "mode" in kw or "overlap" in kw:
        with pytest.raises(ValueError, match="pass mesh="):
            TT.forward(params, x, None, cfg, **kw)
    else:
        torch.testing.assert_close(TT.forward(params, x, None, cfg, **kw),
                                   TT.forward(params, x, None, cfg),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Data, the train CLI, the device rule
# ---------------------------------------------------------------------------

def test_video_batches():
    """Shapes and ranges as JAX's video task (the bits are torch's), the
    same batch for the same step, and batch_for_arch at a T2D shape."""
    cfg = DataConfig(task="video", batch=3, temporal=4, spatial=6, in_dim=5)
    b0, again, b1 = (make_batch(cfg, s, device="cpu") for s in (0, 0, 1))
    jb = jmake_batch(JDataConfig(task="video", batch=3, temporal=4,
                                 spatial=6, in_dim=5), 0)
    assert set(b0) == set(jb) == {"x", "t", "target"}
    for k in b0:
        assert tuple(b0[k].shape) == jb[k].shape
        assert b0[k].dtype == torch.float32
        assert torch.equal(b0[k], again[k])
        assert not torch.equal(b0[k], b1[k])
    assert 0 <= float(b0["t"].min()) and float(b0["t"].max()) < 1
    spec = configs.get("transformer2d-720m")
    b = batch_for_arch(spec, "video_0.5m", batch_override=1, device="cpu")
    assert tuple(b["x"].shape) == (1, 128, 4096, 64)
    lm = batch_for_arch(configs.get("qwen3-14b"), "train_4k",
                        batch_override=2, seq_override=16, device="cpu")
    assert tuple(lm["tokens"].shape) == (2, 16)
    cast = TT.model_dtype_batch(b0, tc720.CONFIG)
    assert cast["x"].dtype == cast["target"].dtype == torch.bfloat16
    assert cast["t"] is b0["t"]


@pytest.mark.parametrize("arch,accum", [("transformer2d-720m", 1),
                                        ("transformer2d-3b", 2)])
def test_train_cli_trains_the_dit_on_cpu(arch, accum):
    from repro_torch.launch.train import main
    out = main(["--arch", arch, "--steps", "20", "--batch", "4",
                "--seq", "64", "--grad-accum", str(accum),
                "--device", "cpu"])
    hist = out["history"]
    assert out["final_step"] == 20 and len(hist) == 10
    assert all(np.isfinite(l) for _, l in hist)
    assert hist[-1][1] < hist[0][1]


def test_dit_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_t2d(0, tc720.SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(DataConfig(task="video"), 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "transformer2d-720m"])
    assert TT.init_t2d(0, tc720.SMOKE, device="cpu")["embed"]["proj"][
        "w"].device.type == "cpu"


# ---------------------------------------------------------------------------
# chip_smoke's DiT helpers
# ---------------------------------------------------------------------------

def test_chip_smoke_perturbs_every_blocks_modulation():
    import chip_smoke
    cfg = dataclasses.replace(tc720.SMOKE, n_layers=4)
    params = chip_smoke.perturb_modulation(TT.init_t2d(0, cfg, device="cpu"),
                                           5)
    for kind in ("spatial", "temporal"):
        proj = params["layers"][kind]["mod"]["proj"]
        assert all(bool(w.any()) for w in proj["w"])
        assert all(bool(b.any()) for b in proj["b"])
    assert not torch.equal(params["layers"]["spatial"]["mod"]["proj"]["w"],
                           params["layers"]["temporal"]["mod"]["proj"]["w"])


@pytest.mark.parametrize("fault,passes", [(None, True), ("drop_key", False)])
def test_chip_smoke_dit_grads_bar_discriminates(monkeypatch, fault, passes):
    """chip_smoke's depth-2 bars on the DiT at SMOKE width, with a plain
    stand-in for the kernel: the stand-in passes bit for bit; one that
    drops the last key of every sequence fails the loss and grad bars.
    The kernel branch hands its kernel contiguous copies of q, k and v
    (``kernels/ops.py``), the plain branch strided views, and the CPU's
    matmuls need not round those two layouts alike (7.689e-07 of a grad
    leaf apart): the plain branch gets the same copies here, so the two
    paths differ only by the stand-in."""
    import chip_smoke

    def stand_in(q, k, v, **kw):
        if fault:
            k, v = k[:, :, :-1], v[:, :, :-1]
        return flash_attention_plain(q, k, v, **kw)

    def plain(q, k, v, **kw):
        return flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous(), **kw)

    monkeypatch.setattr(tops, "_use_plain",
                        lambda t, backend: backend == "ref")
    monkeypatch.setattr(tops, "flash_attention_fwd", stand_in)
    monkeypatch.setattr(tops, "flash_attention_plain", plain)
    cfg = dataclasses.replace(tc720.SMOKE, n_layers=2)
    params = chip_smoke.perturb_modulation(TT.init_t2d(0, cfg, device="cpu"),
                                           5)
    batch = make_batch(DataConfig(task="video", batch=1, temporal=4,
                                  spatial=8, in_dim=cfg.in_dim), 0,
                       device="cpu")
    gap = chip_smoke.loss_grads_gap(params, batch, cfg,
                                    loss_fn=TT.t2d_loss)
    assert gap["leaves"] == len(TLM.tree_leaves(params))
    if passes:
        assert gap["loss_rel"] == 0 and gap["grad_rel"] == 0, gap
    else:
        assert gap["loss_rel"] > chip_smoke.LOSS_BAR, gap
        assert gap["grad_rel"] > chip_smoke.GRAD_BAR, gap
