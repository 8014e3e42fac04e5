"""The port's plan-aware checkpoints (``train.checkpoint``) on the CPU:
JAX's ``tests/test_checkpoint.py`` cases against the port's manager, and
checkpoints crossing between the packages.

1. Round trips: seeded random trees (f32, int32, int8, bf16) restore bit
   for bit, also after their shards are hand-split along a random dim
   (the on-disk shape another layout would have written); bf16 NaN
   payloads and the full int8 range never pass through a float cast;
   missing leaves, shape mismatches and lost coverage raise; the
   manifest records the plan, the topology and ``meta``; ``restore(ctx=,
   specs=)`` cuts each rank's slice (world of one here; 4 ranks in
   ``tests/test_torch_elastic.py``).
2. Crashes: a writer killed between its shard writes and the publish, an
   ``os.replace`` that raises, a late async failure, two managers on one
   directory, and the order of snapshot and wait.
3. Across the packages: a SMOKE LM tree (f32 params, AdamW's moments and
   master copy, the 0-d int32 step) and a SMOKE DiT in bf16 written by
   JAX's ``CheckpointManager`` restore in the port equal to
   ``bridge.params_from_numpy``; the port's restore in JAX's, bit for bit.
4. ``tools/inspect_ckpt.py --json`` reads a port-written checkpoint.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.train.checkpoint as JC
import repro_torch.train.checkpoint as C
from repro.models import lm as JLM
from repro.models import transformer2d as JT2D
from repro.optim import adamw as JO
from repro_torch import bridge
from repro_torch.configs import qwen3_14b, transformer2d_720m
from repro_torch.core.layout import from_mesh
from repro_torch.core.plan import JointPlan, StrategyPlan, plan_from_dict
from repro_torch.core.topology import Topology
from repro_torch.models import lm as TL
from repro_torch.parallel.partition import (ParallelPlan, mesh_sizes,
                                            param_pspecs)
from repro_torch.train.checkpoint import CheckpointManager

from _torch_dsp_jax import flatten  # noqa: E402
from _torch_world import world_of_one  # noqa: E402,F401
from _torch_threads import one_thread  # noqa: E402,F401

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")

DTYPES = (torch.float32, torch.int32, torch.int8, torch.bfloat16)


def _rand(rng, shape, dtype):
    if not dtype.is_floating_point:
        lo, hi = (-100, 100) if dtype != torch.int8 else (-128, 127)
        return torch.from_numpy(rng.integers(lo, hi, size=shape)).to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _bits(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().tobytes()


def _bit_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert sorted(fa) == sorted(fb)
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, int):
            assert x == y and isinstance(y, int), k
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert _bits(x) == _bits(y), k


def _template(tree):
    """Meta tensors of the tree's shapes and dtypes."""
    return {k: _template(v) if isinstance(v, dict) else
            torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def _hand_split(ckpt_dir, step, rng):
    """Rewrite a saved step's single-shard leaves as two shards split
    unevenly along a random dim; restore must merge them back."""
    base = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(base, "manifest.json")) as f:
        man = json.load(f)
    for rec in man["leaves"]:
        shape = tuple(rec["shape"])
        dims = [i for i, d in enumerate(shape) if d >= 2]
        if not dims or len(rec["shards"]) != 1:
            continue
        dim = dims[rng.integers(0, len(dims))]
        cut = int(rng.integers(1, shape[dim]))
        src = rec["shards"][0]
        arr = np.load(os.path.join(base, src["file"]), allow_pickle=False)
        shards = []
        for j, (piece, (lo, hi)) in enumerate(zip(
                np.split(arr, [cut], axis=dim), [(0, cut), (cut, shape[dim])])):
            fname = src["file"].replace(".npy", f".split{j}.npy")
            np.save(os.path.join(base, fname), piece, allow_pickle=False)
            index = [list(ix) for ix in src["index"]]
            index[dim] = [lo, hi]
            shards.append({"file": fname, "index": index})
        os.remove(os.path.join(base, src["file"]))
        rec["shards"] = shards
    with open(os.path.join(base, "manifest.json"), "w") as f:
        json.dump(man, f)


# ---------------------------------------------------------------------------
# 1. Round trips
# ---------------------------------------------------------------------------

def _roundtrip_case(tmpdir, seed):
    """A random tree restores bit for bit, directly and after its shards
    are hand-split (the merge along recorded dims)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(int(rng.integers(1, 6))):
        shape = tuple(int(rng.integers(1, 6))
                      for _ in range(int(rng.integers(0, 4))))
        tree[f"leaf{i}"] = _rand(rng, shape,
                                 DTYPES[rng.integers(0, len(DTYPES))])
    d = os.path.join(tmpdir, f"ck{seed}")
    mgr = CheckpointManager(d, async_save=False)
    mgr.save(1, tree, blocking=True)
    _, direct = mgr.restore(_template(tree), device="cpu")
    _bit_equal(tree, direct)
    _hand_split(d, 1, rng)
    _, merged = mgr.restore(_template(tree), device="cpu")
    _bit_equal(tree, merged)


@pytest.mark.parametrize("seed", range(20))
def test_roundtrip_seeded(tmp_path, seed):
    _roundtrip_case(str(tmp_path), seed)


try:
    import hypothesis.strategies as st
    from hypothesis import given, settings

    @settings(max_examples=30, deadline=None)
    @given(st.integers(0, 2**31 - 1))
    def test_roundtrip_property(tmp_path_factory, seed):
        """The seeded sweep widened by hypothesis, where it is present."""
        _roundtrip_case(str(tmp_path_factory.mktemp("hyp")), seed)
except ImportError:
    pass


def test_extreme_dtypes_never_round_through_float(tmp_path):
    """bf16 NaN payloads and subnormals and the full int8 range are
    bit-preserved; a Python int leaf is saved as a 0-d int32 and restored
    as an int."""
    funky = torch.tensor([0x7FC1, 0x0001, -0x8000, 0x3F80],
                         dtype=torch.int16).view(torch.bfloat16)
    tree = {"w": funky, "q": torch.arange(-128, 128, dtype=torch.int8),
            "step": 7}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree, blocking=True)
    _, out = mgr.restore(tree)
    _bit_equal(tree, out)
    _, man = mgr.load_manifest()
    rec = {r["key"]: r for r in man["leaves"]}
    assert rec["step"]["dtype"] == "int32" and rec["step"]["shape"] == []
    assert rec["w"]["dtype"] == "bfloat16"
    raw = np.load(os.path.join(str(tmp_path), "step_00000001",
                               rec["w"]["shards"][0]["file"]))
    assert raw.dtype == np.dtype("V2")       # as np.save stores JAX's bf16


def test_restore_errors_loudly(tmp_path):
    tree = {"a": torch.ones(4, 4), "b": torch.zeros(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, tree, blocking=True)
    with pytest.raises(ValueError, match="missing leaves"):
        mgr.restore({"a": tree["a"], "zzz": tree["b"]})
    with pytest.raises(ValueError, match="global shape"):
        mgr.restore({"a": torch.ones(4, 5)})
    # checkpoint-only keys are fine: a sub-tree restores
    _, sub = mgr.restore({"a": tree["a"]})
    _bit_equal({"a": tree["a"]}, sub)
    base = os.path.join(str(tmp_path), "step_00000001")
    with open(os.path.join(base, "manifest.json")) as f:
        man = json.load(f)
    rec = next(r for r in man["leaves"] if r["key"] == "a")
    rec["shards"][0]["index"] = [[0, 2], [0, 4]]     # claims half the rows
    with open(os.path.join(base, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError):
        mgr.restore({"a": tree["a"]})


def test_manifest_records_plan_and_topology(tmp_path):
    plan = JointPlan((1, 2, 1), (2, 2, 1))
    topo = Topology.from_profile(
        4, [(2**20, 1e-4), (2**22, 3e-4), (2**24, 1.1e-3)])
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, {"w": torch.ones(4)}, blocking=True, plan=plan,
             topology=topo, meta={"initial": 1})
    step, man = mgr.load_manifest()
    assert step == 5 and man["format"] == C.FORMAT == JC.FORMAT
    assert plan_from_dict(man["plan"]) == plan
    assert Topology.from_dict(man["topology"]) == topo
    assert man["meta"] == {"initial": 1}
    sp = StrategyPlan((1, 2), ("dsp", "ring"))
    assert plan_from_dict(sp.to_dict()) == sp
    # JAX's manager reads the port's record of the same plan
    _, jman = JC.CheckpointManager(str(tmp_path)).load_manifest()
    from repro.core.plan import plan_from_dict as jplan_from_dict
    assert tuple(jplan_from_dict(jman["plan"]).fwd) == plan.fwd


def test_restore_with_ctx_and_specs(tmp_path, world_of_one):
    """``restore(ctx=, specs=)`` cuts each rank's slice by the specs of
    the global template: at one rank, the whole leaves, on the given
    device."""
    cfg = qwen3_14b.SMOKE
    params = TL.init_lm(0, cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"params": params}, blocking=True)
    ctx = from_mesh(world_of_one)
    specs = param_pspecs(params, ParallelPlan(mode="dsp"),
                         axis_sizes=mesh_sizes(ctx))
    _, out = mgr.restore({"params": _template(params)}, ctx=ctx,
                         specs={"params": specs}, device="cpu")
    _bit_equal({"params": params}, out)


# ---------------------------------------------------------------------------
# 2. Crashes
# ---------------------------------------------------------------------------

_KILL_SCRIPT = """
import os, signal, sys
import torch
import repro_torch.train.checkpoint as C

d = sys.argv[1]
tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
m = C.CheckpointManager(d, async_save=False)
m.save(1, tree, blocking=True)

def kill_replace(a, b):            # between the shard writes and the rename
    os.kill(os.getpid(), signal.SIGKILL)
C.os.replace = kill_replace
m.save(2, tree, blocking=True)
"""


def _no_staging(d):
    return [n for n in os.listdir(d) if n.startswith("tmp.")] == []


def test_sigkill_between_write_and_rename(tmp_path):
    d = str(tmp_path / "ck")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _KILL_SCRIPT, d],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    mgr = CheckpointManager(d, async_save=False)
    assert mgr.latest() == 1
    want = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    _, tree = mgr.restore({"w": torch.empty(8, 8, device="meta")},
                          device="cpu")
    assert torch.equal(tree["w"], want)
    assert not _no_staging(d)       # the killed writer's staging dir ...
    mgr.save(3, {"w": want}, blocking=True)
    assert _no_staging(d)           # ... collected by the next save
    assert mgr.all_steps() == [1, 3]


def test_raising_replace_keeps_previous_step(tmp_path, monkeypatch):
    d = str(tmp_path)
    tree = {"w": torch.full((4,), 7.0)}
    mgr = CheckpointManager(d, async_save=False)
    mgr.save(1, tree, blocking=True)

    def boom(a, b):
        raise OSError("disk on fire")
    monkeypatch.setattr(C.os, "replace", boom)
    with pytest.raises(OSError, match="disk on fire"):
        mgr.save(2, tree, blocking=True)
    monkeypatch.undo()
    assert mgr.latest() == 1
    _, out = mgr.restore(tree)
    _bit_equal(tree, out)
    assert not _no_staging(d)
    mgr.save(3, tree, blocking=True)
    assert _no_staging(d) and mgr.all_steps() == [1, 3]


def test_async_failure_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), async_save=True)

    def boom(a, b):
        raise OSError("late failure")
    monkeypatch.setattr(C.os, "replace", boom)
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="late failure"):
        mgr.wait()


def test_two_managers_one_dir(tmp_path, monkeypatch):
    """keep-last-k pruning by manager B does not corrupt manager A's
    in-flight save: A's staging dir is registered live, B's collector
    skips it, and both steps publish intact."""
    d = str(tmp_path)
    tree_a = {"w": torch.full((64, 64), 1.0)}
    tree_b = {"w": torch.full((64, 64), 2.0)}
    started = threading.Event()
    real_dump = json.dump

    def slow_dump(obj, fp, **kw):    # the manifest is written last
        if isinstance(obj, dict) and obj.get("step") == 1:
            started.set()
            time.sleep(0.5)
        return real_dump(obj, fp, **kw)
    monkeypatch.setattr(C.json, "dump", slow_dump)
    a = CheckpointManager(d, keep=3, async_save=True)
    b = CheckpointManager(d, keep=1, async_save=False)
    a.save(1, tree_a)
    assert started.wait(timeout=30)
    for s in (2, 3, 4):
        b.save(s, tree_b, blocking=True)
    a.wait()
    assert a.all_steps() == [1, 4]
    _, out1 = a.restore(tree_a, 1)
    _bit_equal(tree_a, out1)
    _, out4 = a.restore(tree_b, 4)
    _bit_equal(tree_b, out4)
    monkeypatch.undo()
    a.save(5, tree_a, blocking=True)
    assert _no_staging(d)


def test_save_waits_before_snapshot(tmp_path, monkeypatch):
    """The snapshot of save N happens after the in-flight save N-1 has
    published (wait first): snapshot and publish alternate."""
    events = []
    real_flatten = C._flatten
    real_replace = os.replace

    def log_flatten(*args, **kw):
        events.append("flatten")
        return real_flatten(*args, **kw)

    def slow_replace(a, b):
        time.sleep(0.3)
        events.append("publish")
        return real_replace(a, b)
    monkeypatch.setattr(C, "_flatten", log_flatten)
    monkeypatch.setattr(C.os, "replace", slow_replace)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = {"w": torch.ones(4)}
    mgr.save(1, tree)
    mgr.save(2, tree)
    mgr.wait()
    assert events == ["flatten", "publish", "flatten", "publish"], events


def test_snapshot_is_taken_at_save(tmp_path, monkeypatch):
    """An async save writes the values of the call, though the caller
    updates the tensors in place while the write runs (AdamW does)."""
    gate = threading.Event()
    real_write = CheckpointManager._write

    def held_write(self, *args):
        assert gate.wait(timeout=30)
        return real_write(self, *args)
    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.zeros(8)
    mgr.save(1, {"w": w})
    w.add_(5.0)
    gate.set()
    mgr.wait()
    _, out = mgr.restore({"w": w})
    assert not out["w"].any()


# ---------------------------------------------------------------------------
# 3. Across the packages
# ---------------------------------------------------------------------------

def _jax_trees():
    """{name: JAX tree}: SMOKE qwen3 (f32) params with AdamW's state
    (random moments, the master copy, a 0-d int32 step) and SMOKE
    transformer2d-720m in bf16."""
    jcfg = JLM.LMConfig(**{**qwen3_14b.SMOKE.__dict__, "dtype": jnp.float32})
    params = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    opt = JO.init_opt_state(params, JO.OptConfig())
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 1000))
    for k in ("m", "v"):
        opt[k] = jax.tree_util.tree_map(
            lambda a: jax.random.normal(next(keys), a.shape, a.dtype), opt[k])
    opt["step"] = jnp.asarray(5, jnp.int32)
    dcfg = JT2D.T2DConfig(**{**transformer2d_720m.SMOKE.__dict__,
                             "dtype": jnp.bfloat16})
    dit = JT2D.init_t2d(jax.random.PRNGKey(2), dcfg)
    return {"lm": {"params": params, "opt": opt}, "dit": {"params": dit}}


def _port_tree(jtree):
    """The JAX tree in the port: tensors through ``bridge``, the step an
    int."""
    host = jax.tree_util.tree_map(np.asarray, jtree)
    opt = host.get("opt", {})
    step = opt.pop("step", None)
    out = bridge.params_from_numpy(host, device="cpu")
    if step is not None:
        out["opt"]["step"] = int(step)
    return out


@pytest.mark.parametrize("name", ["lm", "dit"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, name):
    jtree = _jax_trees()[name]
    JC.CheckpointManager(str(tmp_path), async_save=False).save(
        3, jtree, blocking=True)
    want = _port_tree(jtree)
    step, got = CheckpointManager(str(tmp_path)).restore(want)
    assert step == 3
    _bit_equal(want, got)
    if name == "dit":
        assert all(t.dtype == torch.bfloat16 for t in
                   flatten(got).values() if t.is_floating_point())


@pytest.mark.parametrize("name", ["lm", "dit"])
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    jtree = _jax_trees()[name]
    tree = _port_tree(jtree)
    CheckpointManager(str(tmp_path), async_save=False).save(
        4, tree, blocking=True)
    template = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jtree)
    step, got = JC.CheckpointManager(str(tmp_path)).restore(template)
    assert step == 4
    want, have = flatten(jtree), flatten(got)
    assert sorted(want) == sorted(have)
    for k, w in want.items():
        w, h = np.asarray(w), np.asarray(have[k])
        assert w.dtype == h.dtype and w.shape == h.shape, k
        assert w.tobytes() == h.tobytes(), k


# ---------------------------------------------------------------------------
# 4. tools/inspect_ckpt.py
# ---------------------------------------------------------------------------

def test_inspect_ckpt_reads_a_port_checkpoint(tmp_path):
    d = str(tmp_path)
    CheckpointManager(d, async_save=False).save(
        2, {"a": torch.ones(4, 2), "b": torch.zeros(3, dtype=torch.int8),
            "h": torch.ones(5, dtype=torch.bfloat16), "step": 2},
        blocking=True, plan=[1, 2, 1], topology=Topology.uniform(4))
    tool = os.path.join(HERE, "..", "tools", "inspect_ckpt.py")
    proc = subprocess.run([sys.executable, tool, d, "--json"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout)
    assert info["step"] == 2 and info["format"] == C.FORMAT
    assert info["n_leaves"] == 4 and info["steps"] == [2]
    assert {l["key"] for l in info["leaves"]} == {"a", "b", "h", "step"}
    assert info["plan"] == {"kind": "dims", "dims": [1, 2, 1]}
    assert info["topology"] == Topology.uniform(4).to_dict()
    assert info["total_bytes"] == 4 * 2 * 4 + 3 + 5 * 2 + 4
