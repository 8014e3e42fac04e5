"""Plan-aware sharded checkpoints (counterpart of ``repro.train.checkpoint``,
in its format: ``FORMAT = "dsp-ckpt-v1"``).

A checkpoint is ``step_<n:08d>/shard_<k:05d>/arr_<i:04d>_<j:04d>.npy``
plus ``step_<n:08d>/manifest.json``, which records per leaf (``key``, the
``/``-joined dict keys) the global ``shape``, the ``dtype`` by name, the
``sharded_dims`` and each shard's file and index ranges, and, run-level,
the solved plan (``core.plan.plan_to_dict``), the ``Topology`` and a small
``meta`` dict.  A checkpoint written by either package restores in the
other, bit for bit.

Save: each rank of the manager's group snapshots its slices of the tree
on the caller's thread (device to host copies), and writes them under
``shard_<rank>``.  A leaf's layout is its ``param_pspecs`` spec on the
``ParallelContext`` (the slices ``parallel.partition.shard_params``
cuts); a rank writes its slice only when its coordinate is 0 on every
mesh dim the spec does not name, so each distinct slice is written once
(JAX keeps ``replica_id == 0``).  Rank 0 names one ``tmp.<step>.<pid>.
<uid>`` staging dir and broadcasts it, gathers every rank's shard records
once all have written, writes the manifest LAST and publishes with
``os.replace``: a crash at any point leaves the latest durable
checkpoint intact, and the next save collects the staging dirs of dead
writers.  Ranks exchange names, records and the outcome over a gloo group
the manager makes at construction (every rank of the world constructs
it), so an async save may run them on its thread beside NCCL work on the
caller's.

Restore reshards on load: each rank reads, through ``np.load(mmap_mode=
"r")``, only the shards that overlap the slice it asks for, and copies
the overlaps into it; save at (2, 2) under ZeRO-3, restore at (1, 4) or
on one device, bit for bit.  Missing leaves, shape mismatches and
incomplete coverage raise; nothing is zero-filled.

bfloat16 (and float8) have no numpy type here (no ``ml_dtypes`` on the
card): their bytes are written as raw ``|V<itemsize>`` arrays, which is
how ``np.save`` stores JAX's ``ml_dtypes`` arrays, and read back through
an integer view; a value never passes through a float cast.  A Python
int leaf (AdamW's step count) is saved as a 0-d int32, as JAX holds it,
and restored to an int.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.plan import plan_to_dict
from repro_torch.models.lm import tree_leaves
from repro_torch.parallel.partition import (
    _path_str, global_shape, reduce_axes, slice_index, tree_map_with_path)

FORMAT = "dsp-ckpt-v1"

# staging dirs being written BY THIS PROCESS (any manager); the orphan
# collector never touches these, so two managers sharing a directory
# cannot collect each other's in-flight save
_ACTIVE_TMPS = set()
_ACTIVE_LOCK = threading.Lock()
_UID = itertools.count()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _raw_np(name: str) -> np.dtype:
    """The numpy type that holds a leaf's bytes: numpy's own, or for a
    type numpy lacks (bfloat16, float8_*) an integer of its width."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype {name!r} has no torch type")
    if name == "bfloat16" or name.startswith("float8"):
        return np.dtype(f"int{8 * dtype.itemsize}")
    return np.dtype(name)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a snapshot: the caller may update ``t`` in
    place afterwards); types numpy lacks as raw ``|V`` bytes."""
    host = t.detach().to("cpu", copy=True)
    raw = _raw_np(_name(t.dtype))
    if t.dtype.is_floating_point and raw.kind == "i":
        return host.view(getattr(torch, raw.name)).numpy().view(
            f"V{raw.itemsize}")
    return host.numpy()


def _to_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    """``arr`` (the bytes of a ``name`` leaf, in ``_raw_np(name)``) as a
    tensor of that dtype."""
    t = torch.from_numpy(arr)
    dtype = getattr(torch, name)
    return t if t.dtype == dtype else t.view(dtype)


def _writes(spec, ctx, rank: int) -> bool:
    """Whether this rank writes its slice of a leaf of ``spec``: its
    coordinate is 0 on every mesh dim the spec does not split over (one
    copy of each distinct slice); without a mesh, rank 0 of the group."""
    if ctx is None:
        return rank == 0
    return all(ctx.index(a) == 0
               for a in reduce_axes(spec, ctx.mesh.mesh_dim_names))


def _flatten(tree, specs=None, ctx=None, rank: int = 0) -> List[Dict]:
    """Synchronous host snapshot of this rank's part of ``tree``: one
    record per leaf with the global shape, dtype, sharded dims and the
    (index, host array) shards it writes.  Runs on the caller's thread,
    so the snapshot is consistent."""
    if specs is None:
        specs = tree_map_with_path(lambda *_: None, tree)
    out = []

    def record(path, leaf, spec):
        if isinstance(leaf, int):
            rec = {"shape": (), "dtype": "int32", "sharded_dims": [],
                   "shards": ([((), np.asarray(leaf, np.int32))]
                              if _writes((), ctx, rank) else [])}
        else:
            gshape = global_shape(leaf.shape, spec, ctx)
            rec = {"shape": gshape, "dtype": _name(leaf.dtype),
                   "sharded_dims": [d for d, (whole, part) in enumerate(zip(
                       gshape, leaf.shape)) if part != whole],
                   "shards": ([(slice_index(gshape, spec, ctx),
                                _to_numpy(leaf))]
                              if _writes(spec, ctx, rank) else [])}
        out.append({**rec, "key": _path_str(path)})
    tree_map_with_path(record, tree, specs)
    return out


def _read(base: str, rec: Dict[str, Any], index) -> np.ndarray:
    """The part ``index`` (per-dim (start, stop) on the global shape) of
    one leaf, from the shards that overlap it (memory-mapped), in
    ``_raw_np`` of its dtype.  Raises on incomplete coverage (a lost shard
    must never zero-fill) and on dtype corruption."""
    raw = _raw_np(rec["dtype"])
    shape = tuple(e - s for s, e in index)
    out = np.empty(shape, raw)
    covered = 0
    for sh in rec["shards"]:
        have = [tuple(int(x) for x in r) for r in sh["index"]]
        lohi = [(max(s, a), min(e, b)) for (s, e), (a, b) in zip(index, have)]
        if any(lo >= hi for lo, hi in lohi):
            continue
        arr = np.load(os.path.join(base, sh["file"]), mmap_mode="r",
                      allow_pickle=False)
        if arr.dtype != raw:
            if arr.dtype.itemsize != raw.itemsize:
                raise ValueError(
                    f"leaf {rec['key']!r}: shard {sh['file']} has dtype "
                    f"{arr.dtype} ({arr.dtype.itemsize}B), manifest records "
                    f"{rec['dtype']} ({raw.itemsize}B)")
            arr = arr.view(raw)
        if arr.shape != tuple(b - a for a, b in have):
            raise ValueError(
                f"leaf {rec['key']!r}: shard {sh['file']} shape {arr.shape} "
                f"does not match its index extents {sh['index']}")
        src = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in
                    zip(lohi, have))
        dst = tuple(slice(lo - s, hi - s) for (lo, hi), (s, _) in
                    zip(lohi, index))
        out[dst] = arr[src]
        covered += int(np.prod([hi - lo for lo, hi in lohi]))
    total = int(np.prod(shape))
    if covered != total:
        raise ValueError(
            f"leaf {rec['key']!r}: shards cover {covered} of {total} "
            f"elements of {index} (global shape {tuple(rec['shape'])}); "
            f"refusing to zero-fill")
    return out


class CheckpointManager:
    """Saves and restores under ``directory``, keeping the last ``keep``
    steps.  With a default process group, every rank of the world must
    construct it at the same point: it makes a gloo group over ``ranks``
    (default: the world) that carries the save's names, records and
    outcome; a rank outside ``ranks`` may restore but not save.  Without
    one it is a manager of one rank."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True, ranks=None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._group = None
        self.rank: Optional[int] = 0
        self.world = 1
        if dist.is_available() and dist.is_initialized():
            ranks = (list(range(dist.get_world_size())) if ranks is None
                     else [int(r) for r in ranks])
            self._group = dist.new_group(ranks, backend="gloo")
            self._root = ranks[0]
            me = dist.get_rank()
            self.rank = ranks.index(me) if me in ranks else None
            self.world = len(ranks)
        # seconds and bytes of the last save: snapshot (caller's thread),
        # write (this rank's shards), publish (manifest and rename)
        self.last_save: Dict[str, float] = {}
        os.makedirs(directory, exist_ok=True)

    # -- the group ----------------------------------------------------------
    def _on_root(self, fn):
        """``fn()`` on rank 0, its value (or its error) broadcast to every
        rank of the group."""
        if self._group is None:
            return fn()
        box = [None]
        if self.rank == 0:
            try:
                box = [(True, fn())]
            except Exception as e:      # raised on every rank below
                box = [(False, e)]
        dist.broadcast_object_list(box, src=self._root, group=self._group)
        ok, value = box[0]
        if not ok:
            raise value
        return value

    def _gather(self, obj) -> Optional[list]:
        """``obj`` of every rank, in rank order, on rank 0 (None
        elsewhere)."""
        if self._group is None:
            return [obj]
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=self._root, group=self._group)
        return out

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             plan: Any = None, topology: Any = None,
             meta: Optional[Dict[str, Any]] = None, specs=None, ctx=None):
        """Snapshot and publish ``step``; every rank of the group calls
        it.  ``tree``: nested dicts of this rank's tensors (and ints),
        laid out by ``specs`` (``param_pspecs`` of the global tree, the
        same structure) on ``ctx``'s mesh, or whole without them.

        ``wait()`` runs FIRST: the previous async save finishes before
        this step's snapshot.  The snapshot is synchronous; the writes, the
        exchange and the publish run on a thread unless ``blocking``.
        ``plan`` (a dim list, ``JointPlan`` or ``StrategyPlan``),
        ``topology`` (``core.topology.Topology``) and ``meta`` (a small
        JSON-safe dict) go into the manifest."""
        if self.rank is None:
            raise ValueError("this rank is not in the manager's group")
        self.wait()               # one in-flight save at a time: wait FIRST
        t0 = time.perf_counter()
        flat = _flatten(tree, specs, ctx, self.rank)
        plan_d = None if plan is None else plan_to_dict(plan)
        topo_d = None if topology is None else topology.to_dict()
        stats = {"snapshot_s": time.perf_counter() - t0,
                 "bytes": sum(a.nbytes for r in flat
                              for _, a in r["shards"])}

        def work():
            tmp = self._on_root(lambda: self._staging(step))
            with _ACTIVE_LOCK:
                _ACTIVE_TMPS.add(tmp)
            try:
                t1 = time.perf_counter()
                try:
                    mine = (self._write(tmp, flat), None)
                except Exception as e:
                    if self._group is None:
                        raise
                    mine = (None, e)
                parts = self._gather(mine)
                stats["write_s"] = time.perf_counter() - t1
                t2 = time.perf_counter()
                self._on_root(lambda: self._publish(
                    step, tmp, parts, {"plan": plan_d, "topology": topo_d,
                                       "meta": meta or {}}))
                stats["publish_s"] = time.perf_counter() - t2
            finally:
                with _ACTIVE_LOCK:
                    _ACTIVE_TMPS.discard(tmp)
            self.last_save = stats

        if blocking or not self.async_save:
            work()
        else:
            def guarded():
                try:
                    work()
                except BaseException as e:     # surfaced on next wait()
                    self._error = e
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def _staging(self, step: int) -> str:
        """Rank 0: collect abandoned staging dirs, name this save's."""
        self._gc_orphans()
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}.{next(_UID)}")
        os.makedirs(tmp)
        return tmp

    def _write(self, tmp: str, flat: List[Dict]) -> List[Dict]:
        """This rank's shard files; returns its manifest records."""
        sub = f"shard_{self.rank:05d}"
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        leaves = []
        for i, rec in enumerate(flat):
            entries = []
            # each host copy is dropped once written, so the snapshot and
            # the files (in memory on a tmpfs) are not held whole together
            shards, rec["shards"] = rec["shards"], []
            for j, (index, arr) in enumerate(shards):
                fname = f"{sub}/arr_{i:04d}_{j:04d}.npy"
                np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
                entries.append({"file": fname,
                                "index": [[int(s), int(e)] for s, e in index]})
            leaves.append({"key": rec["key"],
                           "shape": [int(d) for d in rec["shape"]],
                           "dtype": rec["dtype"],
                           "sharded_dims": [int(d) for d in
                                            rec["sharded_dims"]],
                           "shards": entries})
        return leaves

    def _publish(self, step: int, tmp: str, parts, run: Dict[str, Any]):
        """Rank 0, once every rank has written: merge the ranks' records,
        write the manifest LAST, rename atomically, prune."""
        failed = [e for _, e in parts if e is not None]
        if failed:
            raise failed[0]
        leaves = parts[0][0]
        for other, _ in parts[1:]:
            for rec, theirs in zip(leaves, other):
                if rec["key"] != theirs["key"]:
                    raise ValueError(f"ranks disagree on the tree: "
                                     f"{rec['key']!r} vs {theirs['key']!r}")
                rec["shards"].extend(theirs["shards"])
        manifest = {"format": FORMAT, "step": step, "leaves": leaves, **run}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)           # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _gc_orphans(self):
        """Remove staging dirs abandoned by dead or failed writers.  A tmp
        dir is live only while (a) a manager in THIS process holds it in
        ``_ACTIVE_TMPS``, or (b) its embedded pid names a DIFFERENT live
        process.  Only rank 0 of a group names (and so collects) staging
        dirs, and only between saves, when no rank of its job writes one."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in names:
            if not name.startswith("tmp."):
                continue
            path = os.path.join(self.dir, name)
            with _ACTIVE_LOCK:
                if path in _ACTIVE_TMPS:
                    continue
            parts = name.split(".")
            pid = (int(parts[2]) if len(parts) >= 3 and parts[2].isdigit()
                   else None)
            if pid is not None and pid != os.getpid() and _alive(pid):
                continue
            shutil.rmtree(path, ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest(self) -> Optional[int]:
        """Alias of ``latest_step``."""
        return self.latest_step()

    def load_manifest(self, step: Optional[int] = None):
        """(step, manifest dict) of a durable checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        with open(path) as f:
            return step, json.load(f)

    def restore(self, template: Any, step: Optional[int] = None, *,
                specs=None, ctx=None, device=None):
        """Restore into the structure, GLOBAL shapes and dtypes of
        ``template`` (nested dicts of tensors, meta tensors included, and
        ints), resharding on load.  Without ``ctx`` each leaf comes back
        whole; with ``ctx`` and ``specs`` (``param_pspecs`` of the global
        tree), as this rank's slice (``shard_params``' cut), read from the
        shards that overlap it.  Tensors land on ``device`` (default: the
        template leaf's), in its dtype; int leaves come back as ints.
        Returns (step, tree).

        Template keys absent from the checkpoint, global-shape mismatches
        or incomplete coverage raise ``ValueError`` (no zero-fill);
        checkpoint-only keys are ignored, so a sub-tree (params without
        the optimizer state) restores."""
        step, man = self.load_manifest(step)
        base = os.path.join(self.dir, f"step_{step:08d}")
        records = {r["key"]: r for r in man.get("leaves", [])}
        keys = set(tree_leaves(tree_map_with_path(
            lambda path, _: _path_str(path), template)))
        missing = sorted(keys - set(records))
        if missing:
            extra = sorted(set(records) - keys)
            raise ValueError(
                f"checkpoint step {step} is missing leaves the template "
                f"requires: {missing} (checkpoint-only leaves: {extra}); "
                f"refusing to zero-fill")
        if specs is None:
            specs = tree_map_with_path(lambda *_: None, template)

        def one(path, leaf, spec):
            key = _path_str(path)
            rec = records[key]
            gshape = tuple(int(d) for d in rec["shape"])
            tshape = () if isinstance(leaf, int) else tuple(leaf.shape)
            if tshape != gshape:
                raise ValueError(
                    f"leaf {key!r}: checkpoint global shape {gshape} != "
                    f"template shape {tshape}")
            arr = _read(base, rec, slice_index(gshape, spec, ctx))
            if isinstance(leaf, int):
                return int(arr)
            return _to_torch(arr, rec["dtype"]).to(
                device=device if device is not None else leaf.device,
                dtype=leaf.dtype)
        return step, tree_map_with_path(one, template, specs)


__all__ = ["FORMAT", "CheckpointManager"]
