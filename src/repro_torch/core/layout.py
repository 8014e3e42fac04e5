"""Sequence-layout algebra for Dynamic Sequence Parallelism (counterpart of
``repro.core.layout``).

A *layout* records which logical tensor dimension the sequence-parallel mesh
axis currently shards (paper notation: ``s_i`` = sharded along sequence dim i,
``s_hat`` = unsharded).  The DSP primitives (switch / split / gather) are the
only legal transitions between layouts.  JAX's ``pspec``/``sharding`` serve
its compiler path, which PyTorch lacks, and are not ported.

``ParallelContext`` names the dims of a ``torch.distributed`` ``DeviceMesh``
by role: the SP dims carry the sequence shard (``model``, or the 2D SP
grid ``("sp_out", "sp_in")`` of ``launch.mesh.make_sp2d_mesh``), the other
dims (``data``) split the batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh

# Sentinel for the unsharded status (paper's  s_hat ).
UNSHARDED: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SeqLayout:
    """Shard status of one activation tensor w.r.t. the SP mesh axis.

    Attributes:
      shard_dim:  index of the tensor dimension sharded over ``sp_axis``;
                  ``None`` means the sequence is fully replicated (s_hat).
      batch_dim:  index of the batch dimension (sharded over the DP axes).
      ndim:       rank of the logical (global) tensor.
    """

    shard_dim: Optional[int]
    batch_dim: int = 0
    ndim: int = 4

    def switched(self, tgt_dim: int) -> "SeqLayout":
        if self.shard_dim is None:
            raise ValueError("switch() from unsharded layout; use split()")
        if not (0 <= tgt_dim < self.ndim):
            raise ValueError(f"target dim {tgt_dim} out of range for rank {self.ndim}")
        if tgt_dim == self.batch_dim:
            raise ValueError("cannot sequence-shard the batch dimension")
        return dataclasses.replace(self, shard_dim=tgt_dim)

    def gathered(self) -> "SeqLayout":
        return dataclasses.replace(self, shard_dim=UNSHARDED)

    def split(self, tgt_dim: int) -> "SeqLayout":
        if self.shard_dim is not None:
            raise ValueError("split() requires an unsharded layout; use switch()")
        return dataclasses.replace(self, shard_dim=tgt_dim)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """The mesh's dims by role, and this rank's place on them.
    ``sp_axes`` are the dims the sequence is sharded over, the first
    major: ``("model",)``, or ``("sp_out", "sp_in")`` on a 2D SP grid."""

    mesh: DeviceMesh
    sp_axes: Tuple[str, ...] = ("model",)
    dp_axes: Tuple[str, ...] = ("data",)

    def size(self, axis: str) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on mesh dim ``axis``."""
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of mesh dim ``axis``."""
        return self.mesh.get_group(axis)

    def _flat(self, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(size, this rank's index) of ``axes`` flattened, the first
        major."""
        size, idx = 1, 0
        for a in axes:
            size, idx = size * self.size(a), idx * self.size(a) + self.index(a)
        return size, idx

    @property
    def sp_axis(self) -> str:
        """The one SP dim; a 2D SP grid has none (name a dim of it)."""
        if len(self.sp_axes) != 1:
            raise ValueError(f"the mesh shards the sequence over "
                             f"{self.sp_axes}, not over one dim")
        return self.sp_axes[0]

    @property
    def sp_size(self) -> int:
        return self._flat(self.sp_axes)[0]

    @property
    def dp_size(self) -> int:
        return self._flat(self.dp_axes)[0]

    @property
    def world_size(self) -> int:
        return self.sp_size * self.dp_size

    @property
    def sp_index(self) -> int:
        """This rank's place in the sequence: its slice of the SP dims
        flattened, the first major (JAX's ``sp_out * p_in + sp_in``)."""
        return self._flat(self.sp_axes)[1]

    @property
    def dp_index(self) -> int:
        """This rank's place among the data-parallel replicas (the DP dims
        flattened, the first major)."""
        return self._flat(self.dp_axes)[1]

    @property
    def sp_group(self):
        """The process group of the ``model`` dim: the switches' group."""
        return self.group(self.sp_axis)


SP2D_AXES = ("sp_out", "sp_in")


def from_mesh(mesh: DeviceMesh) -> ParallelContext:
    """The context of ``mesh``: ``("sp_out", "sp_in")`` shard the sequence
    on a mesh that has both, else ``model``; the other dims split the
    batch."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names)
    sp_axes = (SP2D_AXES if all(a in names for a in SP2D_AXES)
               else ("model",))
    dp = tuple(a for a in names if a not in sp_axes)
    return ParallelContext(mesh=mesh, sp_axes=sp_axes, dp_axes=dp)


def divisible(global_dim: int, n: int) -> bool:
    return global_dim % n == 0


def local_shape(global_shape: Sequence[int], layout: SeqLayout, n_sp: int,
                n_dp: int = 1) -> Tuple[int, ...]:
    """Per-device shape of a tensor with the given layout."""
    shape = list(global_shape)
    shape[layout.batch_dim] //= n_dp
    if layout.shard_dim is not None:
        if shape[layout.shard_dim] % n_sp:
            raise ValueError(
                f"dim {layout.shard_dim} size {shape[layout.shard_dim]} not divisible "
                f"by SP size {n_sp}")
        shape[layout.shard_dim] //= n_sp
    return tuple(shape)
