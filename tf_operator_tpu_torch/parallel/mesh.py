"""The job's mesh over ranks.

The counterpart of `tf_operator_tpu/parallel/mesh.py`.  The controller
injects TPUJOB_MESH_SHAPE ({axis: size}); this module lays the job's ranks
onto those axes with the JAX package's layout: axes in canonical order
(outermost first), ranks row-major, as `np.asarray(devices).reshape(sizes)`
lays devices.  So `dp` is outermost and the ranks of one `sp` group are
neighbours.

PyTorch runs one process per GPU, so where JAX lays devices the port lays
ranks, and the collectives of an axis run over that axis's process group
(`Mesh.group`), which `torch.distributed.device_mesh.init_device_mesh`
makes; a collective over several axes at once (the gradient sum over the
data and sequence axes) runs over `Mesh.group_over`.

Partition specs are plain tuples of axis names (None for a replicated dim),
the counterpart of `jax.sharding.PartitionSpec`: `param_partition_spec` and
`free_dim_partition_spec` choose the dim an axis shards, as the JAX
package's do, on the flax shapes of the parameters (`models/convert.py`
maps them onto the port's layout).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..api import constants

# Canonical axis names, outermost first.
AXIS_DP = "dp"      # data parallel (pure replication of params)
AXIS_FSDP = "fsdp"  # data parallel with sharded params/optimizer state
AXIS_TP = "tp"      # tensor (model) parallel
AXIS_SP = "sp"      # sequence/context parallel (ring attention, Ulysses)
AXIS_EP = "ep"      # expert parallel (MoE)
AXIS_PP = "pp"      # pipeline parallel
AXIS_ORDER = (AXIS_DP, AXIS_FSDP, AXIS_PP, AXIS_EP, AXIS_TP, AXIS_SP)


class Mesh:
    """Axis names and sizes over `size` ranks, row-major; and, when built
    over a process group, the torch DeviceMesh whose per-axis groups the
    collectives use."""

    def __init__(self, axis_names, sizes) -> None:
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = int(np.prod(sizes)) if sizes else 1
        self.device_mesh = None
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coordinate(self, axis: str, rank: Optional[int] = None) -> int:
        """`rank`'s index along `axis` (this process's rank by default); 0
        for an axis the mesh does not have."""
        if axis not in self.shape:
            return 0
        if rank is None:
            rank = _rank()
        coords = np.unravel_index(rank, tuple(self.shape.values()))
        return int(coords[self.axis_names.index(axis)])

    def over_group(self, device_type: str) -> "Mesh":
        """Lay this layout over the initialized process group (a torch
        DeviceMesh, whose per-axis groups the collectives use) and return
        it."""
        from torch.distributed.device_mesh import init_device_mesh

        self.device_mesh = init_device_mesh(
            device_type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        return self

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        if self.device_mesh is None:
            raise RuntimeError(
                f"{self} is a layout without a process group; build it with "
                "device_type= after torch.distributed.init_process_group")
        return self.device_mesh.get_group(axis)

    def group_over(self, axes: Sequence[str]):
        """The process group of this rank's ranks that differ only along
        `axes` (the mesh's axes among them; unknown names are ignored): the
        group one axis's `group` gives, None (the whole world) when `axes`
        cover every axis, or a subgroup made once per set of axes.  Every
        rank must ask for the same sets in the same order."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes == self.axis_names:
            return None
        if len(axes) == 1:
            return self.group(axes[0])
        if self.device_mesh is None:
            self.group(self.axis_names[0])  # raises: a layout has no groups
        if axes not in self._groups:
            import torch.distributed as dist

            ranks = np.arange(self.size).reshape(tuple(self.shape.values()))
            keep = [self.axis_names.index(a) for a in axes]
            rest = [i for i in range(len(self.axis_names)) if i not in keep]
            lines = ranks.transpose(rest + keep).reshape(
                -1, int(np.prod([self.shape[a] for a in axes], initial=1)))
            self._groups[axes], _ = dist.new_subgroups_by_enumeration(
                [row.tolist() for row in lines])
        return self._groups[axes]


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def build_mesh(axes: Optional[Dict[str, int]] = None,
               world_size: Optional[int] = None,
               device_type: Optional[str] = None) -> Mesh:
    """Build a Mesh from {axis: size} over `world_size` ranks (default: the
    process group's size, or 1 without one).

    The axis product must equal the rank count; with axes=None all ranks go
    on a single dp axis.  With `device_type` ("cuda" or "cpu") the mesh is
    also built as a torch DeviceMesh over the initialized process group;
    without, it is the layout alone."""
    if world_size is None:
        import torch.distributed as dist

        world_size = dist.get_world_size() if dist.is_initialized() else 1
    n = int(world_size)
    if not axes:
        axes = {AXIS_DP: n}
    # Keep canonical order for the axes given; unknown axes go last in
    # insertion order (users may invent axes).
    names = [a for a in AXIS_ORDER if a in axes] + [
        a for a in axes if a not in AXIS_ORDER
    ]
    sizes = [int(axes[a]) for a in names]
    total = int(np.prod(sizes)) if sizes else 1
    if total != n:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} require {total} devices, "
            f"but {n} are available"
        )
    mesh = Mesh(names, sizes)
    return mesh if device_type is None else mesh.over_group(device_type)


def mesh_from_env(world_size: Optional[int] = None,
                  device_type: Optional[str] = None) -> Mesh:
    """Build the mesh the controller assigned via TPUJOB_MESH_SHAPE."""
    raw = os.environ.get(constants.ENV_MESH_SHAPE, "")
    axes = json.loads(raw) if raw else None
    return build_mesh(axes, world_size, device_type)


def data_axes(mesh: Mesh) -> tuple:
    """The mesh axes a global batch is split over (dp + fsdp)."""
    return tuple(a for a in (AXIS_DP, AXIS_FSDP) if a in mesh.axis_names)


def axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape.get(name, 1)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= axis_size(mesh, a)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by dp size {n}")
    return global_batch // n


# ---------------------------------------------------------------------------
# partition specs on flax shapes: a spec is a tuple with one entry per dim
# (an axis name, a tuple of them, or None), trailing Nones optional


def _pick_shard_dim(shape: Sequence[int], size: int, prefer: str,
                    taken: Sequence[int] = ()) -> Optional[int]:
    """Among dims not in `taken` that the axis size divides (and that are
    >= size, so every shard is non-empty), the last (prefer="last") or the
    largest, ties toward the last (prefer="largest"); None when no dim
    qualifies."""
    if prefer not in ("last", "largest"):
        raise ValueError(f"prefer must be 'last'|'largest', got {prefer!r}")
    taken_set = set(taken)
    candidates = [i for i, d in enumerate(shape)
                  if i not in taken_set and d % size == 0 and d >= size]
    if not candidates:
        return None
    if prefer == "last":
        return candidates[-1]
    return max(candidates, key=lambda i: (shape[i], i))


def param_partition_spec(shape: Sequence[int], mesh: Mesh,
                         fsdp_axis: str = AXIS_FSDP) -> tuple:
    """FSDP-style weight sharding: the last divisible dim over the fsdp
    axis; () (replicated) otherwise."""
    size = axis_size(mesh, fsdp_axis)
    if size <= 1 or not shape:
        return ()
    dim = _pick_shard_dim(shape, size, "last")
    if dim is None:
        return ()
    spec = [None] * len(shape)
    spec[dim] = fsdp_axis
    return tuple(spec)


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def free_dim_partition_spec(shape: Sequence[int], mesh: Mesh,
                            axis: str = AXIS_DP, *, base: tuple = (),
                            prefer: str = "largest") -> tuple:
    """Lay `axis` onto a free dim of an array already laid out as `base`
    (the dim ZeRO's weight-update sharding splits the optimizer state
    over): a dim `base` leaves unsharded that the axis size divides,
    the largest (ties toward the last) by default.  Returns `base` itself
    when the axis is trivial, already used by `base`, or no dim
    qualifies."""
    size = axis_size(mesh, axis)
    base_entries = list(base) + [None] * (len(shape) - len(base))
    if size <= 1 or not shape:
        return base
    taken = [i for i, e in enumerate(base_entries) if e is not None]
    if any(axis in spec_axes(e) for e in base_entries):
        return base
    dim = _pick_shard_dim(shape, size, prefer, taken)
    if dim is None:
        return base
    base_entries[dim] = axis
    return tuple(base_entries)
