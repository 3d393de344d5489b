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
makes.  Parameter partition specs (fsdp, tp) are not ported yet (ROADMAP
item A.8).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

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
