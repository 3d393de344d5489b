"""Cross-replica sharded weight update (ZeRO-style) over the dp axis.

The counterpart of `tf_operator_tpu/train/zero.py` (arXiv:2004.13336):
AdamW keeps two f32 moments per parameter, and in plain data parallelism
every dp rank holds all of them.  Sharding the moments and the weight
update over dp cuts that to about 1/dp per rank with the same arithmetic:
the gradients are reduce-scattered along one dim (`reduce_scatter_along`),
each rank updates its slice, clipping included (the global norm sums the
slices), and the updated slices are all-gathered back into the parameter
(`all_gather_along`).  `parallel/shard.py` runs these steps.

The *plan* is the same artifact as the JAX package's, on flax paths and
shapes: one JSON-serializable entry per parameter naming the dim the dp
axis lands on (the largest free dim, ties toward the last:
`parallel/mesh.free_dim_partition_spec`), on top of the parameter's tp and
fsdp layout; `to_json` prints byte for byte what the JAX plan prints for
the same parameters and mesh.  Moments are matched to parameters by path
suffix and shape, never shape alone (`match_param_suffix`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import AXIS_DP, axis_size, free_dim_partition_spec, \
    spec_axes


def _spec_entries(spec: tuple, ndim: int) -> tuple:
    entries = tuple(spec)
    return entries + (None,) * (ndim - len(entries))


def _spec_to_json(spec: tuple, ndim: int) -> List:
    return [list(e) if isinstance(e, tuple) else e
            for e in _spec_entries(spec, ndim)]


def _spec_from_json(raw: Sequence) -> tuple:
    entries = [tuple(e) if isinstance(e, list) else e for e in raw]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    path: Tuple[str, ...]  # flax param path, e.g. ("block_0", "mlp", "wi", "kernel")
    shape: Tuple[int, ...]
    dim: Optional[int]  # the dim dp shards, None = replicated over dp
    base: tuple  # the param's own (tp/fsdp) spec
    spec: tuple  # base + dp on `dim`: the optimizer state's spec
    # declares the entry's weight-update collectives overlappable
    # (`ZeroShardingPlan.with_overlap`; `analysis/hlo.py` checks it)
    overlap: bool = False


@dataclasses.dataclass(frozen=True)
class ZeroShardingPlan:
    """Per-parameter weight-update sharding over one data-parallel axis."""

    axis: str
    num_shards: int
    entries: Tuple[PlanEntry, ...]
    # the mesh (a layout) the plan was built for; not serialized
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        # longest path first, so suffix matching prefers the most specific
        by_shape: Dict[Tuple[int, ...], List[PlanEntry]] = {}
        for e in sorted(self.entries, key=lambda e: -len(e.path)):
            by_shape.setdefault(e.shape, []).append(e)
        object.__setattr__(self, "_by_shape", by_shape)

    def match(self, parts: Sequence[str], shape) -> Optional[PlanEntry]:
        return match_param_suffix(parts, shape, self._by_shape)

    def to_json(self) -> str:
        return json.dumps(
            {
                "axis": self.axis,
                "numShards": self.num_shards,
                "params": [
                    {
                        "path": "/".join(e.path),
                        "shape": list(e.shape),
                        "dim": e.dim,
                        "base": _spec_to_json(e.base, len(e.shape)),
                        **({"overlap": True} if e.overlap else {}),
                    }
                    for e in self.entries
                ],
            },
            separators=(",", ":"),
        )

    def with_overlap(self) -> "ZeroShardingPlan":
        """A copy whose sharded entries are marked overlappable: the
        declaration the `hlo-sync-collective` rule (`analysis/hlo.py`)
        holds the step's weight-update gathers to."""
        return dataclasses.replace(
            self,
            entries=tuple(
                dataclasses.replace(e, overlap=True) if e.dim is not None
                else e
                for e in self.entries
            ),
        )

    @classmethod
    def from_json(cls, text: str, mesh=None) -> "ZeroShardingPlan":
        raw = json.loads(text)
        axis, num = raw["axis"], int(raw["numShards"])
        entries = []
        for p in raw["params"]:
            base = _spec_from_json(p["base"])
            shape = tuple(int(d) for d in p["shape"])
            dim = p["dim"]
            if dim is None:
                spec = base
            else:
                spec_entries = list(_spec_entries(base, len(shape)))
                spec_entries[dim] = axis
                spec = tuple(spec_entries)
            entries.append(PlanEntry(
                path=tuple(p["path"].split("/")), shape=shape, dim=dim,
                base=base, spec=spec, overlap=bool(p.get("overlap", False))))
        return cls(axis=axis, num_shards=num, entries=tuple(entries),
                   mesh=mesh)


def match_param_suffix(parts: Sequence[str], shape, by_shape
                       ) -> Optional[PlanEntry]:
    """The entry whose full path is a suffix of `parts` and whose shape is
    `shape`; the longest path wins."""
    shape = tuple(shape) if shape is not None else ()
    parts = tuple(parts)
    for entry in by_shape.get(shape, ()):
        n = len(entry.path)
        if n and parts[-n:] == entry.path:
            return entry
    return None


def build_zero_plan(params, mesh, axis: str = AXIS_DP,
                    base_specs=None) -> ZeroShardingPlan:
    """Choose the weight-update shard dim of every parameter.

    `params` is a sequence of (flax path, flax shape) in the flax params'
    flattening order (paths sorted); `base_specs` the matching sequence of
    each parameter's own spec (`tp_rules.combined_spec`), replicated when
    omitted."""
    num = axis_size(mesh, axis)
    entries = []
    for i, (path, shape) in enumerate(params):
        shape = tuple(shape)
        base = tuple(base_specs[i]) if base_specs is not None else ()
        spec = free_dim_partition_spec(shape, mesh, axis, base=base,
                                       prefer="largest")
        dim = None
        if spec is not base:
            for d, (b, s) in enumerate(zip(_spec_entries(base, len(shape)),
                                           _spec_entries(spec, len(shape)))):
                if b != s:
                    dim = d
                    break
        entries.append(PlanEntry(path=tuple(path), shape=shape, dim=dim,
                                 base=base, spec=spec))
    return ZeroShardingPlan(axis=axis, num_shards=num,
                            entries=tuple(entries), mesh=mesh)


def base_placement_plan(params, mesh, base_specs=None) -> ZeroShardingPlan:
    """A plan with no dp axis whose entries carry only the parameters' own
    layouts (the dense optimizer state's placement)."""
    return build_zero_plan(params, mesh, axis="", base_specs=base_specs)


def plan_for_model(model, mesh, axis: str = AXIS_DP) -> ZeroShardingPlan:
    """The plan of a port model (TransformerLM, BertEncoder, ViT or ResNet)
    from its flax paths and shapes (`models/convert.flax_param_map`) and
    their `combined_spec` under `mesh`: the plan the JAX workload builds
    for the same model and mesh."""
    from ..models.convert import flax_param_map
    from ..parallel.tp_rules import combined_spec

    entries = flax_param_map(model)
    return build_zero_plan(
        [(e.path, e.shape) for e in entries], mesh, axis,
        base_specs=[combined_spec("/".join(e.path), e.shape, mesh)
                    for e in entries])


def _shard_factor(entry: PlanEntry, plan: ZeroShardingPlan) -> int:
    """How many ways the entry's moments are split: over every axis of its
    spec with the plan's mesh, else over the dp axis alone."""
    if plan.mesh is not None:
        factor = 1
        for e in entry.spec:
            for a in spec_axes(e):
                factor *= axis_size(plan.mesh, a)
        return factor
    return plan.num_shards if entry.dim is not None else 1


def opt_state_bytes_per_device(plan: Optional[ZeroShardingPlan], params,
                               moments_per_param: int = 2,
                               itemsize: int = 4) -> int:
    """Resident optimizer-moment bytes per rank under `plan` (None: fully
    replicated): `moments_per_param` moments of `itemsize` bytes per
    element of each (flax path, flax shape) in `params`, each divided by
    every mesh axis its entry's spec shards over."""
    total = 0
    for path, shape in params:
        shape = tuple(shape)
        n = int(np.prod(shape, initial=1)) * itemsize * moments_per_param
        entry = plan.match(path, shape) if plan else None
        if entry is not None:
            n //= _shard_factor(entry, plan)
        total += n
    return total


# ---------------------------------------------------------------------------
# the collectives of the sharded update


def slice_along(x, dim: int, group):
    """This rank's contiguous 1/n of `x` along `dim`, n the group's size."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)]


def reduce_scatter_along(x, dim: int, group):
    """The sum of `x` over the group's ranks, this rank's slice of it along
    `dim` (as `slice_along` cuts it)."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def all_gather_along(x, dim: int, group):
    """The group's slices of a tensor along `dim` joined in rank order: the
    inverse of `slice_along`."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] * n,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)
