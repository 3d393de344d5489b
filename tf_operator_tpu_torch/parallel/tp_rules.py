"""Parameter-sharding rules: tensor parallelism and FSDP.

The counterpart of `tf_operator_tpu/parallel/tp_rules.py`: the same regex
table over '/'-joined flax parameter paths ("block_3/attn/query/kernel"),
and the same specs for the same flax shapes, with the same fallbacks (a
dim the tp axis does not divide replicates; fsdp takes the largest
remaining divisible dim).  The rules follow the Megatron pairing:
column-parallel qkv, wi and wg (output dim sharded) feed row-parallel out
and wo (input dim sharded), one all-reduce per attention or MLP, and the
token embedding is vocab-sharded.

The mixture-of-experts weights wi [E, d, f] and wo [E, f, d] shard their
expert dim over `ep` (`_EP_RULES`, consulted first); no tp rule matches a
`moe/*` leaf, so under tp the experts and the router are replicated.

The JAX package hands the specs to XLA; here `param_layouts` maps each
spec onto the port's parameters through `models/convert.flax_param_map`
(flax dim -> port dim), and `parallel/shard.py` lays them out: tp and ep by
slicing the parameter and the modules' own collectives, fsdp with FSDP2.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .mesh import AXIS_EP, AXIS_FSDP, AXIS_TP, axis_size, spec_axes

# (path regex, dim the tp axis shards or None) — first match wins
_TP_RULES: Tuple[Tuple[str, Optional[int]], ...] = (
    # attention projections: DenseGeneral kernels (d_model, heads, head_dim)
    (r"attn/(query|key|value)/kernel$", 1),
    (r"attn/(query|key|value)/bias$", 0),
    # out projection kernel (heads, head_dim, d_model): input heads
    (r"attn/out/kernel$", 0),
    (r"attn/out/bias$", None),
    # MLP: wi (and the SwiGLU gate wg) column-parallel, wo row-parallel
    (r"mlp/(wi|wg)/kernel$", 1),
    (r"mlp/(wi|wg)/bias$", 0),
    (r"mlp/wo/kernel$", 0),
    (r"mlp/wo/bias$", None),
    # embeddings: vocab-sharded
    (r"(wte|tok_emb)/embedding$", 0),
)

# MoE expert weights [E, d_in, d_out]: the expert dim shards over `ep`
_EP_RULES: Tuple[Tuple[str, int], ...] = (
    (r"moe/wi$", 0),
    (r"moe/wo$", 0),
)


def tp_rule_dim(path: str, shape, tp: int):
    """(matched, dim): whether a rule matches `path`, and the dim the tp
    axis of size `tp` shards (None: replicated, also when `tp` does not
    divide the rule's dim)."""
    for pattern, dim in _TP_RULES:
        if re.search(pattern, path):
            if dim is None or dim >= len(shape) or shape[dim] % tp:
                return True, None
            return True, dim
    return False, None


def tp_spec_for_path(path: str, shape, mesh) -> Optional[tuple]:
    """The tensor-parallel spec for a flax param path, or None when no rule
    matches or the tp axis is absent or of size 1."""
    tp = axis_size(mesh, AXIS_TP)
    if tp <= 1:
        return None
    matched, dim = tp_rule_dim(path, shape, tp)
    if not matched:
        return None
    spec = [None] * len(shape)
    if dim is not None:
        spec[dim] = AXIS_TP
    return tuple(spec)


def ep_rule_dim(path: str) -> Optional[int]:
    """The dim an ep rule shards for `path`, or None when none matches."""
    for pattern, dim in _EP_RULES:
        if re.search(pattern, path):
            return dim
    return None


def ep_spec_for_path(path: str, shape, mesh) -> Optional[tuple]:
    """The expert-parallel spec for a flax param path (the rule's dim, when
    the ep axis divides it), or None when no rule matches or the ep axis
    is absent or of size 1."""
    ep = axis_size(mesh, AXIS_EP)
    dim = ep_rule_dim(path)
    if ep <= 1 or dim is None:
        return None
    spec = [None] * len(shape)
    if dim < len(shape) and shape[dim] % ep == 0:
        spec[dim] = AXIS_EP
    return tuple(spec)


def combined_spec(path: str, shape, mesh) -> tuple:
    """The ep rule, else the tp rule; then fsdp on the largest remaining
    divisible dim.  Trailing Nones are dropped, as the JAX function drops
    them."""
    ndim = len(shape)
    spec = ep_spec_for_path(path, shape, mesh)
    if spec is None:
        spec = tp_spec_for_path(path, shape, mesh)
    parts = list(spec) if spec is not None else [None] * ndim
    while len(parts) < ndim:
        parts.append(None)
    fsdp = axis_size(mesh, AXIS_FSDP)
    if fsdp > 1:
        candidates = [i for i, d in enumerate(shape)
                      if parts[i] is None and d % fsdp == 0 and d >= fsdp]
        if candidates:
            dim = max(candidates, key=lambda i: shape[i])
            parts[dim] = AXIS_FSDP
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclass(frozen=True)
class ParamLayout:
    """One port parameter's place on the mesh: its flax path and shape, its
    spec there (`combined_spec`), and the port dims the tp, ep, fsdp and
    (under ZeRO) dp axes shard (None: replicated over that axis).

    The ZeRO plan may put dp on a head_dim, which lies inside the port's
    merged [heads * head_dim]: the slice is then taken on the view that
    splits that port dim in two (`zero_split`: the port dim and head_dim;
    the query weight [H * D, d] as [H, D, d], a free view), and `zero_dim`
    is the dim of that view."""

    name: str
    path: Tuple[str, ...]
    flax_shape: Tuple[int, ...]
    spec: tuple
    # port_dims[i]: the port dim holding flax dim i (convert.FlaxParam.dims)
    port_dims: Tuple[Optional[int], ...] = ()
    tp_dim: Optional[int] = None
    ep_dim: Optional[int] = None
    fsdp_dim: Optional[int] = None
    zero_dim: Optional[int] = None
    zero_split: Optional[Tuple[int, int]] = None

    def port_dim(self, flax_dim: int) -> int:
        """The port dim holding flax dim `flax_dim` whole; raises where
        none does (head_dim inside a merged [heads * head_dim])."""
        dim = self.port_dims[flax_dim]
        if dim is None:
            raise ValueError(
                f"{self.name}: flax dim {flax_dim} of {'/'.join(self.path)} "
                f"{self.flax_shape} has no single dim in the port's layout "
                "(it lies inside a merged [heads * head_dim] dim), so it "
                "cannot be sharded there")
        return dim

    def view_dim(self, flax_dim: int):
        """(dim, split): the port dim holding flax dim `flax_dim` whole and
        split None; or, for a head_dim (the minor factor of the port dim
        that holds the flax dim before it, the heads), its dim in the view
        that splits that port dim in two, and split = (that port dim,
        head_dim)."""
        if self.port_dims[flax_dim] is not None or flax_dim == 0:
            return self.port_dim(flax_dim), None
        outer = self.port_dim(flax_dim - 1)
        return outer + 1, (outer, self.flax_shape[flax_dim])

    def flax_spec(self, held: Dict[str, int], mesh) -> tuple:
        """The spec on the flax dims of a tensor held sharded on the port
        dims `held` ({axis: port dim}): each axis on the flax dim that lies
        at its port dim and that the axis divides."""
        parts = [None] * len(self.flax_shape)
        for axis, port_dim in held.items():
            size = axis_size(mesh, axis)
            for i, d in enumerate(self.flax_shape):
                if parts[i] is None and self.port_dims[i] == port_dim \
                        and d % size == 0 and d >= size:
                    parts[i] = axis
                    break
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)


def _flax_dim(spec, axis):
    for flax_dim, e in enumerate(spec):
        if axis in spec_axes(e):
            return flax_dim
    return None


def param_layouts(model, mesh, zero_plan=None) -> Dict[str, ParamLayout]:
    """{port name: ParamLayout} for every parameter of `model` under `mesh`
    (a layout: axis names and sizes), from the flax paths and shapes of
    `models/convert.flax_param_map`.  With a ZeRO plan each entry also gets
    the port dim of the plan's dp dim (on the view that splits a merged
    [heads * head_dim], `ParamLayout.view_dim`).  Raises ValueError where
    a tp, ep or fsdp spec shards a flax dim that has no single port
    dim."""
    from ..models.convert import flax_param_map

    out = {}
    for entry in flax_param_map(model):
        spec = combined_spec("/".join(entry.path), entry.shape, mesh)
        lay = ParamLayout(name=entry.name, path=entry.path,
                          flax_shape=entry.shape, spec=spec,
                          port_dims=entry.dims)
        dims = {axis: _flax_dim(spec, axis)
                for axis in (AXIS_TP, AXIS_EP, AXIS_FSDP)}
        dims = {k: None if d is None else lay.port_dim(d)
                for k, d in dims.items()}
        zero_dim = zero_split = None
        if zero_plan is not None:
            plan_entry = zero_plan.match(entry.path, entry.shape)
            if plan_entry is not None and plan_entry.dim is not None:
                zero_dim, zero_split = lay.view_dim(plan_entry.dim)
        out[entry.name] = dataclasses.replace(
            lay, tp_dim=dims[AXIS_TP], ep_dim=dims[AXIS_EP],
            fsdp_dim=dims[AXIS_FSDP], zero_dim=zero_dim,
            zero_split=zero_split)
    return out
