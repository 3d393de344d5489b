"""Lay a model's parameters out on the mesh, and the collectives of a
step over that layout.

The JAX package declares each parameter's spec (`tp_rules.combined_spec`,
and the ZeRO plan's dp dim) and XLA inserts the collectives.  Here
`Sharding` applies the same specs, carried onto the port's tensors by
`models/convert.flax_param_map`, by hand:

  * tp: every parameter with a tp dim is cut to this rank's slice, and the
    modules get their tensor-parallel group (`models/transformer.py`:
    column- and row-parallel products, the vocab-sharded embedding);
  * ep: each mixture-of-experts layer's experts are cut to this rank's
    E / ep, and the layer gets the ep group (`parallel/moe.py`); every
    MoE layer also gets the groups that split the batch's tokens (sp, and
    the data axes), over which it routes the global batch;
  * fsdp: FSDP2's `fully_shard`, one unit per block and one for the rest,
    on the fsdp axis's sub-mesh, each parameter sharded on the dim its
    spec gives (all-gathered before use, its gradient reduce-scattered, in
    f32: FSDP2 casts nothing, the modules cast per use as before);
  * ZeRO over dp: the optimizer updates this rank's slice of each entry
    with a dp dim (`train/zero.py`); where the plan's dim is a head_dim
    inside the port's merged [heads * head_dim], the slice, its gradient's
    reduce-scatter and the all-gather run on the view that splits the
    merged dim (`tp_rules.ParamLayout.zero_split`), on the local shard
    FSDP2 and tp leave.

Whenever the mesh names tp or fsdp, even at size 1, the machinery runs
(a 1-way slice is the whole tensor and a 1-rank collective copies), so a
one-card run goes through it with the plain run's numbers.

After the backward `reduce_grads` sums each gradient exactly once over the
axes that split the batch (`split_axes`: dp, fsdp and, for the
transformers, whose ranks of sp hold slices of the sequence, sp) and never
over tp, ep or pp (ResNet's ranks along sp, tp, ep or pp, the encoders'
along ep or pp and the LM's along pp replicate the step, as in the JAX
workloads): FSDP2 has
summed it over fsdp (its divide factor set to 1: the step scales the
loss), ZeRO reduce-scatters it over dp, and the rest is one flat
all-reduce per set of axes.  The row-parallel biases, whose gradient only tp rank 0 holds, are
summed over tp as well.  `gather` joins a parameter's or moment's pieces
into the whole tensor (`train/state.full_state`, for a checkpoint) and
`cut` takes this rank's piece of one (`load_full_state`), whatever mesh
wrote it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..train.zero import all_gather_along, reduce_scatter_along, slice_along
from .dist import TPGroup
from .mesh import AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_SP, AXIS_TP, \
    data_axes

DATA_AXES = (AXIS_DP, AXIS_FSDP, AXIS_SP)


def local(t):
    """The tensor this rank holds of a parameter, gradient or moment (a
    DTensor's local shard)."""
    return t.to_local() if hasattr(t, "to_local") else t


class Sharding:
    """The layout of `model`'s parameters on `mesh` (laid over the process
    group), applied to the model on construction."""

    def __init__(self, model, mesh, zero_plan=None) -> None:
        from ..models.transformer import BertEncoder, TransformerLM
        from ..models.vit import ViT
        from .tp_rules import param_layouts, tp_rule_dim

        self.mesh, self.zero_plan = mesh, zero_plan
        # the axes that split the batch, and the group the step sums the
        # loss over; the LM's batch is the shifted window [B, T + 1]
        # (`train/step.shard_sequence`)
        self.shifted_tokens = isinstance(model, TransformerLM)
        self.split_axes = tuple(
            a for a in (DATA_AXES if isinstance(
                model, (TransformerLM, BertEncoder, ViT))
                        else (AXIS_DP, AXIS_FSDP))
            if a in mesh.axis_names)
        self.layouts = param_layouts(model, mesh, zero_plan)
        self.params = dict(model.named_parameters())
        self.tp = (TPGroup(mesh.group(AXIS_TP), mesh.coordinate(AXIS_TP),
                           mesh.shape[AXIS_TP])
                   if AXIS_TP in mesh.axis_names else None)
        # the tp dims this rank slices: the spec's, or at tp 1 every dim a
        # rule names (a 1-way slice, so the tensor-parallel code runs)
        self.tp_dims: Dict[str, int] = {}
        if self.tp is not None:
            for name, lay in self.layouts.items():
                if lay.tp_dim is not None:
                    self.tp_dims[name] = lay.tp_dim
                elif self.tp.size == 1:
                    _, dim = tp_rule_dim("/".join(lay.path), lay.flax_shape,
                                         1)
                    if dim is not None:
                        self.tp_dims[name] = lay.port_dim(dim)
        self.partial_tp: set = set()
        if self.tp_dims:
            self._apply_tp(model)
        self.ep = (TPGroup(mesh.group(AXIS_EP), mesh.coordinate(AXIS_EP),
                           mesh.shape[AXIS_EP])
                   if AXIS_EP in mesh.axis_names else None)
        self.ep_dims: Dict[str, int] = {}
        self._apply_moe(model)
        self.fsdp_dims: Dict[str, int] = {}
        if AXIS_FSDP in mesh.axis_names:
            self._apply_fsdp(model)
            self.params = dict(model.named_parameters())
        self._build_zero()
        # the axes each gradient is all-reduced over after the backward,
        # and their groups (made here, in the same order on every rank)
        self.reduce_axes: Dict[str, Tuple[str, ...]] = {}
        for name in self.params:
            axes = list(self.split_axes)
            if name in self.fsdp_dims:
                axes.remove(AXIS_FSDP)
            if name in self.zero_dims:
                axes.remove(AXIS_DP)
            if name in self.partial_tp:
                axes.append(AXIS_TP)
            self.reduce_axes[name] = tuple(axes)
        self.groups = {axes: mesh.group_over(axes)
                       for axes in dict.fromkeys(self.reduce_axes.values())
                       if axes}
        self.loss_group = mesh.group_over(self.split_axes)

    # ------------------------------------------------------------------
    # applying the layout

    def _apply_tp(self, model) -> None:
        """Cut the tp slices, and wire the blocks' attention and MLP
        (column- then row-parallel) and the vocab-sharded token embedding
        (the LM's `wte`, tied to its readout; BERT's `tok_emb`, a lookup
        alone) to the tp group."""
        from ..models.transformer import MLP, SelfAttention

        group = self.tp.group
        with torch.no_grad():
            for name, dim in self.tp_dims.items():
                p = self.params[name]
                p.data = slice_along(p.data, dim, group).clone()
        for prefix, module in model.named_modules():
            pre = prefix + "." if prefix else ""
            if isinstance(module, SelfAttention):
                q = pre + "query.weight"
                kv = [pre + f"{n}.weight" for n in ("key", "value")]
                if q not in self.tp_dims:
                    continue
                if any(k not in self.tp_dims for k in kv):
                    raise ValueError(
                        f"{prefix}: the query heads shard over tp="
                        f"{self.tp.size} but the KV heads "
                        f"({module.kv_heads}) do not divide by it")
                module.tp = self.tp
                self.partial_tp.add(pre + "out.bias")
            elif isinstance(module, MLP):
                if pre + "wi.weight" in self.tp_dims:
                    module.tp = self.tp
                    self.partial_tp.add(pre + "wo.bias")
        if {"wte.weight", "tok_emb.weight"} & set(self.tp_dims):
            model.vocab_tp = self.tp
        self.partial_tp &= set(self.params)

    def _apply_moe(self, model) -> None:
        """Cut the experts over ep (at ep 1, a 1-way slice of every expert
        weight) and hand each MoE layer its ep group and the groups that
        split the batch's tokens."""
        from .moe import MoEMLP
        from .tp_rules import ep_rule_dim

        layers = [(prefix, m) for prefix, m in model.named_modules()
                  if isinstance(m, MoEMLP)]
        if not layers:
            return
        if self.ep is not None:
            for name, lay in self.layouts.items():
                if lay.ep_dim is not None:
                    self.ep_dims[name] = lay.ep_dim
                elif self.ep.size == 1:
                    dim = ep_rule_dim("/".join(lay.path))
                    if dim is not None:
                        self.ep_dims[name] = lay.port_dim(dim)
            with torch.no_grad():
                for name, dim in self.ep_dims.items():
                    p = self.params[name]
                    p.data = slice_along(p.data, dim, self.ep.group).clone()
        groups = []
        if AXIS_SP in self.mesh.axis_names:
            groups.append((self.mesh.group(AXIS_SP), 1))
        if data_axes(self.mesh):
            groups.append((self.mesh.group_over(data_axes(self.mesh)), 0))
        for prefix, layer in layers:
            layer.token_groups = tuple(groups)
            if prefix + ".wi" in self.ep_dims:
                layer.ep = self.ep

    def _apply_fsdp(self, model) -> None:
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        size = self.mesh.shape[AXIS_FSDP]
        for name, lay in self.layouts.items():
            if lay.fsdp_dim is not None:
                self.fsdp_dims[name] = lay.fsdp_dim
            elif size == 1:
                self.fsdp_dims[name] = 0  # a 1-way shard is the whole tensor
        by_id = {id(p): name for name, p in self.params.items()}
        ignored = {p for name, p in self.params.items()
                   if name not in self.fsdp_dims}

        def placement(p):
            return Shard(self.fsdp_dims[by_id[id(p)]])

        sub_mesh = self.mesh.device_mesh[AXIS_FSDP]
        kwargs = dict(mesh=sub_mesh, shard_placement_fn=placement)
        if ignored:
            kwargs["ignored_params"] = ignored
        units = list(getattr(model, "blocks", ()))
        for unit in units + [model]:
            fully_shard(unit, **kwargs)
        for unit in units + [model]:
            # the step scales the loss; FSDP2 must sum, not average
            unit.set_gradient_divide_factor(1.0)
            if hasattr(unit, "set_force_sum_reduction_for_comms"):
                unit.set_force_sum_reduction_for_comms(True)

    def after_load(self) -> None:
        """Cut the ZeRO slices again from parameters loaded in place."""
        group = self.mesh.group(AXIS_DP) if self.slices else None
        with torch.no_grad():
            for name, s in self.slices.items():
                s.copy_(slice_along(self._zero_view(name, self.params[name]),
                                    self.zero_dims[name], group))

    def _build_zero(self) -> None:
        """The slices the optimizer updates for the entries with a dp dim
        (ZeRO over dp > 1; at dp 1 the update runs dense)."""
        self.zero_dims: Dict[str, int] = {}
        self.zero_splits: Dict[str, Tuple[int, int]] = {}
        self.slices: Dict[str, torch.Tensor] = {}
        if self.zero_plan is None or self.mesh.shape.get(AXIS_DP, 1) <= 1:
            return
        group = self.mesh.group(AXIS_DP)
        for name, lay in self.layouts.items():
            if lay.zero_dim is None:
                continue
            self.zero_dims[name] = lay.zero_dim
            if lay.zero_split is not None:
                self.zero_splits[name] = lay.zero_split
            with torch.no_grad():
                self.slices[name] = slice_along(
                    self._zero_view(name, self.params[name]), lay.zero_dim,
                    group).clone()

    def _zero_view(self, name: str, t):
        """This rank's tensor of `name` as the ZeRO slice is cut from it:
        itself, or the view that splits its merged [heads * head_dim]."""
        t, split = local(t), self.zero_splits.get(name)
        return t if split is None else t.unflatten(split[0], (-1, split[1]))

    def _zero_unview(self, name: str, t):
        split = self.zero_splits.get(name)
        return t if split is None else t.flatten(split[0], split[0] + 1)

    # ------------------------------------------------------------------
    # what the optimizer sees

    def opt_named(self) -> List[Tuple[str, torch.Tensor]]:
        """(name, tensor) the optimizer updates: each parameter, or its
        ZeRO slice."""
        return [(name, self.slices.get(name, p))
                for name, p in self.params.items()]

    def shard_groups(self) -> List[tuple]:
        """For each tensor of `opt_named`, the groups its elements are
        split over (its gradient's global norm sums over them)."""
        out = []
        for name in self.params:
            axes = []
            if name in self.tp_dims and self.tp.size > 1:
                axes.append(AXIS_TP)
            if name in self.ep_dims and self.ep.size > 1:
                axes.append(AXIS_EP)
            if name in self.fsdp_dims and self.mesh.shape[AXIS_FSDP] > 1:
                axes.append(AXIS_FSDP)
            if name in self.zero_dims:
                axes.append(AXIS_DP)
            out.append(tuple(self.mesh.group(a) for a in axes))
        return out

    # ------------------------------------------------------------------
    # the step's collectives

    def reduce_grads(self) -> None:
        """Sum every gradient once over the data and sequence axes (and a
        row-parallel bias's over tp); the ZeRO entries' sums land, as this
        rank's slice, in their slice's `.grad`."""
        grads: Dict[str, torch.Tensor] = {}
        for name, p in self.params.items():
            g = None if p.grad is None else local(p.grad)
            if g is None:
                g = torch.zeros_like(local(p))
            if name in self.zero_dims:
                g = reduce_scatter_along(self._zero_view(name, g),
                                         self.zero_dims[name],
                                         self.mesh.group(AXIS_DP))
                self.slices[name].grad = g
                p.grad = None
            elif p.grad is None:
                p.grad = g  # a plain parameter; FSDP2 always sets one
            grads[name] = g
        for axes, group in self.groups.items():
            names = [n for n, a in self.reduce_axes.items() if a == axes]
            flat = torch.cat([grads[n].reshape(-1) for n in names])
            dist.all_reduce(flat, group=group)
            offset = 0
            for n in names:
                g = grads[n]
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def after_update(self) -> None:
        """All-gather the updated ZeRO slices back into the parameters."""
        if not self.slices:
            return
        group = self.mesh.group(AXIS_DP)
        with torch.no_grad():
            for name, s in self.slices.items():
                self._zero_view(name, self.params[name]).copy_(
                    all_gather_along(s, self.zero_dims[name], group))

    # ------------------------------------------------------------------
    # whole tensors for checkpoints

    def _axes_dims(self, name: str):
        """(axis, port dim) this rank's piece of `name` is cut along: fsdp,
        tp, ep (the ZeRO slice is cut from that piece)."""
        out = []
        if name in self.fsdp_dims and self.mesh.shape[AXIS_FSDP] > 1:
            out.append((AXIS_FSDP, self.fsdp_dims[name]))
        if name in self.tp_dims and self.tp.size > 1:
            out.append((AXIS_TP, self.tp_dims[name]))
        if name in self.ep_dims and self.ep.size > 1:
            out.append((AXIS_EP, self.ep_dims[name]))
        return out

    def gather(self, name: str, t, zero: bool = False):
        """The whole tensor of which `t` is this rank's piece (with `zero`,
        its ZeRO slice)."""
        t = local(t).detach()
        if zero and name in self.zero_dims:
            t = self._zero_unview(name, all_gather_along(
                t, self.zero_dims[name], self.mesh.group(AXIS_DP)))
        for axis, dim in self._axes_dims(name):
            t = all_gather_along(t, dim, self.mesh.group(axis))
        return t

    def cut(self, name: str, full, zero: bool = False):
        """This rank's piece of the whole tensor `full` (with `zero`, its
        ZeRO slice)."""
        for axis, dim in reversed(self._axes_dims(name)):
            full = slice_along(full, dim, self.mesh.group(axis))
        if zero and name in self.zero_dims:
            full = slice_along(self._zero_view(name, full),
                               self.zero_dims[name], self.mesh.group(AXIS_DP))
        return full.contiguous()

    def is_zero(self, name: str) -> bool:
        return name in self.zero_dims

    def held_specs(self) -> Dict[str, tuple]:
        """{port name: its spec on the flax dims}, read back from what this
        rank holds (the tp slices and the placements FSDP2 keeps) through
        the flax map: the spec the JAX package gives the parameter."""
        out = {}
        for name, lay in self.layouts.items():
            held = {}
            if name in self.tp_dims and self.tp.size > 1:
                held[AXIS_TP] = self.tp_dims[name]
            if name in self.ep_dims and self.ep.size > 1:
                held[AXIS_EP] = self.ep_dims[name]
            if self.mesh.shape.get(AXIS_FSDP, 1) > 1:
                for placement in getattr(self.params[name], "placements", ()):
                    if hasattr(placement, "dim"):
                        held[AXIS_FSDP] = placement.dim
            out[name] = lay.flax_spec(held, self.mesh)
        return out
