"""The train step's collective inventory, its four rules and its manifest.

The counterpart of `tf_operator_tpu/analysis/hlo.py`, which lints the XLA
program the JAX train step compiles to.  PyTorch compiles no program: what
the port's step "is", for these rules, is what one step issues through
`torch.distributed` and the tensors each rank holds after it.  ZeRO
("Automatic Cross-Replica Sharding of Weight Update", arXiv:2004.13336)
only pays off when the step issues the right collectives (a gradient
reduction, one weight-update all-gather per sharded entry) and the rank
holds its optimizer moments at the plan's shard shapes; and admission
(arXiv:2210.07297) needs a per-rank memory figure it can trust.

The pipeline:

  capture   build the real train step of a workload (`capture_workload`:
            the port's model, optimizer recipe, `create_train_state` with
            the ZeRO plan of `train/zero.plan_for_model` over {"dp": N},
            `make_train_step`), run one step unrecorded (the optimizer's
            moments appear, the kernels build), then record the next one;
  record    `CollectiveRecorder` wraps `torch.distributed`'s collective
            entry points for the recorded step: kind, operand and result
            shapes and dtypes, bytes, group size, `async_op`, the caller's
            file:line, and the async works never waited on; what the step
            issued past the wrappers (`DispatchedCollectives` counts it)
            makes the capture raise, and so does a rank whose inventory
            differs from rank 0's;
  layout    the shape and dtype of every tensor the rank holds after the
            step (parameters, optimizer moments, BatchNorm statistics, the
            batch), the parameters' and moments' carried onto the flax
            layout (`models/convert.flax_param_map`), where the ZeRO plan
            and its expected shard shapes live;
  check     the four rules (`check_capture`) against the plan:
              hlo-plan-drift           one weight-update all-gather per
                                       dim-sharded plan entry, and a
                                       gradient reduction (all-reduce or
                                       reduce-scatter);
              hlo-replicated-optstate  the moments at the plan's shard
                                       shapes;
              hlo-sync-collective      a plan entry marked overlappable
                                       (`ZeroShardingPlan.with_overlap`)
                                       whose gather ran with async_op=False;
              hlo-memory-infeasible    the peak over a declared budget;
  snapshot  a per-workload signature of what does not vary between runs,
            committed as `analysis/collective-manifest.json` and
            diff-gated by `--diff`.

`python -m tf_operator_tpu_torch.analysis --hlo ...` starts N ranks
through the pod launcher (`workloads/launch.spawn`), one process per
device as the workloads run, and each joins the group in `run_hlo`
(`runner.process_group`): on CUDA one GPU per rank over NCCL, where the
peak is `torch.cuda.max_memory_allocated` over a plain step; on the
CPU under TPUJOB_FORCE_PLATFORM=cpu gloo ranks, as the JAX package's
`--hlo` lowers onto N virtual CPU devices, where the peak is only the
resident bytes.  The workloads are captured at the JAX package's tiny
shapes, or (`full_width`, `chip_smoke.py`'s hlo phase) from each
workload's own `build` at its defaults.  The admission math at the end is
plain Python.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import inspect
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..workloads.runner import WorkloadParts

RULE_HLO_PLAN_DRIFT = "hlo-plan-drift"
RULE_HLO_REPLICATED_OPTSTATE = "hlo-replicated-optstate"
RULE_HLO_SYNC_COLLECTIVE = "hlo-sync-collective"
RULE_HLO_MEMORY_INFEASIBLE = "hlo-memory-infeasible"

HLO_RULES = (
    RULE_HLO_PLAN_DRIFT,
    RULE_HLO_REPLICATED_OPTSTATE,
    RULE_HLO_SYNC_COLLECTIVE,
    RULE_HLO_MEMORY_INFEASIBLE,
)

HLO_MANIFEST_VERSION = 1
HLO_MANIFEST_SCHEMA = "tf-operator-tpu-torch/collective-manifest"

# The four train-path workloads (--hlo all).
TRAIN_WORKLOADS = ("lm", "resnet", "bert", "vit")

DEFAULT_DEVICES = 4

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# torch dtypes under the names the JAX package's HLO gives them
_TORCH_TO_HLO = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64",
}

Shape = Tuple[str, Tuple[int, ...]]  # (dtype, dims)


def shape_bytes(shape: Shape) -> int:
    n = 1
    for d in shape[1]:
        n *= d
    return n * _DTYPE_BYTES.get(shape[0], 4)


def tensor_shape(t) -> Shape:
    """A tensor's dtype, under its HLO name (f32, bf16, s32, ...), and
    dims."""
    return (_TORCH_TO_HLO.get(t.dtype, str(t.dtype)),
            tuple(int(d) for d in t.shape))


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective the step issued (on this rank)."""

    kind: str                 # all-reduce | reduce-scatter | all-gather | ...
    name: str                 # the entry point and its index, e.g. all_reduce.3
    result_shapes: Tuple[Shape, ...]
    operand_shapes: Tuple[Shape, ...]
    bytes_moved: int          # result payload bytes (per rank)
    num_groups: int           # groups of this size the world splits into
    group_size: int           # ranks per group
    asynchronous: bool        # async_op=True (point-to-point: always)
    op_name: str = ""         # the caller's file:line in the port


@dataclasses.dataclass(frozen=True)
class MemoryStats:
    """The rank's memory in a step.  `resident_bytes`: the tensors it
    holds after the recorded step (the state of `HloProgram.resident` and
    the gradients it keeps).  `peak_bytes`: on CUDA
    `torch.cuda.max_memory_allocated()` over a plain step before it, less
    what the process held before the workload was built; on the CPU the
    resident bytes, a lower bound of the peak (no activation, no
    temporary)."""

    resident_bytes: int
    peak_bytes: int
    device: str               # "cuda" | "cpu"


@dataclasses.dataclass(frozen=True)
class HloProgram:
    """What one train step is to the rules: the collectives it issued, in
    order, and the state the rank holds after it (parameters, optimizer
    moments, buffers, the batch; parameters and moments in the flax
    layout), the counterpart of the compiled module's ENTRY parameters."""

    collectives: Tuple[CollectiveOp, ...]
    resident: Tuple[Shape, ...]
    unpaired_starts: int             # async works the step never waited on
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def by_kind(self, kind: str) -> Tuple[CollectiveOp, ...]:
        return tuple(op for op in self.collectives if op.kind == kind)


# ---------------------------------------------------------------------------
# The recorder

# entry point -> (kind, operand argument, result argument)
_ENTRY_POINTS = {
    "all_reduce": ("all-reduce", "tensor", "tensor"),
    "reduce_scatter_tensor": ("reduce-scatter", "input", "output"),
    "all_gather_into_tensor": ("all-gather", "input_tensor", "output_tensor"),
    "all_gather": ("all-gather", "tensor", "tensor_list"),
    "all_to_all_single": ("all-to-all", "input", "output"),
    "broadcast": ("broadcast", "tensor", "tensor"),
    "isend": ("collective-permute", "tensor", None),
    "irecv": ("collective-permute", None, "tensor"),
    "batch_isend_irecv": ("collective-permute", None, None),
}

# the c10d op DispatchedCollectives counts for each (send/recv are not
# counted)
_C10D_OPS = {
    "all_reduce": "c10d.allreduce_",
    "reduce_scatter_tensor": "c10d._reduce_scatter_base_",
    "all_gather_into_tensor": "c10d._allgather_base_",
    "all_gather": "c10d.allgather_",
    "all_to_all_single": "c10d.alltoall_base_",
    "broadcast": "c10d.broadcast_",
}

# The collective ops a step can dispatch (by namespace, then name), as
# `torch.distributed.tensor.debug.CommDebugMode` counts them: c10d's, and the
# functional collectives (the native namespace's ops under the Python
# one's names).
_DISPATCHED = {
    "c10d": {"_allgather_base_", "_reduce_scatter_base_", "allgather_",
             "allgather_coalesced_", "allgather_into_tensor_coalesced_",
             "allreduce_", "allreduce_coalesced_", "alltoall_",
             "alltoall_base_", "broadcast_", "gather_", "scatter_", "reduce_",
             "reduce_scatter_", "reduce_scatter_tensor_coalesced_"},
    "c10d_functional": {"all_gather_into_tensor",
                        "all_gather_into_tensor_coalesced", "all_reduce",
                        "all_reduce_coalesced", "all_to_all_single",
                        "broadcast", "reduce_scatter_tensor",
                        "reduce_scatter_tensor_coalesced"},
    "_dtensor": {"shard_dim_alltoall"},
}
_FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd")

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tensors(value) -> tuple:
    if value is None:
        return ()
    if torch.is_tensor(value):
        return (value,)
    return tuple(value)


def _caller() -> str:
    """file:line of the innermost frame outside torch and this module."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not path.startswith(_TORCH_DIR) and path != os.path.abspath(
                __file__):
            if path.startswith(_REPO_DIR + os.sep):
                path = os.path.relpath(path, _REPO_DIR)
            return f"{path.replace(os.sep, '/')}:{frame.f_lineno}"
        frame = frame.f_back
    return ""


class _Waited:
    """An async work whose `wait` the recorder sees."""

    def __init__(self, work, waited: list) -> None:
        self._work, self._waited = work, waited

    def wait(self, *args, **kwargs):
        self._waited[0] = True
        return self._work.wait(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._work, name)


class DispatchedCollectives(TorchDispatchMode):
    """While active, counts the collective ops the step dispatches, by
    `str(op)` (`c10d.allreduce_`, ...): what `CommDebugMode` counts,
    without its module tracker.  That tracker hangs autograd hooks on the
    step's tensors and keeps each module's parameters in a dict, and the
    hooks close a cycle through the autograd graph (C++, which `gc` does
    not see): after a capture the model's parameters and their gradients
    stayed allocated until the process ended (ROADMAP C.4)."""

    supports_higher_order_operators = True

    def __init__(self) -> None:
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.counts: collections.Counter = collections.Counter()
        self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        # a DTensor desugars into plain ops, its collectives among them,
        # which come back through the mode
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        space, _, name = str(func._overloadpacket).rpartition(".")
        if space in _FUNCTIONAL:
            space = "c10d_functional"
        if name in _DISPATCHED.get(space, ()):
            self.counts[f"{space}.{name}"] += 1
        return out


class CollectiveRecorder:
    """While active, every collective that `torch.distributed`'s entry
    points issue (`_ENTRY_POINTS`) is recorded as a `CollectiveOp`, in
    call order, from whichever thread issued it (autograd's included);
    a call made inside another recorded one (`batch_isend_irecv`'s sends)
    is part of it.  The entry points are restored on exit.  Beside the
    wrappers `DispatchedCollectives` counts the collective ops the step
    dispatched; on a clean exit any difference between its counts and the
    wrappers' (a collective that went past them, such as a functional
    collective or a function bound before the recorder started) raises."""

    def __init__(self) -> None:
        self.ops: List[CollectiveOp] = []
        self._waits: List[list] = []
        self._c10d: collections.Counter = collections.Counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._saved: List[tuple] = []
        self._comm = None

    @property
    def unpaired_starts(self) -> int:
        return sum(1 for waited in self._waits if not waited[0])

    def __enter__(self) -> "CollectiveRecorder":
        from torch.distributed import distributed_c10d as c10d

        if getattr(c10d.all_reduce, "_recorder", None) is not None:
            raise RuntimeError("a CollectiveRecorder is already recording")
        try:
            for name in _ENTRY_POINTS:
                original = getattr(c10d, name)
                wrapper = self._wrap(name, original)
                # the package's name and c10d's own (P2POp checks its op
                # against c10d.isend / c10d.irecv)
                for module in (dist, c10d):
                    if getattr(module, name, None) is original:
                        self._saved.append((module, name, original))
                        setattr(module, name, wrapper)
            self._comm = DispatchedCollectives()
            self._comm.__enter__()
        except BaseException:
            self._restore()
            raise
        return self

    def _restore(self) -> None:
        for module, name, original in reversed(self._saved):
            setattr(module, name, original)
        self._saved.clear()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self._comm.__exit__(exc_type, exc, tb)
        finally:
            self._restore()
        if exc_type is None:
            self._cross_check()

    def _wrap(self, name: str, fn):
        signature = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if getattr(self._local, "inside", False):
                return fn(*args, **kwargs)
            self._local.inside = True
            try:
                out = fn(*args, **kwargs)
            finally:
                self._local.inside = False
            return self._record(name, signature.bind(*args, **kwargs), out)

        wrapper._recorder = self
        return wrapper

    def _record(self, name: str, bound, out):
        kind, operand_arg, result_arg = _ENTRY_POINTS[name]
        args = bound.arguments
        if name == "batch_isend_irecv":
            p2p = list(args["p2p_op_list"])
            sends = [op.tensor for op in p2p if op.op.__name__ == "isend"]
            recvs = [op.tensor for op in p2p if op.op.__name__ == "irecv"]
            group, asynchronous = p2p[0].group, True
        else:
            sends = _tensors(args.get(operand_arg)) if operand_arg else ()
            recvs = _tensors(args.get(result_arg)) if result_arg else ()
            group = args.get("group")
            asynchronous = name in ("isend", "irecv") or bool(
                args.get("async_op", False))
        group_size = dist.get_world_size(group)
        results = tuple(tensor_shape(t) for t in recvs)
        works = [] if out is None else out if isinstance(out, list) \
            else [out]
        wrapped = [_Waited(work, [False]) for work in works]
        with self._lock:
            self._waits += [w._waited for w in wrapped]
            if name in _C10D_OPS:
                self._c10d[_C10D_OPS[name]] += 1
            self.ops.append(CollectiveOp(
                kind=kind,
                name=f"{name}.{len(self.ops)}",
                result_shapes=results,
                operand_shapes=tuple(tensor_shape(t) for t in sends),
                bytes_moved=sum(shape_bytes(s) for s in results),
                num_groups=max(1, dist.get_world_size() // group_size),
                group_size=group_size,
                asynchronous=asynchronous,
                op_name=_caller(),
            ))
        if out is None:
            return None
        return wrapped if isinstance(out, list) else wrapped[0]

    def _cross_check(self) -> None:
        seen = +self._comm.counts
        if seen != self._c10d:
            raise RuntimeError(
                "collectives went past the recorder's wrappers of "
                f"torch.distributed: the dispatch counted {dict(seen)}, "
                f"the wrappers {dict(self._c10d)} (a functional collective, "
                "FSDP2's, or an entry point bound before the recording "
                "started)")


# ---------------------------------------------------------------------------
# The resident layout, in the flax layout of the plan


def flax_dims(param, shape) -> Tuple[int, ...]:
    """`shape`, a tensor of port parameter `param` (a
    `models/convert.FlaxParam`) or of its optimizer state, on the flax
    dims: each flax dim read from the port dim that holds it, a head_dim
    inside the port's merged [heads * head_dim] whole (heads are what tp
    and ZeRO cut there), or from the view that splits that dim in two
    (`Sharding._zero_view`, one dim more than the parameter).  A shape
    in neither layout comes back as it is."""
    shape = tuple(int(d) for d in shape)
    dims = param.dims
    ndim = len({d for d in dims if d is not None})
    merged = next((i for i in range(len(dims) - 1)
                   if dims[i] is not None and dims[i + 1] is None), None)
    if len(shape) == ndim + 1 and merged is not None:
        split = dims[merged]

        def view(d):
            if d is None:
                return split + 1
            return d + 1 if d > split else d

        return tuple(shape[view(d)] for d in dims)
    if len(shape) != ndim:
        return shape
    out = []
    for i, d in enumerate(dims):
        if d is None or param.shape[i] == 1:
            out.append(param.shape[i])
        elif i == merged:
            out.append(shape[d] // param.shape[i + 1])
        else:
            out.append(shape[d])
    return tuple(out)


def _flax_shape(param, t) -> Shape:
    dims = tuple(t.shape) if param is None else flax_dims(param, t.shape)
    return (tensor_shape(t)[0], tuple(int(d) for d in dims))


def _opt_named(state):
    if state.sharding is None:
        return list(state.model.named_parameters())
    return state.sharding.opt_named()


def resident_layout(state, batch) -> Tuple[Tuple[Shape, ...], int]:
    """(the state this rank holds, in the flax layout where a parameter's;
    the bytes of the gradients it holds beside it)."""
    from ..models.convert import flax_param_map
    from ..parallel.shard import local

    params = {e.name: e for e in flax_param_map(state.model)}
    out = [_flax_shape(params.get(name), local(p))
           for name, p in state.model.named_parameters()]
    grad_bytes = 0
    for name, t in _opt_named(state):
        if t.grad is not None:
            grad_bytes += shape_bytes(tensor_shape(local(t.grad)))
        for value in state.optimizer.state.get(t, {}).values():
            if torch.is_tensor(value):
                out.append(_flax_shape(params.get(name), local(value)))
    out += [tensor_shape(b) for _, b in state.model.named_buffers()]
    out += [tensor_shape(v) for v in batch.values()]
    return tuple(out), grad_bytes


def _inventory(program: HloProgram) -> list:
    return [(op.kind, op.operand_shapes, op.result_shapes, op.group_size)
            for op in program.collectives]


def same_inventory(inventories: Sequence[list]) -> None:
    """Raise unless every rank's ordered inventory (kinds, shapes, dtypes,
    group sizes) is rank 0's: an SPMD program issues one sequence, and a
    torch step that diverges across ranks hangs or sums the wrong
    tensors."""
    for rank, mine in enumerate(inventories):
        if mine == inventories[0]:
            continue
        first = next((i for i, (a, b) in enumerate(zip(mine, inventories[0]))
                      if a != b), min(len(mine), len(inventories[0])))
        theirs = inventories[0][first] if first < len(inventories[0]) \
            else None
        ours = mine[first] if first < len(mine) else None
        raise RuntimeError(
            f"rank {rank} issued {len(mine)} collective(s) and rank 0 "
            f"{len(inventories[0])}; they part at #{first}: rank 0 "
            f"{theirs}, rank {rank} {ours}")


def capture_program(step, state, batch,
                    base_bytes: int = 0) -> Tuple[HloProgram, MemoryStats]:
    """Run `step(state, batch)` once unrecorded (the optimizer's lazy
    moments appear, the kernels build); on CUDA run a second, plain step
    for the peak, less `base_bytes`, what the process held before the
    workload was built (earlier captures' leftovers are not this step's);
    then record the next step: its collectives, the kernels it launched,
    the state after it (`MemoryStats`' resident bytes).  The peak is not
    read over the recorded step, which the recorder runs.
    Every rank of the group calls it; their inventories must agree
    (`same_inventory`)."""
    from ..ops import attention
    from ..parallel.shard import local

    device = local(next(state.model.parameters())).device
    cuda = device.type == "cuda"
    step(state, batch)
    peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        step(state, batch)
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base_bytes
    before = attention.launches()
    with CollectiveRecorder() as recorder:
        step(state, batch)
        if cuda:
            torch.cuda.synchronize(device)
    launched = {k: v - before[k] for k, v in attention.launches().items()}
    resident, grad_bytes = resident_layout(state, batch)
    program = HloProgram(
        collectives=tuple(recorder.ops), resident=resident,
        unpaired_starts=recorder.unpaired_starts, kernel_launches=launched)
    resident_bytes = sum(shape_bytes(s) for s in resident) + grad_bytes
    memory = MemoryStats(
        resident_bytes=resident_bytes,
        peak_bytes=peak if cuda else resident_bytes,
        device=device.type)
    if dist.is_initialized() and dist.get_world_size() > 1:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, _inventory(program))
        same_inventory(every)
    return program, memory


# ---------------------------------------------------------------------------
# The plan's expectations


@dataclasses.dataclass(frozen=True)
class PlanPair:
    """One sharded plan entry's weight-update transfer: the step must
    gather `shard_dims` back to `base_dims` each step, in the layout
    `train/zero.all_gather_along` gathers (the plan's dim first, on the
    view that splits a merged [heads * head_dim])."""

    shard_dims: Tuple[int, ...]
    base_dims: Tuple[int, ...]
    overlap: bool
    path: Tuple[str, ...] = ()  # the flax path of the plan entry
    dtype: str = "f32"          # the parameter's, and its gradient's

    @property
    def grad_bytes(self) -> int:
        """The whole gradient the step must sum over dp for this entry."""
        return shape_bytes((self.dtype, self.base_dims))


def plan_update_pairs(model, mesh, plan) -> Tuple[PlanPair, ...]:
    """Per dim-sharded plan entry, the all-gather the ZeRO weight update
    owes (`parallel/shard.Sharding.after_update`), from the layout rules
    (`parallel/tp_rules.param_layouts`) and the rank's parameter."""
    from ..parallel.shard import local
    from ..parallel.tp_rules import param_layouts

    if plan is None:
        return ()
    params = dict(model.named_parameters())
    pairs = []
    for name, lay in param_layouts(model, mesh, plan).items():
        if lay.zero_dim is None:
            continue
        dims = list(local(params[name]).shape)
        if lay.zero_split is not None:
            at, head_dim = lay.zero_split
            dims[at:at + 1] = [dims[at] // head_dim, head_dim]
        base = [dims[lay.zero_dim]] + [d for i, d in enumerate(dims)
                                       if i != lay.zero_dim]
        shard = [base[0] // plan.num_shards] + base[1:]
        pairs.append(PlanPair(
            shard_dims=tuple(shard), base_dims=tuple(base),
            overlap=plan.match(lay.path, lay.flax_shape).overlap,
            path=lay.path, dtype=tensor_shape(params[name])[0]))
    return tuple(pairs)


def _cut(shape, spec, mesh) -> Tuple[int, ...]:
    from ..parallel.mesh import axis_size, spec_axes

    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for d, entry in zip(shape, entries):
        for axis in spec_axes(entry):
            d //= axis_size(mesh, axis)
        out.append(d)
    return tuple(out)


def expected_layout(model, mesh, plan, moments_per_param: int,
                    batch_shapes: Dict[str, Shape]) -> Tuple[Shape, ...]:
    """The planned per-rank state, in the flax layout: each parameter at
    its own spec (`tp_rules.combined_spec`), `moments_per_param` moments at
    the plan's spec (the parameter's without a plan entry), the buffers
    whole, and each leaf of the global batch `batch_shapes` cut over the
    data axes."""
    from ..models.convert import flax_param_map
    from ..parallel.mesh import axis_size, data_axes
    from ..parallel.tp_rules import combined_spec

    params = dict(model.named_parameters())
    out = []
    for e in flax_param_map(model):
        dtype = tensor_shape(params[e.name])[0]
        base = combined_spec("/".join(e.path), e.shape, mesh)
        entry = plan.match(e.path, e.shape) if plan is not None else None
        out.append((dtype, _cut(e.shape, base, mesh)))
        moment = (dtype, _cut(e.shape, entry.spec if entry else base, mesh))
        out += [moment] * moments_per_param
    out += [tensor_shape(b) for _, b in model.named_buffers()]
    ranks = int(np.prod([axis_size(mesh, a) for a in data_axes(mesh)]))
    for dtype, dims in batch_shapes.values():
        out.append((dtype, (dims[0] // ranks,) + tuple(dims[1:])))
    return tuple(out)


@dataclasses.dataclass
class HloCapture:
    """Everything the rules and the manifest need about one recorded
    train step."""

    workload: str
    num_devices: int
    zero: bool
    plan: Any                                  # ZeroShardingPlan | None
    program: HloProgram
    memory: Optional[MemoryStats]
    moments_per_param: int
    expected_args: Tuple[Shape, ...]           # planned per-rank layout
    update_pairs: Tuple[PlanPair, ...]         # sharded-entry gathers due
    opt_bytes_per_device: int                  # train/zero model estimate
    params_bytes_per_device: int
    anchor_file: str                           # abs path, for suppressions
    anchor_path: str                           # display path for findings
    anchor_line: int
    device_memory_budget_bytes: int = 0        # 0 = no declared budget
    n_params: int = 0                          # the whole model's


# -- the workloads at the reference's tiny shapes, or at full width --------
# Tiny: the JAX package's capture shapes (`tf_operator_tpu/analysis/
# hlo.py:_build_*`) on the workload's construction chain, as
# `runner.WorkloadParts` (one global batch, numpy, from seed 0).  Full
# width: the workload's own `build` at its flags' defaults, the parts its
# run trains.


def _tokens(rng, vocab: int, shape) -> np.ndarray:
    return rng.integers(0, vocab, shape, dtype=np.int32)


def _images(rng, n: int, size: int) -> np.ndarray:
    return rng.standard_normal((n, size, size, 3), dtype=np.float32)


def _tiny_lm(mesh, n):
    from ..models.transformer import TransformerConfig, TransformerLM
    from ..train.optim import lm_optimizer
    from ..train.step import lm_loss_fn

    cfg = TransformerConfig(
        vocab_size=128, num_layers=2, num_heads=2, d_model=32, d_ff=64,
        max_len=16, mesh=mesh)
    model = TransformerLM(cfg)
    batch = {"tokens": _tokens(np.random.default_rng(0), 128, (2 * n, 17))}
    return WorkloadParts(
        model=model, loss=lm_loss_fn(model), batches=iter([batch]),
        tx=lm_optimizer(1e-3, schedule="constant", warmup_steps=0,
                        total_steps=8),
        moments_per_param=2)


def _tiny_resnet(mesh, n):
    from ..models import resnet as resnet_lib
    from ..train.optim import sgd
    from ..train.step import classification_loss_fn

    rng = np.random.default_rng(0)
    # BatchNorm's sums over every data rank, as the workload's
    model = resnet_lib.ResNet18(
        num_classes=8, bn_group=dist.group.WORLD if n > 1 else None)
    batch = {"x": _images(rng, n, 32), "label": _tokens(rng, 8, (n,))}
    return WorkloadParts(
        model=model, loss=classification_loss_fn(model), tx=sgd(0.1, 0.9),
        batches=iter([batch]), moments_per_param=1)


def _tiny_bert(mesh, n):
    from ..models.transformer import BertEncoder, bert_base_config
    from ..train.optim import adamw
    from ..train.step import classification_loss_fn

    rng = np.random.default_rng(0)
    cfg = bert_base_config(num_layers=2, d_model=32, num_heads=2, d_ff=64,
                           max_len=16, mesh=mesh)
    model = BertEncoder(cfg, num_labels=2)
    batch = {"x": _tokens(rng, cfg.vocab_size, (n, 16)),
             "label": _tokens(rng, 2, (n,))}
    return WorkloadParts(
        model=model, loss=classification_loss_fn(model), tx=adamw(5e-5),
        batches=iter([batch]), moments_per_param=2)


def _tiny_vit(mesh, n):
    from ..models.vit import ViT, vit_base_config
    from ..train.optim import adamw
    from ..train.step import classification_loss_fn

    rng = np.random.default_rng(0)
    cfg = vit_base_config(num_layers=2, num_heads=2, d_model=32, d_ff=128,
                          max_len=(16 // 8) ** 2 + 1, mesh=mesh)
    model = ViT(cfg, num_classes=8, patch_size=8, image_size=16)
    batch = {"x": _images(rng, n, 16), "label": _tokens(rng, 8, (n,))}
    return WorkloadParts(
        model=model, loss=classification_loss_fn(model), tx=adamw(3e-4),
        batches=iter([batch]), moments_per_param=2)


_TINY = {
    "lm": _tiny_lm,
    "resnet": _tiny_resnet,
    "bert": _tiny_bert,
    "vit": _tiny_vit,
}


def _full_width(name: str, mesh):
    """Workload `name`'s own parts at its flags' defaults
    (`workloads/<name>.build`)."""
    import importlib

    module = importlib.import_module(f"..workloads.{name}", __package__)
    return module.build(module.parser().parse_args([]), mesh)


def group_device() -> torch.device:
    """The device of the initialized process group's ranks: this rank's
    card over NCCL, else the CPU (gloo)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass
class Built:
    """A workload's train step laid out over {"dp": N}, ready to capture."""

    model: Any
    state: Any
    loss: Any                        # loss(batch) -> (loss, aux)
    step: Any
    batch: Dict[str, torch.Tensor]   # this rank's shard, on its device
    batch_shapes: Dict[str, Shape]   # the global batch
    plan: Any
    moments_per_param: int
    base_bytes: int = 0              # the device's allocated bytes before


def build_workload(name: str, zero: bool = True, overlap: bool = False,
                   full_width: bool = False) -> Built:
    """Workload `name`'s model, train state and step over {"dp": N}, N the
    initialized process group's size, on its device, with the ZeRO plan
    of `train/zero.plan_for_model` when `zero` asks for it and dp > 1 (at
    dp 1 the update runs dense, as `workloads/runner.zero_plan_for_workload`
    runs it), every entry marked overlappable with `overlap`."""
    from ..parallel.mesh import build_mesh
    from ..train.state import create_train_state
    from ..train.step import make_train_step, shard_batch
    from ..train.zero import plan_for_model

    if name not in _TINY:
        raise ValueError(
            f"unknown workload {name!r} (expected one of {TRAIN_WORKLOADS})")
    device = group_device()
    base = (torch.cuda.memory_allocated(device) if device.type == "cuda"
            else 0)
    n = dist.get_world_size()
    mesh = build_mesh({"dp": n}, device_type=device.type)
    parts = _full_width(name, mesh) if full_width else _TINY[name](mesh, n)
    try:
        batch = next(parts.batches)
    finally:
        if hasattr(parts.batches, "close"):
            parts.batches.close()
    model = parts.model
    plan = None
    if zero and n > 1:
        plan = plan_for_model(model, mesh)
        if overlap:
            plan = plan.with_overlap()
    state = create_train_state(model, parts.tx, seed=0, device=device,
                               mesh=mesh, zero_plan=plan)
    mine = parts.on_device(
        {key: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for key, v in shard_batch(batch, state.sharding).items()})
    whole = parts.on_device({k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()})
    return Built(
        model=model, state=state, loss=parts.loss,
        step=make_train_step(parts.loss, mesh=mesh), batch=mine,
        batch_shapes={k: tensor_shape(v) for k, v in whole.items()},
        plan=plan, moments_per_param=parts.moments_per_param,
        base_bytes=base)


def capture_built(workload: str, built: Built, zero: bool,
                  device_memory_budget_bytes: int = 0) -> HloCapture:
    """Capture `built`'s step (`capture_program`) and what the plan
    expects of it; anchored nowhere yet (`capture_workload` anchors it at
    the workload, `capture_from_file` at the fixture)."""
    from ..models.convert import flax_param_map
    from ..parallel.shard import local
    from ..train.zero import opt_state_bytes_per_device

    state, plan = built.state, built.plan
    mesh = state.sharding.mesh
    program, memory = capture_program(built.step, state, built.batch,
                                      built.base_bytes)
    entries = flax_param_map(built.model)
    return HloCapture(
        workload=workload,
        num_devices=mesh.size,
        zero=zero,
        # the plan as a document: its mesh was laid over this group
        plan=None if plan is None else dataclasses.replace(plan, mesh=None),
        program=program,
        memory=memory,
        moments_per_param=built.moments_per_param,
        expected_args=expected_layout(built.model, mesh, plan,
                                      built.moments_per_param,
                                      built.batch_shapes),
        update_pairs=plan_update_pairs(built.model, mesh, plan),
        opt_bytes_per_device=opt_state_bytes_per_device(
            plan, [(e.path, e.shape) for e in entries],
            moments_per_param=built.moments_per_param),
        params_bytes_per_device=sum(
            shape_bytes(tensor_shape(local(p)))
            for p in built.model.parameters()),
        anchor_file="", anchor_path="", anchor_line=1,
        device_memory_budget_bytes=device_memory_budget_bytes,
        n_params=sum(int(np.prod(e.shape)) for e in entries),
    )


def _workload_anchor(name: str) -> Tuple[str, str, int]:
    """(abs file, display path, line of `def main`) of a port workload:
    where findings anchor, and where a `# lint: allow(hlo-*)` suppression
    would live."""
    from .. import workloads

    path = os.path.join(os.path.dirname(workloads.__file__), f"{name}.py")
    line = 1
    with open(path, encoding="utf-8") as fh:
        for i, text in enumerate(fh, start=1):
            if text.startswith("def main("):
                line = i
                break
    return path, f"tf_operator_tpu_torch/workloads/{name}.py", line


def _require_group(num_devices: int, what: str) -> None:
    size = dist.get_world_size() if dist.is_initialized() else 0
    if size != num_devices:
        raise RuntimeError(
            f"capturing {what} over {num_devices} rank(s) needs a process "
            f"group of that size (this process has "
            f"{size or 'none'}); `python -m tf_operator_tpu_torch.analysis "
            f"--hlo {what} --devices {num_devices}` starts one on the CPU")


def capture_workload(name: str, num_devices: int = DEFAULT_DEVICES,
                     zero: bool = True, overlap: bool = False,
                     device_memory_budget_bytes: int = 0,
                     full_width: bool = False) -> HloCapture:
    """Capture one train step of a builtin workload over {"dp": N}.  Every
    rank of the initialized process group (of `num_devices` ranks) calls
    it; each gets its own rank's capture, and the ranks' inventories must
    agree.  At the JAX package's tiny shapes by default, at the
    workload's own with `full_width`.

    `zero` defaults ON (the contract is "the four workloads with the ZeRO
    knob on run clean"); callers driving the spec knob pass
    `WorkloadContext.zero_shard_weight_update`.  `overlap=True` marks every
    sharded plan entry overlappable first, arming hlo-sync-collective."""
    if name not in _TINY:
        raise ValueError(
            f"unknown workload {name!r} (expected one of {TRAIN_WORKLOADS})")
    _require_group(num_devices, name)
    built = build_workload(name, zero=zero, overlap=overlap,
                           full_width=full_width)
    capture = capture_built(name, built, zero, device_memory_budget_bytes)
    capture.anchor_file, capture.anchor_path, capture.anchor_line = \
        _workload_anchor(name)
    return capture


def capture_from_file(path: str, num_devices: int = DEFAULT_DEVICES):
    """Load a capture fixture (tests/torch_lint_fixtures/bad_hlo_*.py) and
    run its `capture(num_devices)` in this rank of the group."""
    import importlib.util

    _require_group(num_devices, path)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(f"_hlo_fixture_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    capture = module.capture(num_devices)
    captures = capture if isinstance(capture, (list, tuple)) else [capture]
    for cap in captures:
        cap.anchor_file = os.path.abspath(path)
        cap.anchor_path = os.path.relpath(path, os.getcwd())
    return list(captures)


# ---------------------------------------------------------------------------
# The four rules


def _multiset(items) -> Dict[Any, int]:
    out: Dict[Any, int] = {}
    for item in items:
        out[item] = out.get(item, 0) + 1
    return out


def _gather_transfers(program: HloProgram, sync_only: bool = False):
    """Multiset of (operand dims -> result dims) pairs served by the
    step's all-gathers (a list gather contributes per result)."""
    pairs = []
    for op in program.by_kind("all-gather"):
        if sync_only and op.asynchronous:
            continue
        for operand, result in zip(op.operand_shapes * len(op.result_shapes),
                                   op.result_shapes):
            pairs.append((operand[1], result[1]))
    return _multiset(pairs)


def check_capture(capture: HloCapture,
                  rules: Optional[Sequence[str]] = None) -> List:
    """Run the four rules against one capture.  Findings anchor at the
    workload/fixture source (`anchor_path:anchor_line`), where the usual
    `# lint: allow(<rule>)` suppression comment applies."""
    from . import Finding, _Comments

    try:
        with open(capture.anchor_file, encoding="utf-8") as fh:
            comments = _Comments(fh.read())
    except OSError:
        comments = _Comments("")
    findings: List[Finding] = []

    def emit(rule: str, message: str) -> None:
        if rules is not None and rule not in rules:
            return
        if comments.allows(capture.anchor_line, rule):
            return
        findings.append(Finding(
            rule=rule, path=capture.anchor_path.replace(os.sep, "/"),
            line=capture.anchor_line, message=message))

    program = capture.program

    # hlo-plan-drift: every dim-sharded plan entry owes the step one
    # weight-update all-gather (shard shape -> base shape), and a plan with
    # anything to reduce owes a gradient reduction (reduce-scatter, or an
    # all-reduce) over at least the sharded entries' gradient bytes: the
    # loss's all-reduce alone does not sum them.
    if capture.plan is not None and capture.update_pairs:
        supply = _gather_transfers(program)
        missing = []
        for pair, count in _multiset(
                (p.shard_dims, p.base_dims) for p in capture.update_pairs
        ).items():
            short = count - supply.get(pair, 0)
            if short > 0:
                missing.append((pair, short))
        reductions = (program.by_kind("all-reduce")
                      + program.by_kind("reduce-scatter"))
        # what the ranks sum: each reduction's operand, whole
        reduced = sum(shape_bytes(shape) for op in reductions
                      for shape in op.operand_shapes)
        owed = sum(p.grad_bytes for p in capture.update_pairs)
        problems = []
        if missing:
            total = sum(short for _, short in missing)
            sample = ", ".join(
                f"{list(pair[0])}->{list(pair[1])}x{short}"
                for pair, short in missing[:3])
            problems.append(
                f"{total} of {len(capture.update_pairs)} sharded plan "
                f"entries have no weight-update all-gather in the step "
                f"(missing {sample})")
        if not reductions:
            problems.append(
                "no gradient reduction collective (all-reduce/"
                "reduce-scatter) despite a data-parallel sharding plan")
        elif reduced < owed:
            problems.append(
                f"the gradient reductions (all-reduce/reduce-scatter) sum "
                f"{reduced} B, short of the sharded plan entries' {owed} B "
                f"of gradients")
        if problems:
            emit(RULE_HLO_PLAN_DRIFT,
                 f"the step's collectives disagree with the "
                 f"ZeroShardingPlan (axis={capture.plan.axis!r}, "
                 f"num_shards={capture.plan.num_shards}): "
                 + "; ".join(problems))

    # hlo-replicated-optstate: the rank must hold its state at the planned
    # layout; a moment whose shard shape is absent from what it holds is
    # materialized dense (the exact failure mode ZeRO exists to remove).
    if capture.plan is not None and capture.expected_args:
        measured = _multiset(program.resident)
        missing = []
        for shape, count in _multiset(capture.expected_args).items():
            short = count - measured.get(shape, 0)
            if short > 0:
                missing.append((shape, short))
        if missing:
            sample = ", ".join(
                f"{dtype}{list(dims)}x{short}"
                for (dtype, dims), short in missing[:4])
            emit(RULE_HLO_REPLICATED_OPTSTATE,
                 f"{sum(s for _, s in missing)} expected per-rank "
                 f"shard buffer(s) missing from the state the rank holds "
                 f"({sample}) — optimizer state is materialized at a "
                 f"larger (replicated) shape than the plan's")

    # hlo-sync-collective: a plan entry marked overlappable whose
    # weight-update gather ran with async_op=False serializes the transfer
    # the plan promised to hide.
    overlap_pairs = [p for p in capture.update_pairs if p.overlap]
    if overlap_pairs:
        sync_supply = _gather_transfers(program, sync_only=True)
        stuck = 0
        for pair, count in _multiset(
                (p.shard_dims, p.base_dims) for p in overlap_pairs).items():
            stuck += min(count, sync_supply.get(pair, 0))
        if stuck:
            emit(RULE_HLO_SYNC_COLLECTIVE,
                 f"{stuck} of {len(overlap_pairs)} overlappable plan "
                 f"entries ran a synchronous all-gather (async_op=False) "
                 f"— the weight-update transfer cannot overlap compute")

    # hlo-memory-infeasible: the per-rank peak exceeds the declared device
    # budget — this layout does not fit, so admission rejects it (reason
    # MemoryInfeasible).
    if capture.device_memory_budget_bytes > 0 and capture.memory is not None:
        peak = capture.memory.peak_bytes
        budget = capture.device_memory_budget_bytes
        if peak > budget:
            emit(RULE_HLO_MEMORY_INFEASIBLE,
                 f"per-rank peak {peak} B exceeds the declared device "
                 f"budget {budget} B ({capture.memory.device} peak; "
                 f"resident={capture.memory.resident_bytes}); plan-model "
                 f"optimizer bytes/device={capture.opt_bytes_per_device}")
    return findings


# ---------------------------------------------------------------------------
# Collective signature + manifest (analysis/collective-manifest.json)


def collective_signature(program: HloProgram) -> Dict[str, Any]:
    """Aggregate the collective inventory by kind: the shape of the step's
    communication, stable across runs."""
    agg: Dict[str, Dict[str, Any]] = {}
    for op in program.collectives:
        entry = agg.setdefault(op.kind, {
            "count": 0, "syncCount": 0, "totalBytes": 0, "groupSizes": set(),
        })
        entry["count"] += 1
        entry["syncCount"] += 0 if op.asynchronous else 1
        entry["totalBytes"] += op.bytes_moved
        if op.group_size:
            entry["groupSizes"].add(op.group_size)
    return {
        kind: {**entry, "groupSizes": sorted(entry["groupSizes"])}
        for kind, entry in sorted(agg.items())
    }


def signature_hash(signature: Dict[str, Any]) -> str:
    blob = json.dumps(signature, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def workload_signature(capture: HloCapture) -> Dict[str, Any]:
    signature: Dict[str, Any] = {
        "collectives": collective_signature(capture.program),
        "optStateBytesPerDevice": capture.opt_bytes_per_device,
        "paramsBytesPerDevice": capture.params_bytes_per_device,
    }
    if capture.memory is not None:
        signature["residentBytesPerDevice"] = capture.memory.resident_bytes
    if capture.plan is not None:
        signature["plan"] = {
            "axis": capture.plan.axis,
            "numShards": capture.plan.num_shards,
            "entries": len(capture.plan.entries),
            "shardedEntries": len(capture.update_pairs),
        }
    return signature


def build_manifest(captures: Sequence[HloCapture]) -> Dict[str, Any]:
    workloads = {}
    for capture in captures:
        signature = workload_signature(capture)
        workloads[capture.workload] = {
            "hash": signature_hash(signature),
            "signature": signature,
        }
    return {
        "version": HLO_MANIFEST_VERSION,
        "schema": HLO_MANIFEST_SCHEMA,
        "numDevices": captures[0].num_devices if captures else 0,
        "zeroShardWeightUpdate": bool(captures and captures[0].zero),
        "workloads": workloads,
    }


def render_manifest(manifest: Dict[str, Any]) -> str:
    return json.dumps(manifest, indent=2, sort_keys=True) + "\n"


# ---------------------------------------------------------------------------
# Admission-time memory feasibility (plain python)

BYTES_PER_PARAM = 4          # f32 master weights
BYTES_PER_MOMENT = 4         # moments kept in the param dtype


def admission_peak_lower_bound(model_params: int, *, dp_shards: int = 1,
                               model_parallel: int = 1, zero: bool = False,
                               moments_per_param: int = 2) -> int:
    """Analytic lower bound of the per-device training footprint for a
    declared model size: params + grads (+ moments, ZeRO-divided when the
    weight-update sharding knob is on).  Deliberately a LOWER bound — no
    activations, no temps — so exceeding the budget here is a proof of
    infeasibility, never a false positive.  The measured peak
    (HloCapture.memory.peak_bytes on the card) is the tight companion
    number."""
    model_parallel = max(1, model_parallel)
    dp_shards = max(1, dp_shards)
    params = model_params * BYTES_PER_PARAM // model_parallel
    grads = model_params * BYTES_PER_PARAM // model_parallel
    moments = (model_params * BYTES_PER_MOMENT * moments_per_param
               // model_parallel)
    if zero:
        moments //= dp_shards
    return params + grads + moments


def admission_memory_check(tpu) -> Optional[str]:
    """None when the declared layout can fit (or declares no budget);
    otherwise the human-readable reason for a MemoryInfeasible FAILED
    condition.  `tpu` carries device_memory_gb, model_params, mesh and
    zero_shard_weight_update (the TPUTopology of a job spec)."""
    if tpu is None or tpu.device_memory_gb <= 0 or tpu.model_params <= 0:
        return None
    mesh = dict(tpu.mesh or {})
    dp_shards = int(mesh.get("dp", 1))
    model_parallel = 1
    for axis, size in mesh.items():
        if axis != "dp":
            model_parallel *= max(1, int(size))
    need = admission_peak_lower_bound(
        int(tpu.model_params), dp_shards=dp_shards,
        model_parallel=model_parallel,
        zero=bool(tpu.zero_shard_weight_update))
    budget = int(tpu.device_memory_gb * (1024 ** 3))
    if need <= budget:
        return None
    gib = need / (1024 ** 3)
    hint = ("" if tpu.zero_shard_weight_update else
            "; enabling tpu.zeroShardWeightUpdate would shard the "
            "optimizer moments over dp")
    return (f"model with {tpu.model_params} params needs >= {gib:.2f} GiB "
            f"per device (params+grads+moments lower bound, mesh {mesh}) "
            f"but tpu.deviceMemoryGB declares {tpu.device_memory_gb}"
            f"{hint}")


# ---------------------------------------------------------------------------
# The CLI (python -m tf_operator_tpu_torch.analysis --hlo ...)

# the environment variable that sets N when --devices does not
ENV_DEVICES = "ANALYSIS_HLO_DEVICES"


def default_devices() -> int:
    """N, the ranks of a capture without --devices: $ANALYSIS_HLO_DEVICES,
    else the pod's local devices (`workloads/launch.local_device_count`:
    the GPUs, or $TPUJOB_CPU_DEVICE_COUNT under TPUJOB_FORCE_PLATFORM=cpu),
    where on the CPU an unset count means the reference's 4 virtual
    devices."""
    from ..api import constants
    from ..workloads.launch import local_device_count

    if os.environ.get(ENV_DEVICES):
        return int(os.environ[ENV_DEVICES])
    cpu = os.environ.get(constants.ENV_FORCE_PLATFORM, "").lower() == "cpu"
    if cpu and not os.environ.get(constants.ENV_CPU_DEVICE_COUNT):
        return DEFAULT_DEVICES
    return local_device_count()


def _capture_targets(target: str, budget_bytes: int) -> List[HloCapture]:
    names = list(TRAIN_WORKLOADS) if target == "all" else [target]
    n = dist.get_world_size() if dist.is_initialized() else 1
    captures: List[HloCapture] = []
    for name in names:
        if name.endswith(".py") or os.sep in name:
            captures.extend(capture_from_file(name, n))
        else:
            captures.append(capture_workload(
                name, n, device_memory_budget_bytes=budget_bytes))
    return captures


def run_hlo(target: str, *, json_path: Optional[str] = None,
            manifest_path: Optional[str] = None,
            diff_path: Optional[str] = None,
            rules: Optional[Sequence[str]] = None) -> int:
    """The `--hlo` mode in one rank that the pod launcher started
    (`workloads/launch.spawn`, as `__main__` does): join the group on this
    rank's device (NCCL on `cuda:<local rank>`, gloo on the CPU under
    TPUJOB_FORCE_PLATFORM=cpu; `runner.process_group`), capture, and on
    rank 0 lint, print, optionally snapshot/diff the collective-signature
    manifest.  The workload captures are held to the card's whole memory
    on CUDA (hlo-memory-infeasible), to no budget on the CPU, where the
    peak is only the resident bytes.  Returns the process exit code, which
    the launcher makes the command's."""
    from ..parallel.mesh import build_mesh
    from ..workloads.runner import (WorkloadContext, apply_forced_platform,
                                    process_group)
    from . import diff_summary, write_findings_json

    try:
        device = apply_forced_platform()
    except RuntimeError as e:
        print(f"hlo: {e}", flush=True)
        return 1
    if device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    budget_bytes = (torch.cuda.get_device_properties(device).total_memory
                    if device.type == "cuda" else 0)
    ctx = WorkloadContext.from_env()
    with process_group(ctx, device, build_mesh({"dp": ctx.world},
                                               ctx.world)):
        captures = _capture_targets(target, budget_bytes)
    if ctx.rank != 0:
        return 0

    findings = []
    for capture in captures:
        findings.extend(check_capture(capture, rules=rules))
        memory = capture.memory
        print(f"{capture.workload}: {len(capture.program.collectives)} "
              f"collective(s) over {capture.num_devices} rank(s); "
              f"{memory.device} peak {memory.peak_bytes} B, resident "
              f"{memory.resident_bytes} B")
    for finding in findings:
        print(finding.render())
    print(f"{len(findings)} HLO finding(s) over {len(captures)} recorded "
          f"train step(s) [{', '.join(c.workload for c in captures)}]")
    if json_path:
        write_findings_json(json_path, findings, f"hlo:{target}")
        print(f"wrote {json_path}")
    exit_code = 1 if findings else 0
    manifest = build_manifest(captures)
    if manifest_path:
        with open(manifest_path, "w", encoding="utf-8") as fh:
            fh.write(render_manifest(manifest))
        print(f"wrote {manifest_path}")
    if diff_path:
        try:
            with open(diff_path, encoding="utf-8") as fh:
                committed = json.load(fh)
        except (OSError, ValueError) as err:
            print(f"cannot read committed collective manifest {diff_path}: "
                  f"{err}")
            return 1
        drift = diff_summary(committed, manifest)
        if drift:
            print(f"collective manifest drift vs {diff_path} "
                  f"({len(drift)} difference(s)):")
            for line in drift:
                print(f"  {line}")
            print("the step's collective signature changed; if intended, "
                  "regenerate with: python -m tf_operator_tpu_torch.analysis "
                  f"--hlo all --devices {committed.get('numDevices')} "
                  f"--manifest --json {diff_path}")
            exit_code = 1
        else:
            print(f"collective manifest matches {diff_path}")
    return exit_code
