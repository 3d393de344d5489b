"""Losses, the train and eval steps, and the batch's shard for this rank.

The counterpart of `tf_operator_tpu/train/step.py`: the cross-entropy
(full or chunked), `lm_loss_fn`, `classification_loss_fn`,
`make_train_step` with gradient accumulation, `classification_metrics`
with `make_eval_step`, and `shard_batch`.  The train step runs the model
in training mode (BatchNorm normalises with the batch's statistics and
updates its running ones); the eval step runs it in eval mode without
gradients and changes no parameter or buffer.  PyTorch runs eagerly, so
there is no jit and no donation; the model's parameters live in the module
and the step updates them in place through the optimizer.

Over a mesh (one process per rank) the step is the data- and
sequence-parallel step that GSPMD derives for the JAX package: each rank
takes its shard of the global batch (`shard_batch`), its loss is its mean
over its share divided by the rank count (for the LM, its sum over the
global token count), the gradients are summed over every rank before
clipping (so the clip sees the global norm), and the reported loss is
summed likewise.  Parameters stay replicated; a model whose layers reduce
over the batch (ResNet's BatchNorm) all-reduces those sums itself.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .state import TrainState


def softmax_cross_entropy(logits, labels) -> torch.Tensor:
    """labels: int class ids. Mean loss in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()


def _chunk_nll(hx, table, yy):
    # bf16 hidden x f32 table runs as an f32 product, as the full readout does
    logits = F.linear(hx.float(), table)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, yy[..., None]).sum()


def chunked_softmax_xent(hidden, table, targets, chunk: int) -> torch.Tensor:
    """Weight-tied LM cross-entropy computed in T-chunks so the full
    [B, T, vocab] logits never materialize.  Each chunk's logits are
    recomputed in the backward (`torch.utils.checkpoint`), so peak logits
    memory is B * chunk * vocab regardless of T.  `hidden` [B, T, D] is the
    model's pre-readout output (already in the model dtype); `table`
    [vocab, D] the readout matrix."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    b, t, _ = hidden.shape
    targets = targets.long()
    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, t, chunk):
        hx = hidden[:, lo:lo + chunk]
        yy = targets[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, hx, table, yy,
                                       use_reentrant=False)
        else:
            total = total + _chunk_nll(hx, table, yy)
    return total / (b * t)


def _tied_table(model):
    """Default readout-table accessor for the chunked loss: TransformerLM's
    weight-tied embedding."""
    try:
        return model.wte.weight
    except AttributeError as exc:
        raise ValueError(
            "loss_chunk needs the model's readout table; the default "
            "accessor expects TransformerLM's tied wte.weight — pass "
            "table_fn= for other layouts") from exc


def lm_loss_fn(model, loss_chunk: int = 0,
               table_fn: Optional[Callable] = None):
    """Next-token prediction loss for TransformerLM: `loss(batch) ->
    (loss, aux)`.  With loss_chunk > 0 the cross-entropy goes through
    `chunked_softmax_xent` on the model's pre-readout hidden states."""
    if loss_chunk < 0:
        raise ValueError(
            f"loss_chunk must be >= 0, got {loss_chunk} (0 disables "
            "chunking; a negative value silently ignored would leave the "
            "full-logits memory peak in place)")
    get_table = table_fn or _tied_table

    def loss(batch):
        tokens = batch["tokens"]
        if loss_chunk > 0:
            hidden = model(tokens[:, :-1], return_hidden=True)
            return chunked_softmax_xent(
                hidden, get_table(model), tokens[:, 1:], loss_chunk), {}
        logits = model(tokens[:, :-1])
        return softmax_cross_entropy(logits, tokens[:, 1:]), {}

    return loss


def _logits(out):
    """Unwrap a model output: dict heads expose 'logits', plain tensors are
    the logits already."""
    return out["logits"] if isinstance(out, dict) else out


def classification_loss_fn(model):
    """Image/sequence classification loss: `loss(batch) -> (loss, aux)` on
    {"x", "label"}.  A BatchNorm model updates its running statistics in
    the forward (the train step runs it in training mode)."""

    def loss(batch):
        logits = _logits(model(batch["x"]))
        return softmax_cross_entropy(logits, batch["label"]), {}

    return loss


def classification_metrics(model):
    """Eval-side metric fn: loss and accuracy from a forward pass; pair it
    with `make_eval_step`, which runs the model in eval mode (BatchNorm
    reads its running statistics)."""

    def metric_fn(batch):
        logits = _logits(model(batch["x"]))
        labels = batch["label"].long()
        return {
            "loss": softmax_cross_entropy(logits, labels),
            "accuracy": (logits.argmax(-1) == labels).float().mean(),
        }

    return metric_fn


def make_eval_step(metric_fn):
    """`eval_step(state, batch) -> metrics`: forward only, in eval mode and
    without gradients, so no parameter or buffer changes."""

    def step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad():
            return metric_fn(batch)

    return step


def shard_batch(batch, mesh):
    """This rank's shard of a global LM batch {"tokens": [B, T + 1]}: its
    rows of the data axes (dp, fsdp) and, over the `sp` axis, its slice of
    the shifted sequence.  The loss reads inputs tokens[:, :-1] and targets
    tokens[:, 1:]; sp rank s of n takes the window tokens[:, s*T/n :
    (s+1)*T/n + 1], whose own shift gives exactly its slice of the global
    inputs and targets (neighbouring windows share one token).  Works on
    numpy arrays and tensors; rank-0 leaves are replicated."""
    from ..parallel.mesh import AXIS_SP, axis_size, data_axes

    sizes = [axis_size(mesh, a) for a in data_axes(mesh)]
    n_data = int(np.prod(sizes, initial=1))
    row = int(np.ravel_multi_index(
        [mesh.coordinate(a) for a in data_axes(mesh)], sizes)) if sizes else 0
    sp = axis_size(mesh, AXIS_SP)
    seq_idx = mesh.coordinate(AXIS_SP)
    out = {}
    for name, leaf in batch.items():
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            out[name] = leaf
            continue
        if shape[0] % n_data:
            raise ValueError(
                f"batch leaf {name!r} has leading dim {shape[0]}, which the "
                f"mesh's data axes (size {n_data}, mesh {mesh.shape}) don't "
                f"divide — use a batch that is a multiple of {n_data}")
        rows = shape[0] // n_data
        leaf = leaf[row * rows:(row + 1) * rows]
        if sp > 1:
            if len(shape) < 2 or (shape[1] - 1) % sp:
                raise ValueError(
                    f"batch leaf {name!r} of shape {shape}: sequence "
                    f"parallelism needs [B, T + 1] tokens with T divisible "
                    f"by the sp axis size {sp}")
            t = (shape[1] - 1) // sp
            leaf = leaf[:, seq_idx * t:(seq_idx + 1) * t + 1]
        out[name] = leaf
    return out


def all_reduce_grads(params) -> None:
    """Sum the gradients over every rank, in one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(loss_fn, grad_accum: int = 1, mesh=None):
    """Build `step(state, batch) -> (state, metrics)`.

    grad_accum > 1 splits the batch's leading dim into that many
    microbatches and accumulates their mean gradient before the single
    optimizer update: the same update as one big batch (exact for
    mean-reduced losses), activation memory held to one microbatch.

    With a `mesh` (over the initialized process group) the batch is this
    rank's shard (`shard_batch`) and the step is the distributed one
    described in the module docstring; grad_accum splits the local rows."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    # every rank holds an equal share of the rows (tokens), so the global
    # mean is the sum over ranks of each rank's mean over the rank count
    ranks = 1 if mesh is None else mesh.size
    if mesh is not None and mesh.size != dist.get_world_size():
        raise ValueError(f"{mesh} does not cover the process group's "
                         f"{dist.get_world_size()} ranks")

    def step(state: TrainState, batch):
        state.model.train()
        for key, x in batch.items():
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch leading dim {x.shape[0]} must divide by "
                    f"grad_accum={grad_accum}")
        micro = {key: x.chunk(grad_accum) for key, x in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        total = 0.0
        for i in range(grad_accum):
            loss, _ = loss_fn({key: parts[i] for key, parts in micro.items()})
            (loss / (grad_accum * ranks)).backward()
            total = total + loss.detach()
        total = total / (grad_accum * ranks)
        if mesh is not None:
            all_reduce_grads(state.model.parameters())
            dist.all_reduce(total)
        state.apply_gradients()
        return state, {"loss": total}

    return step
