"""Losses, the train and eval steps, and the batch's shard for this rank.

The counterpart of `tf_operator_tpu/train/step.py`: the cross-entropy
(full or chunked), `lm_loss_fn`, `classification_loss_fn`,
`make_train_step` with gradient accumulation (the MoE load-balancing
loss reported as the microbatches' mean), `classification_metrics`
with `make_eval_step`, and `shard_batch`.  The train step runs the model
in training mode (BatchNorm normalises with the batch's statistics and
updates its running ones); the eval step runs it in eval mode without
gradients and changes no parameter or buffer.  PyTorch runs eagerly, so
there is no jit and no donation; the model's parameters live in the module
and the step updates them in place through the optimizer.

Over a mesh (one process per rank) the step is the one GSPMD derives for
the JAX package: each rank takes its shard of the global batch
(`shard_batch`: its rows over dp and fsdp, for the transformers its
slice of the sequence over sp, as the state's `Sharding.split_axes` say; with
grad_accum, microbatch i is its share of the global batch's i-th part, as
JAX's reshape of the global batch gives it), its
loss is its mean over its share divided by the ranks of the axes that
split the batch (`Sharding.split_axes`; the ranks along any other axis
compute the same loss on the same rows), the gradients are summed once
over those axes and never over tp, ep or pp
(`parallel/shard.Sharding.reduce_grads`), before clipping, and the
reported loss is summed likewise.  A model whose layers
reduce over the batch (ResNet's BatchNorm) all-reduces those sums itself.
Under tp the LM's logits are this rank's vocab slice, and the
cross-entropy's log-sum-exp and target logit are summed over the tp group
(`softmax_cross_entropy(..., tp=)`).  The eval step's metrics are the
global batch's: the ranks' means weighted by their rows.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.dist import all_reduce_max, copy_to_group, reduce_from_group
from .state import TrainState


def _vocab_parallel_nll(logits, labels, tp):
    """-log p(label) per row of logits that hold this rank's vocab slice
    ([rank * V/tp, (rank + 1) * V/tp)), p the softmax over the whole
    vocab.

    Each rank normalises its slice with `log_softmax` and shifts it by
    its slice's log-sum-exp less the whole vocab's (the maxima and the sums
    of exponentials combined over the tp group); the label's log
    probability comes from the rank that holds it.  The gradient of
    `log_softmax` holds this slice's own softmax; a term whose value is 0
    adds the difference to the whole vocab's softmax.  Over a group of one
    rank the shift and that difference are exactly 0, so the loss and its
    gradient are, bit for bit, the plain cross-entropy's."""
    import torch.distributed as dist

    v = logits.shape[-1]
    logp = F.log_softmax(logits, dim=-1)
    with torch.no_grad():
        m = logits.max(-1).values
        s = (logits - m[..., None]).exp().sum(-1)
        m_all = all_reduce_max(tp.group, m)
        s_all = s * (m - m_all).exp()
        dist.all_reduce(s_all, group=tp.group)
        shift = (s.log() + m) - (s_all.log() + m_all)
    local = labels - tp.rank * v
    inside = (local >= 0) & (local < v)
    picked = logp.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    with torch.no_grad():
        # the whole vocab's softmax less what log_softmax's gradient holds
        d = (logp + shift[..., None]).exp() - torch.where(
            inside[..., None], logp.exp(), 0.0)
    extra = (logits * d).sum(-1)
    picked = torch.where(inside, picked + shift, 0.0) - (extra - extra.detach())
    return -reduce_from_group(tp.group, picked)


def softmax_cross_entropy(logits, labels, tp=None) -> torch.Tensor:
    """labels: int class ids. Mean loss in f32.  With `tp` (a
    parallel.dist.TPGroup) the logits are this rank's vocab slice."""
    if tp is not None:
        return _vocab_parallel_nll(logits.float(), labels.long(), tp).mean()
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.long()[..., None])[..., 0]
    return -ll.mean()


def _chunk_nll(hx, table, yy, tp=None):
    # bf16 hidden x f32 table runs as an f32 product, as the full readout does
    if tp is not None:
        hx = copy_to_group(tp.group, hx)
        return _vocab_parallel_nll(F.linear(hx.float(), table), yy, tp).sum()
    logits = F.linear(hx.float(), table)
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, yy[..., None]).sum()


def chunked_softmax_xent(hidden, table, targets, chunk: int,
                         tp=None) -> torch.Tensor:
    """Weight-tied LM cross-entropy computed in T-chunks so the full
    [B, T, vocab] logits never materialize.  Each chunk's logits are
    recomputed in the backward (`torch.utils.checkpoint`), so peak logits
    memory is B * chunk * vocab regardless of T.  `hidden` [B, T, D] is the
    model's pre-readout output (already in the model dtype); `table`
    [vocab, D] the readout matrix (with `tp`, this rank's vocab slice)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    b, t, _ = hidden.shape
    targets = targets.long()
    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, t, chunk):
        hx = hidden[:, lo:lo + chunk]
        yy = targets[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, hx, table, yy, tp,
                                       use_reentrant=False)
        else:
            total = total + _chunk_nll(hx, table, yy, tp)
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


def lm_loss_fn(model, moe_aux_weight: float = 0.0, loss_chunk: int = 0,
               table_fn: Optional[Callable] = None):
    """Next-token prediction loss for TransformerLM: `loss(batch) ->
    (loss, aux)`.  With moe_aux_weight > 0 the loss adds that times the
    MoE layers' mean load-balancing loss (`parallel/moe.moe_aux_loss`),
    which aux reports as "moe_aux_loss": without it the router gets no
    balancing gradient.  With loss_chunk > 0 the cross-entropy goes
    through `chunked_softmax_xent` on the model's pre-readout hidden
    states."""
    if loss_chunk < 0:
        raise ValueError(
            f"loss_chunk must be >= 0, got {loss_chunk} (0 disables "
            "chunking; a negative value silently ignored would leave the "
            "full-logits memory peak in place)")
    get_table = table_fn or _tied_table

    def ce(tokens):
        # under tp the readout gives this rank's vocab slice
        tp = getattr(model, "vocab_tp", None)
        if loss_chunk > 0:
            hidden = model(tokens[:, :-1], return_hidden=True)
            return chunked_softmax_xent(
                hidden, get_table(model), tokens[:, 1:], loss_chunk, tp)
        logits = model(tokens[:, :-1])
        return softmax_cross_entropy(logits, tokens[:, 1:], tp)

    def loss(batch):
        value = ce(batch["tokens"])
        if moe_aux_weight > 0.0:
            from ..parallel.moe import moe_aux_loss

            aux = moe_aux_loss(model)
            return value + moe_aux_weight * aux, {"moe_aux_loss": aux}
        return value, {}

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


def make_eval_step(metric_fn, mesh=None):
    """`eval_step(state, batch) -> metrics`: forward only, in eval mode and
    without gradients, so no parameter or buffer changes.  With a `mesh`
    (over the process group) `batch` is this rank's shard and each metric
    is the global batch's: the ranks' values weighted by their rows and
    summed over the data axes."""
    from ..parallel.mesh import data_axes

    group = None if mesh is None else mesh.group_over(data_axes(mesh))

    def step(state: TrainState, batch):
        state.model.eval()
        with torch.no_grad():
            metrics = metric_fn(batch)
            if mesh is None:
                return metrics
            rows = next(iter(batch.values())).shape[0]
            names = sorted(metrics)
            sums = torch.stack([metrics[k].float() * rows for k in names] +
                               [metrics[names[0]].new_tensor(float(rows))])
            dist.all_reduce(sums, group=group)
            return {k: sums[i] / sums[-1] for i, k in enumerate(names)}

    return step


def shard_batch(batch, sharding, grad_accum: int = 1):
    """This rank's shard of a global batch, for the train state laid out by
    `sharding` (`parallel/shard.Sharding`, whose `split_axes` say which
    axes split the batch): its rows (`shard_rows`), then its slice of the
    sequence (`shard_sequence`).  Works on numpy arrays and tensors;
    rank-0 leaves are replicated."""
    return shard_sequence(shard_rows(batch, sharding, grad_accum), sharding)


def shard_rows(batch, sharding, grad_accum: int = 1):
    """This rank's rows of a global batch over the data axes (dp, fsdp);
    the ranks along every other axis keep the same rows.  With grad_accum
    k the global rows split into k parts (microbatches) first and the rank
    keeps its rows of each, in order, so `make_train_step`'s chunk i of
    the shard is this rank's share of global rows [i*B/k, (i+1)*B/k), as
    in the JAX step."""
    from ..parallel.mesh import axis_size, data_axes

    mesh = sharding.mesh
    sizes = [axis_size(mesh, a) for a in data_axes(mesh)]
    n_data = int(np.prod(sizes, initial=1))
    row = int(np.ravel_multi_index(
        [mesh.coordinate(a) for a in data_axes(mesh)], sizes)) if sizes else 0
    out = {}
    for name, leaf in batch.items():
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            out[name] = leaf
            continue
        if shape[0] % (n_data * grad_accum):
            raise ValueError(
                f"batch leaf {name!r} has leading dim {shape[0]}, which the "
                f"mesh's data axes (size {n_data}, mesh {mesh.shape}) times "
                f"grad_accum {grad_accum} don't divide — use a batch that is "
                f"a multiple of {n_data * grad_accum}")
        rows = shape[0] // (n_data * grad_accum)
        parts = leaf.reshape((grad_accum, shape[0] // grad_accum) + shape[1:])
        out[name] = parts[:, row * rows:(row + 1) * rows].reshape(
            (grad_accum * rows,) + shape[1:])
    return out


def shard_sequence(batch, sharding):
    """This rank's slice of the sequence where sp splits the batch
    (`Sharding.split_axes`); the batch as it is elsewhere.  The LM's
    leaves are the shifted window {"tokens": [B, T + 1]}: the loss reads
    inputs tokens[:, :-1] and targets tokens[:, 1:], and sp rank s of n
    takes tokens[:, s*T/n : (s+1)*T/n + 1], whose own shift gives exactly
    its slice of the global inputs and targets (neighbouring windows share
    one token).  The encoders' [B, T] leaves (BERT's tokens and token
    types) take the plain slice [s*T/n, (s+1)*T/n); their other leaves
    (labels [B], ViT's images, whose tokens the model slices after the
    patch embedding) stay whole."""
    from ..parallel.mesh import AXIS_SP, axis_size

    mesh = sharding.mesh
    sp = (axis_size(mesh, AXIS_SP) if AXIS_SP in sharding.split_axes
          else 1)
    if sp == 1:
        return batch
    seq_idx = mesh.coordinate(AXIS_SP)
    shifted = sharding.shifted_tokens
    out = {}
    for name, leaf in batch.items():
        shape = tuple(getattr(leaf, "shape", ()))
        if not shifted and len(shape) != 2:
            out[name] = leaf
            continue
        t = shape[1] - shifted if len(shape) >= 2 else -1
        if t < 0 or t % sp:
            raise ValueError(
                f"batch leaf {name!r} of shape {shape}: sequence "
                f"parallelism needs {'[B, T + 1]' if shifted else '[B, T]'} "
                f"tokens with T divisible by the sp axis size {sp}")
        t //= sp
        out[name] = leaf[:, seq_idx * t:(seq_idx + 1) * t + shifted]
    return out


def make_train_step(loss_fn, grad_accum: int = 1, mesh=None):
    """Build `step(state, batch) -> (state, metrics)`.

    grad_accum > 1 splits the batch's leading dim into that many
    microbatches and accumulates their mean gradient before the single
    optimizer update: the same update as one big batch (exact for
    mean-reduced losses), activation memory held to one microbatch.

    With a `mesh` (over the initialized process group) the batch is this
    rank's shard (`shard_batch` with the same grad_accum) and the step is
    the distributed one described in the module docstring: the gradients
    are reduced by the train state's `Sharding` (`create_train_state` with
    the same mesh)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None and mesh.size != dist.get_world_size():
        raise ValueError(f"{mesh} does not cover the process group's "
                         f"{dist.get_world_size()} ranks")

    def step(state: TrainState, batch):
        # every rank of the axes that split the batch holds an equal share
        # of the rows (tokens), so the global mean is the sum over those
        # ranks of each rank's mean over their count; the ranks along the
        # other axes hold the same rows
        ranks = 1
        if mesh is not None:
            if state.sharding is None:
                raise ValueError("a step over a mesh needs the train state "
                                 "laid out on it: create_train_state(..., "
                                 "mesh=)")
            ranks = int(np.prod([mesh.shape[a]
                                 for a in state.sharding.split_axes]))
        state.model.train()
        for key, x in batch.items():
            if x.shape[0] % grad_accum:
                raise ValueError(
                    f"batch leading dim {x.shape[0]} must divide by "
                    f"grad_accum={grad_accum}")
        micro = {key: x.chunk(grad_accum) for key, x in batch.items()}
        state.optimizer.zero_grad(set_to_none=True)
        total, aux_total = 0.0, None
        for i in range(grad_accum):
            loss, aux = loss_fn({key: parts[i] for key, parts in micro.items()})
            (loss / (grad_accum * ranks)).backward()
            total = total + loss.detach()
            if "moe_aux_loss" in aux:
                # the global batch's on every rank: no reduction
                aux_total = aux["moe_aux_loss"].detach() + (
                    0.0 if aux_total is None else aux_total)
        total = total / (grad_accum * ranks)
        if mesh is not None:
            state.sharding.reduce_grads()
            dist.all_reduce(total, group=state.sharding.loss_group)
        state.apply_gradients()
        metrics = {"loss": total}
        if aux_total is not None:
            metrics["moe_aux_loss"] = aux_total / grad_accum
        return state, metrics

    return step
