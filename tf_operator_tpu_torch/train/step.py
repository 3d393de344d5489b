"""LM loss and the train step.

The counterpart of `tf_operator_tpu/train/step.py` for one device: the
cross-entropy (full or chunked), `lm_loss_fn`, and `make_train_step` with
gradient accumulation.  PyTorch runs eagerly, so there is no jit and no
donation; the model's parameters live in the module and the step updates
them in place through the optimizer.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
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


def make_train_step(loss_fn, grad_accum: int = 1):
    """Build `step(state, batch) -> (state, metrics)`.

    grad_accum > 1 splits the batch's leading dim into that many
    microbatches and accumulates their mean gradient before the single
    optimizer update: the same update as one big batch (exact for
    mean-reduced losses), activation memory held to one microbatch."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(state: TrainState, batch):
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
            (loss / grad_accum).backward()
            total = total + loss.detach()
        state.apply_gradients()
        return state, {"loss": total / grad_accum}

    return step
