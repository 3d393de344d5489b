"""Pipeline-parallel Transformer LM over the `pp` mesh axis.

The counterpart of `tf_operator_tpu/models/pipeline_lm.py`: the embedding
and the head run on every rank, the block stack as a pipeline over `pp`
(`parallel/pipeline.py`).  A module holds only its rank's stage: the
`layers_per_stage` blocks of stage r, or with `virtual_stages` V its V
chunks (chunk g = v·P + r, holding global layers [g·lpc, (g + 1)·lpc)),
and the replicated `wte`, `wpe` (absent for RoPE configs), `ln_f_scale`
and `ln_f_bias` (absent for RMSNorm), under the flax names.

`apply` (logits), `loss_gpipe` and `loss_1f1b` all go through one copy of
the head math, `_head_logits`, which is not `TransformerLM`'s: the final
norm is computed by hand in f32 (LayerNorm with eps 1e-5 and the biased
variance, RMSNorm with eps 1e-6), and the tied readout runs in the model
dtype (`x.to(dtype) @ wte.to(dtype).T`, then f32).  The loss compares
logits[:, :-1] with tokens[:, 1:] of the same T tokens.

As in JAX (x enters `shard_map` replicated), the batch is replicated over
every axis but `pp`: each dp line computes the whole batch, so every dp
rank holds the same loss and gradients, with no gradient sum over dp.

The process-group methods run this rank's steps over the mesh's pp group.
`loss_1f1b_primal` is loss_1f1b's primal under autograd, the reference
its hand-made gradient is held to.  `apply_all_ranks`,
`loss_gpipe_all_ranks`, `loss_1f1b_all_ranks` and
`loss_1f1b_primal_all_ranks` run
every rank of the pipeline in this process, from one module per rank (the
same step functions, the carries handed over in place of the hops; the
embedding and head are rank 0's).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.pipeline import (GroupRing, LocalRing, gpipe,
                                 gpipe_interleaved, needs_grad,
                                 one_f_one_b_loss, split_microbatches)
from .transformer import Block, Dense, Norm, TransformerConfig, _normal_


class PipelinedTransformerLM(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh, num_microbatches: int = 4,
                 pp_axis: str = "pp", virtual_stages: int = 1,
                 pp_rank: Optional[int] = None) -> None:
        """The module of pp rank `pp_rank` (this process's place on the
        mesh's `pp_axis` by default) of a pipeline over `mesh` (a
        `parallel.mesh.Mesh`, laid over the process group to run the
        process-group methods at more than one stage)."""
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        self.num_microbatches = num_microbatches
        self.pp_axis = pp_axis
        self.num_stages = mesh.shape[pp_axis]
        self.virtual_stages = virtual_stages
        chunks = self.num_stages * virtual_stages
        if cfg.num_layers % chunks:
            raise ValueError(
                f"num_layers {cfg.num_layers} must divide by stages x "
                f"virtual_stages = {chunks}"
            )
        if virtual_stages > 1 and num_microbatches > self.num_stages:
            raise ValueError(
                f"interleaved schedule needs num_microbatches "
                f"({num_microbatches}) <= pipeline stages "
                f"({self.num_stages}); see gpipe_interleaved")
        self.layers_per_stage = cfg.num_layers // chunks
        self.rank = (mesh.coordinate(pp_axis) if pp_rank is None
                     else pp_rank)
        # local block v * lpc + j is layer j of chunk v
        self.blocks = nn.ModuleList(
            Block(cfg) for _ in range(virtual_stages * self.layers_per_stage))
        d = cfg.d_model
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.wpe = (None if cfg.use_rope
                    else nn.Parameter(torch.empty(cfg.max_len, d)))
        self.ln_f_scale = nn.Parameter(torch.ones(d))
        self.ln_f_bias = (nn.Parameter(torch.zeros(d))
                          if cfg.norm == "layernorm" else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw as the JAX model's `init` does (N(0, 0.02) for `wte`, `wpe`
        and the blocks' kernels, zero biases, unit norm scales): `wte`, then
        `wpe`, then every global layer in order, this rank's into its blocks
        and the others' into a scratch block, so the modules of every rank
        built from one seed hold one model (the same draws as
        `TransformerLM.reset_parameters`)."""
        _normal_(self.wte, generator)
        if self.wpe is not None:
            _normal_(self.wpe, generator)
        with torch.no_grad():
            self.ln_f_scale.fill_(1.0)
            if self.ln_f_bias is not None:
                self.ln_f_bias.zero_()
        lpc, size = self.layers_per_stage, self.num_stages
        scratch = None
        for chunk in range(size * self.virtual_stages):
            for j in range(lpc):
                if chunk % size == self.rank:
                    block = self.blocks[(chunk // size) * lpc + j]
                else:
                    if scratch is None:
                        scratch = Block(self.cfg).to(self.wte.device)
                    block = scratch
                for module in block.modules():
                    if isinstance(module, (Dense, Norm)):
                        module.reset_parameters(generator)

    # ------------------------------------------------------------------
    # this rank's stage, the embedding and the head

    def chunk(self, v: int):
        """Chunk v's blocks, applied in order (the stage at V = 1)."""
        lpc = self.layers_per_stage
        blocks = self.blocks[v * lpc:(v + 1) * lpc]

        def run(x):
            for block in blocks:
                x = block(x)
            return x

        return run

    def chunks(self) -> list:
        return [self.chunk(v) for v in range(self.virtual_stages)]

    def stage_params(self) -> List[nn.Parameter]:
        return list(self.blocks.parameters())

    def head_params(self) -> List[nn.Parameter]:
        return [p for p in (self.wte, self.ln_f_scale, self.ln_f_bias)
                if p is not None]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.wte)
        if self.wpe is not None:
            x = x + self.wpe[None, : tokens.shape[1], :]
        return x.to(self.cfg.dtype)

    def _head_logits(self, act: torch.Tensor) -> torch.Tensor:
        """Final norm + weight-tied readout.  THE single copy of the head
        math: apply, loss_gpipe and loss_1f1b all route through it."""
        cfg = self.cfg
        x32 = act.float()
        if cfg.norm == "rmsnorm":
            x32 = x32 * torch.rsqrt(
                (x32 * x32).mean(-1, keepdim=True) + 1e-6) * self.ln_f_scale
        else:
            mean = x32.mean(-1, keepdim=True)
            var = x32.var(-1, keepdim=True, unbiased=False)
            x32 = (x32 - mean) * torch.rsqrt(var + 1e-5)
            x32 = x32 * self.ln_f_scale + self.ln_f_bias
        logits = x32.to(cfg.dtype) @ self.wte.to(cfg.dtype).T
        return logits.float()

    @staticmethod
    def _next_token_loss(logits: torch.Tensor,
                         tokens: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits[:, :-1], dim=-1)
        ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        return -ll.mean()

    def _head_loss(self, act: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
        return self._next_token_loss(self._head_logits(act), tokens)

    # ------------------------------------------------------------------
    # over the pp group: this rank's steps

    def _ring(self) -> GroupRing:
        group = (self.mesh.group(self.pp_axis) if self.num_stages > 1
                 else None)
        return GroupRing(group, self.rank, self.num_stages)

    def apply(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [B, T, vocab] in f32, the same on every rank."""
        return _apply([self], tokens, self._ring())

    def loss_gpipe(self, tokens: torch.Tensor) -> torch.Tensor:
        """Next-token loss through GPipe (the forward pipelined, the
        backward autograd's: every microbatch's residuals live)."""
        return _loss_gpipe([self], tokens, self._ring())

    def loss_1f1b(self, tokens: torch.Tensor) -> torch.Tensor:
        """Next-token loss through the fused 1F1B (at most 2P microbatch
        inputs live); without a gradient to take, GPipe's forward and the
        head, as JAX's primal path.  Same math as loss_gpipe."""
        return _loss_1f1b([self], tokens, self._ring())

    def loss_1f1b_primal(self, tokens: torch.Tensor) -> torch.Tensor:
        """loss_1f1b's primal (GPipe's forward, the head per microbatch)
        under autograd: the gradient the fused loop computes by hand, at
        GPipe's memory, with the head's products rounded as the loop's
        (the full-batch head of loss_gpipe rounds them otherwise)."""
        return _loss_1f1b_primal([self], tokens, self._ring())


# ---------------------------------------------------------------------------
# the schedules over a ring, from the modules of the ranks it holds


def _check_ranks(models: Sequence[PipelinedTransformerLM]) -> None:
    size = models[0].num_stages
    if [m.rank for m in models] != list(range(size)):
        raise ValueError(f"expected the modules of pp ranks 0..{size - 1} "
                         f"in order, got ranks {[m.rank for m in models]}")


def _acts(models, tokens, ring) -> torch.Tensor:
    """The activations leaving the last stage, [B, T, d]."""
    head = models[0]
    x = head._embed(tokens)
    if head.virtual_stages > 1:
        return gpipe_interleaved([m.chunks() for m in models], x,
                                 head.num_microbatches, ring)
    return gpipe([m.chunk(0) for m in models], x, head.num_microbatches,
                 ring)


def _apply(models, tokens, ring) -> torch.Tensor:
    return models[0]._head_logits(_acts(models, tokens, ring))


def _loss_gpipe(models, tokens, ring) -> torch.Tensor:
    return models[0]._next_token_loss(_apply(models, tokens, ring), tokens)


def _loss_1f1b_primal(models, tokens, ring) -> torch.Tensor:
    """GPipe's forward and the head per microbatch, their losses averaged:
    the function whose gradient the fused loop computes (JAX's primal
    path)."""
    m_count = models[0].num_microbatches
    acts = split_microbatches(_acts(models, tokens, ring), m_count)
    per_mb = [models[0]._head_loss(a, t) for a, t in
              zip(acts, split_microbatches(tokens, m_count))]
    return torch.stack(per_mb).mean()


def _loss_1f1b(models, tokens, ring) -> torch.Tensor:
    head = models[0]
    if head.virtual_stages > 1:
        raise ValueError(
            "the fused 1F1B loop does not implement virtual stages; "
            "use loss_gpipe with virtual_stages > 1 (interleaved "
            "forward, autodiff backward)")
    params = [m.stage_params() for m in models]
    m_count = head.num_microbatches
    if not needs_grad([p for group in params for p in group]
                      + head.head_params()):
        return _loss_1f1b_primal(models, tokens, ring)
    return one_f_one_b_loss(
        [m.chunk(0) for m in models], params, head._head_loss,
        head.head_params(), head._embed(tokens), tokens, m_count, ring)


def apply_all_ranks(models: Sequence[PipelinedTransformerLM],
                    tokens: torch.Tensor) -> torch.Tensor:
    """`apply` with every rank's module in this process, ranks in order."""
    _check_ranks(models)
    return _apply(models, tokens, LocalRing(len(models)))


def loss_gpipe_all_ranks(models: Sequence[PipelinedTransformerLM],
                         tokens: torch.Tensor) -> torch.Tensor:
    """`loss_gpipe` with every rank's module in this process; the stage
    gradients land on each rank's module, the embedding's and head's on
    rank 0's."""
    _check_ranks(models)
    return _loss_gpipe(models, tokens, LocalRing(len(models)))


def loss_1f1b_all_ranks(models: Sequence[PipelinedTransformerLM],
                        tokens: torch.Tensor) -> torch.Tensor:
    """`loss_1f1b` with every rank's module in this process, as
    `loss_gpipe_all_ranks`."""
    _check_ranks(models)
    return _loss_1f1b(models, tokens, LocalRing(len(models)))


def loss_1f1b_primal_all_ranks(models: Sequence[PipelinedTransformerLM],
                               tokens: torch.Tensor) -> torch.Tensor:
    """`loss_1f1b_primal` with every rank's module in this process, as
    `loss_gpipe_all_ranks`."""
    _check_ranks(models)
    return _loss_1f1b_primal(models, tokens, LocalRing(len(models)))
