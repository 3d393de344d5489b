"""Transformer LM (GPT- and llama-style) and the BERT encoder, the
training path.

The counterpart of `tf_operator_tpu/models/transformer.py`: the same config
fields and validation, the same architecture and numerics — bf16 compute
with f32 params (every Dense casts its input and weight to `cfg.dtype`, as
flax `Dense(dtype=...)` does), f32 norms with flax's eps 1e-6, tanh GELU,
and a weight-tied readout that promotes the bf16 hidden state to f32 before
the vocab product (flax `Embed.attend` promotes to the common dtype).

Attention goes through `ops.attention.flash_attention`: the hand-written
CUDA kernels on the card, the plain version on the CPU.  With a mesh
(`parallel.mesh.Mesh`) whose `ring_axis` is larger than 1, the model runs
on this rank's contiguous slice of the sequence, and attention goes through
ring attention or Ulysses over that axis's group (`seq_parallel`); learned
positions and rope take the slice's global positions.

Under tensor parallelism (`parallel/shard.py` slices the parameters by
`parallel/tp_rules.py` and sets each module's `tp`) a block runs Megatron's
layout: q, k, v, wi and wg column-parallel on this rank's heads or columns
(`flash_attention` gets this rank's [B, H/tp, T, D] and its KV/tp heads),
out and wo row-parallel with their partial sums added over the tp group,
and the token embedding vocab-sharded (the readout gives this rank's
vocab slice of the logits; `train/step.py` takes the cross-entropy over
the group).  Head counts come from the parameters' local shapes.

`BertEncoder` (BASELINE config 4) runs the same blocks non-causal between
token + type + learned position embeddings summed in f32 and a tanh pooler
in f32 on position 0; `models/vit.py` runs them over image patches.

Not ported in this package yet (raise at config construction): the decode
KV cache (`decode=True`) and mixture-of-experts blocks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention, flash_attention, repeat_kv
from ..parallel.dist import copy_to_group, reduce_from_group
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention
from .initializers import lecun_normal_


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_len: int = 2048
    dropout_rate: float = 0.0
    dtype: Any = torch.bfloat16
    causal: bool = True
    ring_axis: str = "sp"
    seq_parallel: str = "ring"
    mesh: Optional[Any] = None
    remat: bool = False
    # False runs the plain O(T^2) attention even on the card
    use_flash: bool = True
    decode: bool = False
    num_kv_heads: int = 0          # 0 -> num_heads (plain MHA)
    use_rope: bool = False
    rope_theta: float = 10000.0
    rope_scaling: str = "none"     # "none" | "linear" | "ntk"
    rope_factor: float = 1.0
    norm: str = "layernorm"        # "layernorm" | "rmsnorm"
    mlp: str = "gelu"              # "gelu" | "swiglu"
    type_vocab_size: int = 2
    moe_num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    attn_window: int = 0
    attn_sink: int = 0
    kv_cache_dtype: str = "model"  # "model" | "int8"

    def __post_init__(self):
        # A typo'd knob must not silently train the default architecture.
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm must be 'layernorm'|'rmsnorm', got {self.norm!r}")
        if self.mlp not in ("gelu", "swiglu"):
            raise ValueError(f"mlp must be 'gelu'|'swiglu', got {self.mlp!r}")
        if self.seq_parallel not in ("ring", "ulysses"):
            raise ValueError(
                f"seq_parallel must be 'ring'|'ulysses', got {self.seq_parallel!r}")
        if (self.seq_parallel == "ulysses" and self.mesh is not None
                and self.ring_axis in self.mesh.axis_names):
            # each tp rank holds heads / tp of them when tp divides them
            tp = self.mesh.shape.get("tp", 1)
            heads = (self.num_heads // tp if self.num_heads % tp == 0
                     else self.num_heads)
            if heads % self.mesh.shape[self.ring_axis]:
                raise ValueError(
                    f"seq_parallel='ulysses' needs num_heads ({heads}"
                    f"{' per tp rank' if heads != self.num_heads else ''}) "
                    f"divisible by the {self.ring_axis!r} axis size "
                    f"({self.mesh.shape[self.ring_axis]}); use 'ring' "
                    "instead")
        if self.use_rope and (self.d_model // self.num_heads) % 2:
            raise ValueError(
                f"rope needs an even head_dim; d_model {self.d_model} / "
                f"num_heads {self.num_heads} = {self.d_model // self.num_heads}"
            )
        if self.kv_cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'model'|'int8', "
                f"got {self.kv_cache_dtype!r}")
        if self.rope_scaling not in ("none", "linear", "ntk"):
            raise ValueError(
                f"rope_scaling must be 'none'|'linear'|'ntk', "
                f"got {self.rope_scaling!r}")
        if self.rope_scaling != "none":
            if not self.use_rope:
                raise ValueError("rope_scaling requires use_rope=True")
            if self.rope_factor < 1.0:
                raise ValueError(
                    f"rope_factor must be >= 1, got {self.rope_factor}")
        if self.num_kv_heads < 0 or self.num_kv_heads > self.num_heads or (
            self.num_kv_heads and self.num_heads % self.num_kv_heads
        ):
            raise ValueError(
                f"num_kv_heads {self.num_kv_heads} must be in [0, num_heads] "
                f"and divide num_heads {self.num_heads}"
            )
        if self.attn_window:
            if self.attn_window < 0:
                raise ValueError(
                    f"attn_window must be >= 0, got {self.attn_window}")
            if not self.causal:
                raise ValueError(
                    "attn_window (sliding-window attention) requires "
                    "causal=True")
            if _seq_parallel(self):
                raise ValueError(
                    "attn_window does not compose with sequence "
                    "parallelism (ring/ulysses shard the full-attention "
                    "pattern); drop the sp axis or the window")
        if self.attn_sink:
            if self.attn_sink < 0:
                raise ValueError(
                    f"attn_sink must be >= 0, got {self.attn_sink}")
            if not self.attn_window:
                raise ValueError(
                    "attn_sink requires attn_window > 0 (without a window "
                    "every position already attends the first tokens)")
            if self.attn_sink >= self.max_len:
                raise ValueError(
                    f"attn_sink ({self.attn_sink}) must be < max_len "
                    f"({self.max_len}): a sink covering every position is "
                    "full attention, and the rolling decode cache needs at "
                    "least one non-sink slot")
        # Fields of the JAX config this package does not run yet.
        if self.decode:
            raise NotImplementedError(
                "decode (KV-cache generation) is not yet ported "
                "(ROADMAP item A.12)")
        if self.moe_num_experts:
            raise NotImplementedError(
                "mixture-of-experts blocks are not yet ported "
                "(ROADMAP item A.13)")


def _seq_parallel(cfg: TransformerConfig) -> bool:
    """Whether attention runs sequence parallel (the JAX `_use_ring`)."""
    return (cfg.mesh is not None and cfg.ring_axis in cfg.mesh.axis_names
            and cfg.mesh.shape[cfg.ring_axis] > 1)


def rope(x, *, theta: float = 10000.0, positions=None,
         scaling: str = "none", factor: float = 1.0):
    """Rotary position embeddings on [B, H, T, D] (D even), computed in f32
    and returned in x's dtype.  scaling="linear" divides positions by
    `factor`; scaling="ntk" stretches theta to theta * factor**(d/(d-2))."""
    b, h, t, d = x.shape
    if positions is None:
        positions = torch.arange(t, device=x.device)
    positions = positions.to(torch.float32)
    if scaling == "linear":
        positions = positions / factor
    elif scaling == "ntk":
        theta = theta * factor ** (d / max(d - 2, 1))
    elif scaling != "none":
        raise ValueError(
            f"rope scaling must be 'none'|'linear'|'ntk', got {scaling!r}")
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[:, None] * freqs[None, :]  # [T, D/2]
    cos = torch.cos(angles)[None, None]
    sin = torch.sin(angles)[None, None]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                      dim=-1).reshape(b, h, t, d)
    return rot.to(x.dtype)


def _normal_(p: torch.Tensor, generator: Optional[torch.Generator]):
    with torch.no_grad():
        p.normal_(0.0, 0.02, generator=generator)


class Dense(nn.Module):
    """flax `Dense(dtype=...)`: input, weight and bias cast to the compute
    dtype; weight stored [out, in] in f32, initialised N(0, 0.02).  A
    per-head projection keeps its bias as flax does, [heads, head_dim]
    (`bias_shape`), so rank-based rules such as the weight-decay mask see
    the same ranks as in the JAX model."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 bias: bool = True, bias_shape=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(bias_shape or (out_features,)))
                     if bias else None)

    def reset_parameters(self, generator=None):
        _normal_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        bias = (None if self.bias is None
                else self.bias.reshape(-1).to(self.dtype))
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)

    def row_parallel(self, x, tp):
        """The product of a weight sharded on its input dim, summed over
        the tp group.  The bias (replicated) enters on tp rank 0 alone, so
        it is added once and, at tp 1, exactly as `forward` adds it; the
        other ranks add it times 0, and their zero gradient for it is
        summed over the group with rank 0's (`parallel/shard.py`)."""
        bias = self.bias
        if bias is not None:
            bias = bias.reshape(-1).to(self.dtype)
            if tp.rank:
                bias = bias * 0
        return reduce_from_group(tp.group, F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), bias))


class Norm(nn.Module):
    """flax LayerNorm / RMSNorm with dtype=float32: statistics and output in
    f32, eps 1e-6."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        self.kind = kind
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = (nn.Parameter(torch.zeros(features))
                     if kind == "layernorm" else None)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        x = x.float()
        if self.kind == "rmsnorm":
            ms = x.pow(2).mean(-1, keepdim=True)
            return x * torch.rsqrt(ms + 1e-6) * self.weight
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, 1e-6)


class SelfAttention(nn.Module):
    # the tensor-parallel group (parallel.dist.TPGroup) when this rank holds
    # a slice of the heads
    tp = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.d_model // cfg.num_heads
        self.kv_heads = cfg.num_kv_heads or cfg.num_heads
        d = cfg.d_model
        def per_head(n):
            return Dense(d, n * self.head_dim, cfg.dtype,
                         bias_shape=(n, self.head_dim))

        self.query = per_head(cfg.num_heads)
        self.key = per_head(self.kv_heads)
        self.value = per_head(self.kv_heads)
        self.out = Dense(cfg.num_heads * self.head_dim, d, cfg.dtype)

    def forward(self, x, positions=None):
        cfg = self.cfg
        b, t, _ = x.shape
        if self.tp is not None:
            x = copy_to_group(self.tp.group, x)

        def heads(proj):  # [B, T, n*D] -> [B, n, T, D], n this rank's
            y = proj(x)
            return y.view(b, t, y.shape[-1] // self.head_dim,
                          self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        if cfg.use_rope:
            q = rope(q, theta=cfg.rope_theta, positions=positions,
                     scaling=cfg.rope_scaling, factor=cfg.rope_factor)
            k = rope(k, theta=cfg.rope_theta, positions=positions,
                     scaling=cfg.rope_scaling, factor=cfg.rope_factor)
        window = cfg.attn_window or None
        if _seq_parallel(cfg):
            # grouped k/v stay grouped: ring hops move them as they are,
            # Ulysses widens them only when the kv heads do not split
            seq_attend = (ulysses_attention if cfg.seq_parallel == "ulysses"
                          else ring_attention)
            out = seq_attend(q.contiguous(), k.contiguous(), v.contiguous(),
                             cfg.mesh.group(cfg.ring_axis), causal=cfg.causal,
                             use_flash=cfg.use_flash)
        elif cfg.use_flash:
            # the kernels take contiguous [B, H, T, D]; grouped k/v stay
            # grouped (the kernels map query heads to KV heads)
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), cfg.causal, window=window,
                                  sink=cfg.attn_sink)
        else:
            out = attention(q, *repeat_kv(q, k, v), causal=cfg.causal,
                            window=window, sink=cfg.attn_sink)
        out = out.transpose(1, 2).reshape(b, t, q.shape[1] * self.head_dim)
        if self.tp is not None:
            return self.out.row_parallel(out, self.tp)
        return self.out(out)


class MLP(nn.Module):
    # the tensor-parallel group when this rank holds a slice of the d_ff
    # columns
    tp = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.swiglu = cfg.mlp == "swiglu"
        d, f = cfg.d_model, cfg.d_ff
        if self.swiglu:
            self.wg = Dense(d, f, cfg.dtype, bias=False)
            self.wi = Dense(d, f, cfg.dtype, bias=False)
            self.wo = Dense(f, d, cfg.dtype, bias=False)
        else:
            self.wi = Dense(d, f, cfg.dtype)
            self.wo = Dense(f, d, cfg.dtype)

    def forward(self, x):
        if self.tp is not None:
            x = copy_to_group(self.tp.group, x)
        if self.swiglu:
            h = F.silu(self.wg(x)) * self.wi(x)
        else:
            # flax nn.gelu defaults to the tanh approximation
            h = F.gelu(self.wi(x), approximate="tanh")
        if self.tp is not None:
            return self.wo.row_parallel(h, self.tp)
        return self.wo(h)


class Block(nn.Module):
    """Pre-norm transformer block (dense MLP)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln1 = Norm(cfg.norm, cfg.d_model)
        self.attn = SelfAttention(cfg)
        self.ln2 = Norm(cfg.norm, cfg.d_model)
        self.mlp = MLP(cfg)

    def forward(self, x, positions=None):
        x = x + self.attn(self.ln1(x).to(self.dtype), positions)
        return x + self.mlp(self.ln2(x).to(self.dtype))


class TransformerLM(nn.Module):
    """Decoder-only causal language model with a weight-tied readout."""

    # the tensor-parallel group when this rank holds a slice of the vocab
    # (rows [rank * V/tp, (rank + 1) * V/tp) of the embedding)
    vocab_tp = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model)
        # rotary models encode positions inside attention instead
        self.wpe = (None if cfg.use_rope else
                    nn.Parameter(torch.empty(cfg.max_len, cfg.d_model)))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg.norm, cfg.d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter as the JAX model does (N(0, 0.02) for
        embeddings and kernels, zero biases, unit norm scales), drawing from
        `generator`."""
        _normal_(self.wte.weight, generator)
        if self.wpe is not None:
            _normal_(self.wpe, generator)
        for module in self.modules():
            if isinstance(module, (Dense, Norm)):
                module.reset_parameters(generator)

    def forward(self, tokens, return_hidden: bool = False):
        """tokens [B, T]: the whole sequence, or under sequence parallelism
        this rank's slice of it (rank i of the ring axis holding positions
        [i*T, (i+1)*T))."""
        cfg = self.cfg
        t = tokens.shape[1]
        first, positions = 0, None
        if _seq_parallel(cfg):
            first = cfg.mesh.coordinate(cfg.ring_axis) * t
            positions = torch.arange(first, first + t, device=tokens.device)
        if self.vocab_tp is None:
            x = self.wte(tokens)
        else:
            x = vocab_parallel_embedding(tokens, self.wte.weight,
                                         self.vocab_tp)
        if self.wpe is not None:
            x = x + self.wpe[None, first:first + t, :]
        x = x.to(cfg.dtype)
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, positions, use_reentrant=False)
            else:
                x = block(x, positions)
        x = self.ln_f(x).to(cfg.dtype)
        if return_hidden:
            # pre-readout hidden states for the chunked cross-entropy, with
            # the rounding the full readout applies
            return x
        # tied readout: bf16 hidden promoted to f32 against the f32 table
        # (under tp: this rank's vocab slice of the logits)
        if self.vocab_tp is not None:
            x = copy_to_group(self.vocab_tp.group, x)
        return F.linear(x.float(), self.wte.weight)


def vocab_parallel_embedding(tokens, table, tp):
    """The rows of a vocab-sharded embedding: each rank looks up the
    tokens in its slice (zero for the others), summed over the tp group."""
    start = tp.rank * table.shape[0]
    local = tokens - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(inside, local, 0), table)
    return reduce_from_group(tp.group,
                             torch.where(inside[..., None], rows, 0.0))


class BertEncoder(nn.Module):
    """BERT-base-style bidirectional encoder with a classification head:
    `forward(tokens, token_types=None)` returns {"sequence_output" (the
    final norm's f32 output), "logits" (f32)}."""

    def __init__(self, cfg: TransformerConfig, num_labels: int = 2):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.tok_emb = nn.Embedding(cfg.vocab_size, d)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, d)
        self.pos_emb = nn.Parameter(torch.empty(cfg.max_len, d))
        self.emb_ln = Norm(cfg.norm, d)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg.norm, d)
        self.pooler = nn.Linear(d, d)
        self.classifier = nn.Linear(d, num_labels)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise as the flax model does: embeddings N(0, 1/d) (flax
        `Embed`'s default), positions and the blocks' kernels N(0, 0.02),
        pooler and classifier lecun-normal, zero biases, unit norm
        scales."""
        std = self.cfg.d_model ** -0.5
        with torch.no_grad():
            self.tok_emb.weight.normal_(0.0, std, generator=generator)
            self.type_emb.weight.normal_(0.0, std, generator=generator)
        _normal_(self.pos_emb, generator)
        for module in self.modules():
            if isinstance(module, (Dense, Norm)):
                module.reset_parameters(generator)
        for head in (self.pooler, self.classifier):
            lecun_normal_(head.weight, head.in_features, generator)
            with torch.no_grad():
                head.bias.zero_()

    def forward(self, tokens, token_types=None):
        cfg = self.cfg
        t = tokens.shape[1]
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        x = (self.tok_emb(tokens) + self.type_emb(token_types)
             + self.pos_emb[None, :t, :])
        x = self.emb_ln(x).to(cfg.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        cls = torch.tanh(self.pooler(x[:, 0]))
        return {"sequence_output": x, "logits": self.classifier(cls)}


def bert_base_config(**overrides) -> TransformerConfig:
    base = dict(
        vocab_size=30522, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_len=512, causal=False,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def llama_style_config(**overrides) -> TransformerConfig:
    """Llama-family architecture: RoPE + RMSNorm + SwiGLU + grouped-query
    attention, no learned positional table.  Sized like gpt-small."""
    base = dict(
        vocab_size=32000, num_layers=12, num_heads=12, num_kv_heads=4,
        d_model=768, d_ff=2048, max_len=2048, causal=True,
        use_rope=True, norm="rmsnorm", mlp="swiglu",
    )
    base.update(overrides)
    return TransformerConfig(**base)


def gpt_small_config(**overrides) -> TransformerConfig:
    base = dict(
        vocab_size=32000, num_layers=12, num_heads=12, d_model=768,
        d_ff=3072, max_len=2048, causal=True,
    )
    base.update(overrides)
    return TransformerConfig(**base)
