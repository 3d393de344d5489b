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
in f32 on position 0; `models/vit.py` runs them over image patches.  Under
tp BERT's token embedding is vocab-sharded (a lookup alone: no tied
readout); under sp each rank holds its slice of the tokens, attention runs
the non-causal ring, and position 0, which sp rank 0 alone holds, reaches
the pooler on every rank through `broadcast_from_first` (the JAX model
runs the same steps on the global sequence, and passes no attention mask
on the training path, so neither does the ring).

Decoding (`models/generate.py`) passes a `DecodeCache` to
`TransformerLM.forward`: each attention layer appends the call's keys and
values to its `LayerCache` at the running position and attends the cache
on the plain torch path, as the JAX decode twin runs with
`use_flash=False` (JAX `SelfAttention._decode_attend`): the full cache of
`max_len` slots read whole under the absolute causal mask, or with
`attn_window` a rolling cache of `sink + window` slots masked by each
slot's absolute position, keys and values optionally stored in int8 with
per-slot absmax scales.  With `moe_num_experts`, every `moe_every`-th
block's MLP is a mixture of experts (`parallel/moe.py`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, attention, flash_attention, repeat_kv
from ..parallel.dist import (broadcast_from_first, copy_to_group,
                             reduce_from_group)
from ..parallel.moe import MoEMLP
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


def _seq_parallel(cfg: TransformerConfig) -> bool:
    """Whether attention runs sequence parallel (the JAX `_use_ring`)."""
    return (cfg.mesh is not None and cfg.ring_axis in cfg.mesh.axis_names
            and cfg.mesh.shape[cfg.ring_axis] > 1)


def first_of_sequence(cfg: TransformerConfig, x):
    """x[:, 0] of the whole sequence: under sequence parallelism sp rank
    0's, handed to every rank (`broadcast_from_first`)."""
    if not _seq_parallel(cfg):
        return x[:, 0]
    return broadcast_from_first(cfg.mesh.group(cfg.ring_axis), x[:, 0])


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


@dataclass
class LayerCache:
    """One attention layer's decode cache, under the flax leaf names:
    keys and values [B, kv_heads, cap, D] (this rank's KV heads under tp)
    in the model dtype or int8, the int8 cache's per-slot f32 scales
    [B, kv_heads, cap], with a window each slot's absolute position + 1
    (`cached_pos1` [cap] int32, 0 = empty), and the running position.
    Decoding writes the tensors in place."""

    cached_key: torch.Tensor
    cached_value: torch.Tensor
    cached_key_scale: Optional[torch.Tensor] = None
    cached_value_scale: Optional[torch.Tensor] = None
    cached_pos1: Optional[torch.Tensor] = None
    cache_index: int = 0


@dataclass
class DecodeCache:
    """Every layer's cache and the learned positions' running index (JAX's
    model-level `wpe_index`)."""

    layers: List[LayerCache] = field(default_factory=list)
    wpe_index: int = 0


def cache_capacity(cfg: TransformerConfig) -> int:
    """Slots per layer: max_len, or with a window min(sink + window,
    max_len) (positions never exceed max_len, so a clamped rolling region
    evicts no key inside the window)."""
    if cfg.attn_window:
        return min(cfg.attn_sink + cfg.attn_window, cfg.max_len)
    return cfg.max_len


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

    def forward(self, x, positions=None, cache: Optional[LayerCache] = None):
        cfg = self.cfg
        b, t, _ = x.shape
        if self.tp is not None:
            x = copy_to_group(self.tp.group, x)

        def heads(proj):  # [B, T, n*D] -> [B, n, T, D], n this rank's
            y = proj(x)
            return y.view(b, t, y.shape[-1] // self.head_dim,
                          self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        if cache is not None:
            out = self._decode_attend(q, k, v, cache)
        else:
            out = self._attend(q, k, v, positions)
        out = out.transpose(1, 2).reshape(b, t, q.shape[1] * self.head_dim)
        if self.tp is not None:
            return self.out.row_parallel(out, self.tp)
        return self.out(out)

    def _attend(self, q, k, v, positions):
        cfg = self.cfg
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
        return out

    def _decode_attend(self, q, k, v, c: LayerCache):
        """Cached attention for decoding (JAX `_decode_attend`): the call's
        T keys and values go into the cache at the running position, RoPE
        rotates by absolute positions, and q attends the cache on the plain
        path (f32 scores, probabilities in the model dtype).

        Without a window the span is written at [pos, pos + T) and q reads
        all `max_len` slots under the absolute causal mask (a static shape:
        unfilled slots are masked).  With one, a T=1 step writes slot
        `sink + (p - sink) % (cap - sink)` (sinks keep their own slot) and
        the window|sink mask comes from each slot's position; a T>1 call
        (chunked prefill) attends the cached keys plus its own under one
        mask, then stores its sink-bound tokens and its last cap - sink
        others and drops the rest.  In int8 only positions cached by
        earlier calls pay the quantisation round trip: the span in hand is
        attended exactly."""
        cfg = self.cfg
        _, _, t, head_dim = q.shape
        window = cfg.attn_window or None
        sink = cfg.attn_sink if window else 0
        cap = c.cached_key.shape[2]
        quant = c.cached_key_scale is not None
        pos0 = c.cache_index
        span = torch.arange(pos0, pos0 + t, device=q.device)
        if cfg.use_rope:
            q = rope(q, theta=cfg.rope_theta, positions=span,
                     scaling=cfg.rope_scaling, factor=cfg.rope_factor)
            k = rope(k, theta=cfg.rope_theta, positions=span,
                     scaling=cfg.rope_scaling, factor=cfg.rope_factor)

        def enc(x):
            """Model-dtype [.., T, D] -> (stored, its scales or None)."""
            if not quant:
                return x.to(cfg.dtype), None
            xf = x.float()
            s = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
            return torch.round(xf / s).to(torch.int8), s[..., 0]

        def dec(stored, scale):
            if not quant:
                return stored
            return (stored.float() * scale[..., None]).to(cfg.dtype)

        def store(kq, ks, vq, vs, at):
            c.cached_key[:, :, at] = kq
            c.cached_value[:, :, at] = vq
            if quant:
                c.cached_key_scale[:, :, at] = ks
                c.cached_value_scale[:, :, at] = vs

        def attend(kf, vf, valid):
            kf, vf = repeat_kv(q, kf, vf)
            logits = torch.matmul(q.float(), kf.float().transpose(-1, -2))
            logits = (logits * head_dim ** -0.5).masked_fill(~valid, NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(vf.dtype)
            return torch.matmul(probs, vf).to(q.dtype)

        def append_and_read(start):
            """Write the span at `start` and return the cache in the model
            dtype, the span exact."""
            at = slice(start, start + t)
            store(*enc(k), *enc(v), at)
            kf = dec(c.cached_key, c.cached_key_scale)
            vf = dec(c.cached_value, c.cached_value_scale)
            if quant:
                kf[:, :, at] = k.to(cfg.dtype)
                vf[:, :, at] = v.to(cfg.dtype)
            return kf, vf

        c.cache_index = pos0 + t
        if window and t > 1:
            k_abs = torch.cat([c.cached_pos1 - 1, span])
            near = span[:, None] - k_abs[None, :] < window
            if sink:
                near = near | (k_abs[None, :] < sink)
            valid = (k_abs[None, :] >= 0) & (k_abs[None, :] <= span[:, None]) \
                & near
            kf = torch.cat([dec(c.cached_key, c.cached_key_scale), k], dim=2)
            vf = torch.cat([dec(c.cached_value, c.cached_value_scale), v],
                           dim=2)
            out = attend(kf, vf, valid)
            roll = cap - sink
            slots = torch.where(span < sink, span,
                                sink + torch.remainder(span - sink, roll))
            kept = ((span < sink) | (span >= pos0 + t - roll)).nonzero()[:, 0]
            kq, ks = enc(k[:, :, kept])
            vq, vs = enc(v[:, :, kept])
            store(kq, ks, vq, vs, slots[kept])
            c.cached_pos1[slots[kept]] = (span[kept] + 1).to(torch.int32)
            return out
        if window:
            slot = pos0 if pos0 < sink else sink + (pos0 - sink) % (cap - sink)
            kf, vf = append_and_read(slot)
            c.cached_pos1[slot] = pos0 + 1
            k_abs = c.cached_pos1 - 1
            near = pos0 - k_abs < window
            if sink:
                near = near | (k_abs < sink)
            valid = (k_abs >= 0) & (k_abs <= pos0) & near
            return attend(kf, vf, valid[None, :])
        kf, vf = append_and_read(pos0)
        cols = torch.arange(cap, device=q.device)
        return attend(kf, vf, cols[None, :] <= span[:, None])


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
    """Pre-norm transformer block: a dense MLP (`mlp`), or with `use_moe` a
    mixture of experts (`moe`, the flax module's name)."""

    def __init__(self, cfg: TransformerConfig, use_moe: bool = False):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln1 = Norm(cfg.norm, cfg.d_model)
        self.attn = SelfAttention(cfg)
        self.ln2 = Norm(cfg.norm, cfg.d_model)
        if use_moe:
            self.moe = MoEMLP(cfg.d_model, cfg.d_ff, cfg.moe_num_experts,
                              cfg.moe_top_k, cfg.moe_capacity_factor,
                              cfg.dtype)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x, positions=None, cache: Optional[LayerCache] = None):
        x = x + self.attn(self.ln1(x).to(self.dtype), positions, cache)
        h = self.ln2(x).to(self.dtype)
        if hasattr(self, "moe"):
            # a decode call routes its own sequences alone
            return x + self.moe(h, local=cache is not None)
        return x + self.mlp(h)


class TransformerLM(nn.Module):
    """Decoder-only causal language model with a weight-tied readout.
    Block i is a mixture-of-experts block when the config has experts and
    (i + 1) % moe_every == 0."""

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
        self.blocks = nn.ModuleList(
            Block(cfg, use_moe=cfg.moe_num_experts > 0
                  and (i + 1) % cfg.moe_every == 0)
            for i in range(cfg.num_layers))
        self.ln_f = Norm(cfg.norm, cfg.d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter as the JAX model does (N(0, 0.02) for
        embeddings, kernels and experts, a lecun-normal router, zero
        biases, unit norm scales), drawing from `generator`."""
        _normal_(self.wte.weight, generator)
        if self.wpe is not None:
            _normal_(self.wpe, generator)
        for module in self.modules():
            if isinstance(module, (Dense, Norm, MoEMLP)):
                module.reset_parameters(generator)

    def init_cache(self, batch: int, device=None) -> DecodeCache:
        """An empty decode cache for `batch` sequences on `device` (the
        parameters' by default), with this rank's KV heads under tp."""
        cfg = self.cfg
        device = self.wte.weight.device if device is None else device
        cap = cache_capacity(cfg)
        quant = cfg.kv_cache_dtype == "int8"
        layers = []
        for block in self.blocks:
            attn = block.attn
            kv = attn.key.weight.shape[0] // attn.head_dim
            shape = (batch, kv, cap, attn.head_dim)
            store = torch.int8 if quant else cfg.dtype
            layers.append(LayerCache(
                cached_key=torch.zeros(shape, dtype=store, device=device),
                cached_value=torch.zeros(shape, dtype=store, device=device),
                cached_key_scale=(torch.zeros(shape[:3], device=device)
                                  if quant else None),
                cached_value_scale=(torch.zeros(shape[:3], device=device)
                                    if quant else None),
                cached_pos1=(torch.zeros(cap, dtype=torch.int32,
                                         device=device)
                             if cfg.attn_window else None)))
        return DecodeCache(layers)

    def forward(self, tokens, return_hidden: bool = False,
                cache: Optional[DecodeCache] = None):
        """tokens [B, T]: the whole sequence, or under sequence parallelism
        this rank's slice of it (rank i of the ring axis holding positions
        [i*T, (i+1)*T)).  With a `cache` (decoding) the tokens continue the
        cached positions, and only the last position's logits [B, 1, V]
        come back."""
        cfg = self.cfg
        t = tokens.shape[1]
        if cfg.decode and cache is None:
            raise ValueError("a decode config runs with a cache: pass "
                             "cache=model.init_cache(batch)")
        first, positions = 0, None
        if cache is not None:
            first = cache.wpe_index
            cache.wpe_index += t
        elif _seq_parallel(cfg):
            first = cfg.mesh.coordinate(cfg.ring_axis) * t
            positions = torch.arange(first, first + t, device=tokens.device)
        if self.vocab_tp is None:
            x = lookup(self.wte.weight, tokens)
        else:
            x = vocab_parallel_embedding(tokens, self.wte.weight,
                                         self.vocab_tp)
        if self.wpe is not None:
            x = x + self.wpe[None, first:first + t, :]
        x = x.to(cfg.dtype)
        if cache is not None:
            for block, layer in zip(self.blocks, cache.layers):
                x = block(x, cache=layer)
            # generation reads the last position alone
            x = x[:, -1:]
        else:
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


def lookup(table, tokens):
    """The rows of `table` at `tokens` (an embedding lookup), with a table
    gradient that repeats bit for bit on the card.  torch's CUDA embedding
    backward adds the partial sums of a row that many tokens hit (BERT's
    type embedding: every one of its B*T token types is 0) in an order that
    varies between runs; advanced indexing accumulates through index_put_,
    which sorts the tokens and sums each row's cotangents in token order.
    On the CPU it is `F.embedding`, whose backward is serial."""
    if table.is_cuda:
        return table[tokens]
    return F.embedding(tokens, table)


def vocab_parallel_embedding(tokens, table, tp):
    """The rows of a vocab-sharded embedding: each rank looks up the
    tokens in its slice (zero for the others), summed over the tp group."""
    start = tp.rank * table.shape[0]
    local = tokens - start
    inside = (local >= 0) & (local < table.shape[0])
    rows = lookup(table, torch.where(inside, local, 0))
    return reduce_from_group(tp.group,
                             torch.where(inside[..., None], rows, 0.0))


class BertEncoder(nn.Module):
    """BERT-base-style bidirectional encoder with a classification head:
    `forward(tokens, token_types=None)` returns {"sequence_output" (the
    final norm's f32 output; under sp this rank's slice), "logits"
    (f32)}."""

    # the tensor-parallel group when this rank holds a slice of the vocab
    vocab_tp = None

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
        """tokens [B, T]: the whole sequence, or under sequence parallelism
        this rank's slice of it (positions [i*T, (i+1)*T) on rank i)."""
        cfg = self.cfg
        t = tokens.shape[1]
        first = cfg.mesh.coordinate(cfg.ring_axis) * t \
            if _seq_parallel(cfg) else 0
        if token_types is None:
            token_types = torch.zeros_like(tokens)
        if self.vocab_tp is None:
            x = lookup(self.tok_emb.weight, tokens)
        else:
            x = vocab_parallel_embedding(tokens, self.tok_emb.weight,
                                         self.vocab_tp)
        x = (x + lookup(self.type_emb.weight, token_types)
             + self.pos_emb[None, first:first + t, :])
        x = self.emb_ln(x).to(cfg.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        cls = torch.tanh(self.pooler(first_of_sequence(cfg, x)))
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
