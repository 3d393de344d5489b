"""Vision Transformer: patch embedding over the shared encoder stack.

The counterpart of `tf_operator_tpu/models/vit.py` (Dosovitskiy et al.,
arXiv:2010.11929): conv patchify -> prepend CLS -> learned positions ->
pre-norm encoder `Block`s (non-causal attention, so the flash kernels run
without the causal mask) -> LayerNorm -> f32 head on CLS.  flax creates the
position table at the first call from the image it sees; here its size
comes from `image_size`, and an image of another size is refused.

Under tp the blocks run Megatron's layout (`models/transformer.py`).  Under
sp every rank embeds the whole image and keeps its slice of the
patches + CLS tokens, which must divide by the sp axis size (the JAX ring
requires it too); the ring runs non-causal and the CLS row, which sp rank 0
holds, reaches the head on every rank (`first_of_sequence`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import lecun_normal_
from .transformer import (Block, Dense, Norm, TransformerConfig, _normal_,
                          _seq_parallel, first_of_sequence)


class ViT(nn.Module):
    """cfg.max_len must cover num_patches + 1 (CLS); cfg.causal False."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 1000,
                 patch_size: int = 16, image_size: int = 224):
        super().__init__()
        if cfg.causal:
            raise ValueError(
                "ViT needs causal=False (a causal mask over raster-order "
                "patches silently degrades the model); use vit_base_config")
        p = patch_size
        if image_size % p:
            raise ValueError(
                f"image {image_size}x{image_size} not divisible by patch "
                f"size {p}")
        num_patches = (image_size // p) ** 2
        if num_patches + 1 > cfg.max_len:
            raise ValueError(
                f"{num_patches} patches + CLS exceed max_len {cfg.max_len}")
        self.cfg, self.patch_size, self.image_size = cfg, p, image_size
        d = cfg.d_model
        self.patch_embed = nn.Conv2d(3, d, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_emb = nn.Parameter(torch.empty(num_patches + 1, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = Norm(cfg.norm, d)
        self.head = nn.Linear(d, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise as the flax model does: patch conv and head
        lecun-normal with zero biases, CLS zero, positions and the blocks'
        kernels N(0, 0.02)."""
        lecun_normal_(self.patch_embed.weight,
                      self.patch_embed.weight[0].numel(), generator)
        lecun_normal_(self.head.weight, self.head.in_features, generator)
        with torch.no_grad():
            self.patch_embed.bias.zero_()
            self.head.bias.zero_()
            self.cls_token.zero_()
        _normal_(self.pos_emb, generator)
        for module in self.modules():
            if isinstance(module, (Dense, Norm)):
                module.reset_parameters(generator)

    def forward(self, images):
        """images [B, H, W, 3] (NHWC) -> logits [B, classes] in f32."""
        cfg = self.cfg
        b, height, width, _ = images.shape
        if (height, width) != (self.image_size,) * 2:
            raise ValueError(
                f"image {height}x{width}: this ViT's position table is for "
                f"{self.image_size}x{self.image_size}")
        w = self.patch_embed.weight
        x = F.conv2d(images.permute(0, 3, 1, 2).to(cfg.dtype),
                     w.to(cfg.dtype), self.patch_embed.bias.to(cfg.dtype),
                     stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, patches, d], raster order
        cls = self.cls_token.expand(b, 1, cfg.d_model).to(x.dtype)
        x = torch.cat([cls, x], dim=1)
        x = (x + self.pos_emb[None].to(x.dtype)).to(cfg.dtype)
        if _seq_parallel(cfg):
            n, t = cfg.mesh.shape[cfg.ring_axis], x.shape[1]
            if t % n:
                raise ValueError(
                    f"{t} tokens (patches + CLS) do not divide by the "
                    f"{cfg.ring_axis} axis size {n}: ring attention needs "
                    "T divisible by the sp axis size")
            s = cfg.mesh.coordinate(cfg.ring_axis)
            x = x[:, s * t // n:(s + 1) * t // n]
        for block in self.blocks:
            x = block(x)
        return self.head(first_of_sequence(cfg, self.ln_f(x)))


def vit_base_config(**overrides) -> TransformerConfig:
    """ViT-B/16 shape: 12 layers, 12 heads, d=768, ff=3072; 224x224/16
    -> 196 patches + CLS."""
    base = dict(
        vocab_size=1,  # unused (no token embedding)
        num_layers=12, num_heads=12, d_model=768, d_ff=3072,
        max_len=256, causal=False,
    )
    base.update(overrides)
    return TransformerConfig(**base)
