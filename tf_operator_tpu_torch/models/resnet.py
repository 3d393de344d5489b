"""ResNet-v1.5 family (ResNet-18/34/50/101/152), the training path.

The counterpart of `tf_operator_tpu/models/resnet.py` (BASELINE config 3),
with the flax numerics kept where PyTorch's defaults differ:
  * convolutions compute in `dtype` (bf16 by default) with f32 weights, and
    pad as flax's "SAME" does: total = max((ceil(n/s) - 1) * s + k - n, 0),
    low = total // 2, so a stride-2 3x3 conv pads (0, 1) on even sizes and
    (1, 1) on odd ones; the stem pads (3, 3) and its max-pool pads with -inf;
  * `BatchNorm` is flax's: momentum 0.9 on the running statistics, eps 1e-5,
    the biased variance E[x^2] - E[x]^2 both to normalise and to update the
    running variance, statistics and output in f32 (so the activations
    between a BatchNorm and the next conv, and the residual sum, are f32);
  * the last BatchNorm of each block starts with a zero scale, convs and
    the f32 head start lecun-normal, as flax's initialisers do.

Images arrive NHWC, as in the reference; `x.permute(0, 3, 1, 2)` of a
contiguous NHWC tensor is the channels_last layout, which cuDNN takes as
it is.  With `bn_group` (a process group, the data-parallel axis) the batch
statistics are those of every rank's rows together, as the JAX step's
one jit over the globally sharded batch computes them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.dist import all_reduce
from .initializers import lecun_normal_

MOMENTUM = 0.9
EPS = 1e-5


def same_padding(n: int, k: int, s: int):
    """(low, high) padding of flax/XLA "SAME" for size n, kernel k, stride
    s."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv(use_bias=False, dtype=...)`: input and f32 weight cast
    to the compute dtype; weight stored OIHW."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x):
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            (top, bottom), (left, right) = (
                same_padding(n, k, self.stride) for n in x.shape[2:])
        else:
            (top, bottom), (left, right) = self.padding
        x = x.to(self.dtype)
        if (top, left) == (bottom, right):
            pad = (top, left)
        else:
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=pad)


def update_running(running_mean, running_var, mean, var, count: int):
    """flax's update of the running statistics: momentum 0.9 toward the
    batch's mean and its biased variance (`count`, the rows the statistics
    are over, is not used: torch would scale by count / (count - 1))."""
    running_mean.mul_(MOMENTUM).add_(mean, alpha=1 - MOMENTUM)
    running_var.mul_(MOMENTUM).add_(var, alpha=1 - MOMENTUM)


class _Moments(torch.autograd.Function):
    """Per channel (sum x, sum x^2) in f32 of x [B, C, H, W].  Its backward
    adds the gradient through the statistics to the one `_Normalize` left
    in `box`, in f32, and rounds the sum to x's dtype once (as the
    reference's cast of x to f32 does)."""

    @staticmethod
    def forward(ctx, x, box):
        ctx.save_for_backward(x)
        ctx.box = box
        xf = x.float()
        return torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx = ctx.box.pop("dx")
        dx = dx + g[0].view(1, -1, 1, 1) + \
            2 * x.float() * g[1].view(1, -1, 1, 1)
        return dx.to(x.dtype), None


def _mean_var(stats, count: int):
    mean = stats[0] / count
    return mean, (stats[1] / count - mean * mean).clamp_min(0.0)


class _Normalize(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * scale + bias in f32, mean and var
    from the (all-reduced) sums over `count` rows.  Saves x as it came (the
    conv's bf16 output), not an f32 copy.  Its gradient for x through the
    statistics flows back through `stats`; the direct term dy * mul is left
    in `box` for `_Moments` to add."""

    @staticmethod
    def forward(ctx, x, stats, count, scale, bias, box):
        mean, var = _mean_var(stats, count)
        rstd = torch.rsqrt(var + EPS)
        mul = rstd * scale
        ctx.save_for_backward(x, stats, scale, mean, rstd)
        ctx.count, ctx.box = count, box
        return (x.float() - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + bias.view(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        x, stats, scale, mean, rstd = ctx.saved_tensors
        n = ctx.count
        dims = (0, 2, 3)
        mul = rstd * scale
        ctx.box["dx"] = dy * mul.view(1, -1, 1, 1)
        dbias = dy.sum(dims)
        dmul = (dy * (x.float() - mean.view(1, -1, 1, 1))).sum(dims)
        dscale = dmul * rstd
        dvar = dmul * scale * (-0.5) * rstd ** 3
        dvar = torch.where(stats[1] / n - mean * mean > 0, dvar,
                           torch.zeros_like(dvar))
        dmean = -mul * dbias - 2 * mean * dvar
        dstats = torch.stack([dmean / n, dvar / n])
        return None, dstats, None, dscale, dbias, None


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)` over
    the channel dim of NCHW input; returns f32.  In training mode it
    normalises with the batch's statistics (over `group`'s ranks when it is
    set) and moves the running statistics toward them; in eval mode it
    uses the running statistics and changes nothing."""

    def __init__(self, features: int, zero_scale: bool = False, group=None):
        super().__init__()
        self.zero_scale, self.group = zero_scale, group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            mul = torch.rsqrt(self.running_var + EPS) * self.weight
            return (x.float() - self.running_mean.view(1, -1, 1, 1)) * \
                mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        box = {}
        stats = _Moments.apply(x, box)
        count = x.numel() // x.shape[1]
        if self.group is not None:
            stats = all_reduce(self.group, stats)
            count *= torch.distributed.get_world_size(self.group)
        with torch.no_grad():
            update_running(self.running_mean, self.running_var,
                           *_mean_var(stats, count), count)
        return _Normalize.apply(x, stats, count, self.weight, self.bias, box)


class _Block(nn.Module):
    """A residual block: conv -> norm (-> relu) for each of `convs`, the
    last without relu, plus the shortcut, which the reference projects
    (1x1 conv + norm) where its shape differs from the block's output."""

    def __init__(self, convs, norms, cin: int, cout: int, stride: int, dtype,
                 group):
        super().__init__()
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.conv_proj = self.norm_proj = None
        if cin != cout or stride != 1:
            self.conv_proj = Conv(cin, cout, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(cout, group=group)

    def forward(self, x):
        y = x
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < last:
                y = F.relu(y)
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    """1x1 -> 3x3 -> 1x1 bottleneck with identity shortcut (v1.5: stride on
    the 3x3)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, dtype, group):
        cout = filters * 4
        super().__init__(
            [Conv(cin, filters, 1, dtype=dtype),
             Conv(filters, filters, 3, stride, dtype=dtype),
             Conv(filters, cout, 1, dtype=dtype)],
            [BatchNorm(filters, group=group), BatchNorm(filters, group=group),
             BatchNorm(cout, zero_scale=True, group=group)],
            cin, cout, stride, dtype, group)


class ResNetBlock(_Block):
    """Basic 3x3 + 3x3 block for ResNet-18/34."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, dtype, group):
        super().__init__(
            [Conv(cin, filters, 3, stride, dtype=dtype),
             Conv(filters, filters, 3, dtype=dtype)],
            [BatchNorm(filters, group=group),
             BatchNorm(filters, zero_scale=True, group=group)],
            cin, filters, stride, dtype, group)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, bn_group=None):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, padding=((3, 3), (3, 3)),
                              dtype=dtype)
        self.bn_init = BatchNorm(num_filters, group=bn_group)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block_cls(cin, filters,
                                        2 if i > 0 and j == 0 else 1,
                                        dtype, bn_group))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise as the flax model does, drawing from `generator`."""
        for module in self.modules():
            if isinstance(module, (Conv, BatchNorm)):
                module.reset_parameters(generator)
        lecun_normal_(self.head.weight, self.head.in_features, generator)
        with torch.no_grad():
            self.head.bias.zero_()

    def forward(self, images):
        """images [B, H, W, 3] (NHWC) -> logits [B, classes] in f32."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.bn_init(self.conv_init(x)))
        (top, bottom), (left, right) = (same_padding(n, 3, 2)
                                        for n in x.shape[2:])
        x = F.pad(x, (left, right, top, bottom), value=-math.inf)
        x = F.max_pool2d(x, 3, 2)
        for block in self.blocks:
            x = block(x)
        return self.head(x.mean((2, 3)))


def _preset(stages, block_cls):
    def make(**kwargs) -> ResNet:
        return ResNet(stages, block_cls, **kwargs)
    return make


ResNet18 = _preset([2, 2, 2, 2], ResNetBlock)
ResNet34 = _preset([3, 4, 6, 3], ResNetBlock)
ResNet50 = _preset([3, 4, 6, 3], BottleneckBlock)
ResNet101 = _preset([3, 4, 23, 3], BottleneckBlock)
ResNet152 = _preset([3, 8, 36, 3], BottleneckBlock)
