"""MNIST models: the port's counterparts of `tf_operator_tpu/models/mnist.py`
(BASELINE configs 1, 2 and 5), at the reference widths.

`MnistMLP` is dist_mnist's network, 784 -> 500 -> 10 (397,510 parameters);
`MnistCNN` two 5x5 "SAME" convolutions (32, 64 channels), each followed by
ReLU and a VALID 2x2 max-pool of stride 2, then dense 3136 -> 1024 and
1024 -> 10 (3,274,634 parameters).  Parameters are initialised as flax does
(lecun normal kernels, zero biases) and named after the flax layers
(`Dense_0` is `dense_0`), so `models/convert.mnist_from_flax` and
`mnist_to_flax` are plain renames and transposes.

The flax CNN works in NHWC; this one convolves in NCHW and flattens the
[7, 7, 64] maps in flax's order (height, width, channel) before `dense_0`,
so one set of weights gives the same logits in both.  Dropout follows the
flax call's `train` argument, not `Module.training` (which the train step
sets): the JAX workload calls the CNN with `train=False`, so its dropout
never runs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .initializers import lecun_normal_


def _reset_flax(layers, generator: Optional[torch.Generator]) -> None:
    """lecun normal kernels and zero biases, drawn on the CPU from
    `generator` in the layers' order, so one seed gives the same weights on
    every device."""
    with torch.no_grad():
        for layer in layers:
            w = torch.empty(layer.weight.shape)
            lecun_normal_(w, layer.weight[0].numel(), generator)
            layer.weight.copy_(w)
            layer.bias.zero_()


class MnistMLP(nn.Module):
    """The dist_mnist.py network: one 500-unit hidden layer."""

    def __init__(self, hidden: int = 500, num_classes: int = 10,
                 device=None, dtype=torch.float32) -> None:
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.dense_0 = nn.Linear(784, hidden, **kw)
        self.dense_1 = nn.Linear(hidden, num_classes, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_flax((self.dense_0, self.dense_1), generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.dense_1(F.relu(self.dense_0(x)))


class MnistCNN(nn.Module):
    """The mnist_with_summaries-style convnet (two conv + two dense)."""

    def __init__(self, num_classes: int = 10, device=None,
                 dtype=torch.float32) -> None:
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        # "SAME" for a 5x5 stride-1 convolution pads 2 on every side
        self.conv_0 = nn.Conv2d(1, 32, 5, padding=2, **kw)
        self.conv_1 = nn.Conv2d(32, 64, 5, padding=2, **kw)
        self.dense_0 = nn.Linear(7 * 7 * 64, 1024, **kw)
        self.dense_1 = nn.Linear(1024, num_classes, **kw)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset_flax((self.conv_0, self.conv_1, self.dense_0, self.dense_1),
                    generator)

    @staticmethod
    def flatten(x):
        """[B, C, H, W] maps -> [B, H * W * C] rows in flax's NHWC order."""
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x, train: bool = True):
        if x.ndim == 2:
            x = x.reshape(x.shape[0], 28, 28, 1)
        elif x.ndim == 3:
            x = x[..., None]
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv_1(x)), 2, 2)
        x = F.relu(self.dense_0(self.flatten(x)))
        if train:
            x = F.dropout(x, 0.5, training=True)
        return self.dense_1(x)
