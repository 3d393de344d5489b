"""flax's default initialisers, drawn from a torch generator."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# flax's truncated normal keeps [-2, 2] standard deviations; this is the
# standard deviation of the unit normal truncated there
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(p: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's lecun_normal (the default of `nn.Dense` and `nn.Conv`): a
    normal of variance 1 / fan_in truncated to two standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
