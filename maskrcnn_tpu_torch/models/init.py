"""Seeded random init matching the JAX package's initializers.

Kernels are lecun-normal (flax's: truncated normal over two standard
deviations, variance 1/fan_in), biases zero, frozen BatchNorm at scale 1,
bias 0, mean 0, var 1. Draws come from an explicit ``torch.Generator`` in
module registration order, so one seed gives one set of weights on any
device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from maskrcnn_tpu_torch.models.heads.fpn_heads import MaskBranch

# std of a unit normal truncated to [-2, 2] (flax's variance correction)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int, gen: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Initialize every conv, transposed conv and linear layer of ``model``
    and the mask head's final 1×1 kernel in place (on the CPU; move the
    model afterwards). Frozen BN keeps its constructor's statistics."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            weight = m.weight
        elif isinstance(m, nn.Linear):
            fan_in, weight = m.in_features, m.weight
        elif isinstance(m, MaskBranch):
            fan_in, weight = m.conv2_weight.shape[1], m.conv2_weight
        else:
            continue
        lecun_normal_(weight, fan_in, gen)
        if getattr(m, "bias", None) is not None:
            nn.init.zeros_(m.bias)
