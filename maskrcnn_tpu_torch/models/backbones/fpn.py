"""FPN neck on ResNet-50 (port of ``maskrcnn_tpu/models/backbones/fpn.py``).

Reference quirks kept: nearest ×2 upsample in the top-down path, lateral
1×1 then a 3×3 conv after the sum, and P6 as a 1×1 stride-2 conv on P5
(flax's SAME padding gives ``ceil(H/2)``; an unpadded stride-2 1×1 conv
gives the same).

``remat`` checkpoints the whole backbone (``torch.utils.checkpoint``, as the
JAX package wraps the backbone class in ``nn.remat``): only its input and
outputs are kept for the backward, which runs the forward again. The
recomputation holds the BatchNorm statistics, so a trainable BatchNorm
updates them once per forward, as JAX's functional remat does.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from maskrcnn_tpu_torch.models.backbones.resnet import ResNet50, statistics_held
from maskrcnn_tpu_torch.models.layers import Conv2d


def upsample2x_nearest(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPNBackbone(nn.Module):
    """ResNet-50 + FPN → [P2, P3, P4, P5, P6] (NCHW), all ``channels`` wide,
    in ``dtype``."""

    feat_strides = (4, 8, 16, 32, 64)

    def __init__(self, channels: int = 256, frozen_bn: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnet = ResNet50(frozen_bn, dtype)

        def conv(cin, k, stride=1):
            return Conv2d(cin, channels, k, stride=stride, padding=k // 2,
                          compute_dtype=dtype)

        self.toplayer = conv(2048, 1)
        self.lat_p4 = conv(1024, 1)
        self.lat_p3 = conv(512, 1)
        self.lat_p2 = conv(256, 1)
        self.conv_p4 = conv(channels, 3)
        self.conv_p3 = conv(channels, 3)
        self.conv_p2 = conv(channels, 3)
        self.conv_p6 = Conv2d(channels, channels, 1, stride=2,
                              compute_dtype=dtype)

    def forward(self, x, train: bool = False):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(
                self._pyramid, x, train, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(),
                                    statistics_held(self)))
        return self._pyramid(x, train)

    def _pyramid(self, x, train: bool):
        c2, c3, c4, c5 = self.resnet(x, train)
        p5 = self.toplayer(c5)
        p4 = self.conv_p4(upsample2x_nearest(p5) + self.lat_p4(c4))
        p3 = self.conv_p3(upsample2x_nearest(p4) + self.lat_p3(c3))
        p2 = self.conv_p2(upsample2x_nearest(p3) + self.lat_p2(c2))
        return [p2, p3, p4, p5, self.conv_p6(p5)]
