"""FPN neck on ResNet-50 (port of ``maskrcnn_tpu/models/backbones/fpn.py``).

Reference quirks kept: nearest ×2 upsample in the top-down path, lateral
1×1 then a 3×3 conv after the sum, and P6 as a 1×1 stride-2 conv on P5
(flax's SAME padding gives ``ceil(H/2)``; an unpadded stride-2 1×1 conv
gives the same).
"""

from __future__ import annotations

from torch import nn
from torch.nn import functional as F

from maskrcnn_tpu_torch.models.backbones.resnet import ResNet50


def upsample2x_nearest(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FPNBackbone(nn.Module):
    """ResNet-50 + FPN → [P2, P3, P4, P5, P6] (NCHW), all ``channels`` wide."""

    feat_strides = (4, 8, 16, 32, 64)

    def __init__(self, channels: int = 256):
        super().__init__()
        self.resnet = ResNet50()
        self.toplayer = nn.Conv2d(2048, channels, 1)
        self.lat_p4 = nn.Conv2d(1024, channels, 1)
        self.lat_p3 = nn.Conv2d(512, channels, 1)
        self.lat_p2 = nn.Conv2d(256, channels, 1)
        self.conv_p4 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv_p3 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv_p2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.conv_p6 = nn.Conv2d(channels, channels, 1, stride=2)

    def forward(self, x):
        c2, c3, c4, c5 = self.resnet(x)
        p5 = self.toplayer(c5)
        p4 = self.conv_p4(upsample2x_nearest(p5) + self.lat_p4(c4))
        p3 = self.conv_p3(upsample2x_nearest(p4) + self.lat_p3(c3))
        p2 = self.conv_p2(upsample2x_nearest(p3) + self.lat_p2(c2))
        return [p2, p3, p4, p5, self.conv_p6(p5)]
