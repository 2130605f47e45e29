"""ResNet-50 bottom-up backbone (port of
``maskrcnn_tpu/models/backbones/resnet.py``).

Caffe/chainer conventions kept: the downsampling stride sits on the FIRST
1×1 conv of each stage's first block, the stem is a 7×7/2 conv then a 2×2/2
max-pool, and BatchNorm is frozen with eps 2e-5. The stem is the direct
7×7/2 conv with padding 3; the JAX package's space-to-depth stem computes
the same sums from the same ``(7, 7, 3, 64)`` kernel.

Modules take NCHW tensors (the model keeps them ``channels_last``). Module
names follow the flax tree (``Conv_k`` → ``conv{k}``, ``Norm_k`` →
``bn{k}``) so the weight bridge is a renaming.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm on running statistics only (flax ``use_running_average``):
    freezing fixes the statistics, not the affine. ``weight`` and ``bias``
    are parameters, as flax's ``scale``/``bias`` are, so training gives them
    gradients and weight decay; the module ignores ``train()``/``eval()``."""

    def __init__(self, channels: int, eps: float = 2e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


def _conv(cin, cout, k, stride=1, bias=False):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int = 1):
        super().__init__()
        self.conv0 = _conv(cin, mid, 1, stride)
        self.bn0 = FrozenBatchNorm2d(mid)
        self.conv1 = _conv(mid, mid, 3)
        self.bn1 = FrozenBatchNorm2d(mid)
        self.conv2 = _conv(mid, out, 1)
        self.bn2 = FrozenBatchNorm2d(out)
        if cin != out or stride != 1:
            self.proj = _conv(cin, out, 1, stride)
            self.proj_bn = FrozenBatchNorm2d(out)
        else:
            self.proj = None

    def forward(self, x):
        h = F.relu(self.bn0(self.conv0(x)))
        h = F.relu(self.bn1(self.conv1(h)))
        h = self.bn2(self.conv2(h))
        residual = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu(h + residual)


class ResStage(nn.Sequential):
    def __init__(self, n_blocks: int, cin: int, mid: int, out: int, stride: int):
        super().__init__()
        for i in range(n_blocks):
            self.add_module(f"block{i}", Bottleneck(
                cin if i == 0 else out, mid, out, stride if i == 0 else 1))


class ResNet50(nn.Module):
    """Returns (c2, c3, c4, c5) at strides 4/8/16/32."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.res2 = ResStage(3, 64, 64, 256, 1)
        self.res3 = ResStage(4, 256, 128, 512, 2)
        self.res4 = ResStage(6, 512, 256, 1024, 2)
        self.res5 = ResStage(3, 1024, 512, 2048, 2)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 2, 2)
        c2 = self.res2(h)
        c3 = self.res3(c2)
        c4 = self.res4(c3)
        return c2, c3, c4, self.res5(c4)
