"""The backbones (port of ``maskrcnn_tpu/models/backbones/fpn.py``): the FPN
neck on ResNet-50, the C4 backbone, ResNet-50 cut at res4 (one level of
1024 channels at stride 16), and the Darknet backbone, five 3×3 convs (one
level of 256 channels at stride 16), chosen by :func:`build_backbone`.

Reference quirks kept: nearest ×2 upsample in the top-down path, lateral
1×1 then a 3×3 conv after the sum, and P6 as a 1×1 stride-2 conv on P5
(flax's SAME padding gives ``ceil(H/2)``; an unpadded stride-2 1×1 conv
gives the same).

``remat`` checkpoints any whole backbone (``torch.utils.checkpoint``, as the
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

from benchmark.reference.resnet import (
    Norm,
    ResNet50,
    statistics_held,
)
from benchmark.reference.layers import Conv2d


def _run(backbone: nn.Module, fn, x, train: bool):
    """``fn(x, train)``, checkpointed when the backbone remats and autograd
    records. Nothing random runs in the region, so the recompute needs no
    saved RNG state (``preserve_rng_state=False``), and reading the RNG
    state would stop the card from capturing the step into a CUDA graph."""
    if backbone.remat and torch.is_grad_enabled():
        return checkpoint(
            fn, x, train, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                statistics_held(backbone)))
    return fn(x, train)


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
        return _run(self, self._pyramid, x, train)

    def _pyramid(self, x, train: bool):
        c2, c3, c4, c5 = self.resnet(x, train)
        p5 = self.toplayer(c5)
        p4 = self.conv_p4(upsample2x_nearest(p5) + self.lat_p4(c4))
        p3 = self.conv_p3(upsample2x_nearest(p4) + self.lat_p3(c3))
        p2 = self.conv_p2(upsample2x_nearest(p3) + self.lat_p2(c2))
        return [p2, p3, p4, p5, self.conv_p6(p5)]


class C4Backbone(nn.Module):
    """ResNet-50 truncated at res4 → [C4] (NCHW), 1024 channels at stride
    16, in ``dtype``."""

    feat_strides = (16,)

    def __init__(self, frozen_bn: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resnet = ResNet50(frozen_bn, dtype, include_c5=False)

    def forward(self, x, train: bool = False):
        return _run(self, self._c4, x, train)

    def _c4(self, x, train: bool):
        return [self.resnet(x, train)[2]]


class ConvBN(nn.Module):
    """3×3 conv with bias → BatchNorm → ReLU. The BatchNorm always trains
    (``Norm(frozen=False)``, as the reference's Darknet does), whatever
    ``model.freeze_bn`` says. Named ``conv0``/``bn0`` after flax's
    ``Conv_0``/``Norm_0``."""

    def __init__(self, cin: int, out: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv0 = Conv2d(cin, out, 3, padding=1, compute_dtype=dtype)
        self.bn0 = Norm(out, frozen=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn0(self.conv0(x), train))


class DarknetBackbone(nn.Module):
    """Five :class:`ConvBN` of 16, 32, 64, 128 and 256 channels, a 2×2/2
    max-pool (floor, as flax's VALID pool) after each of the first four →
    [one level] (NCHW), 256 channels at stride 16, in ``dtype``."""

    feat_strides = (16,)
    widths = (16, 32, 64, 128, 256)

    def __init__(self, dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.remat = remat
        for i, (cin, out) in enumerate(zip((3,) + self.widths, self.widths)):
            self.add_module(f"conv{i + 1}", ConvBN(cin, out, dtype))

    def forward(self, x, train: bool = False):
        return _run(self, self._level, x, train)

    def _level(self, x, train: bool):
        for i in range(len(self.widths)):
            x = getattr(self, f"conv{i + 1}")(x, train)
            if i < len(self.widths) - 1:
                x = F.max_pool2d(x, 2, 2)
        return [x]


def build_backbone(name: str, channels: int, frozen_bn: bool,
                   dtype: torch.dtype, remat: bool = False) -> nn.Module:
    """The backbone that ``cfg.model.backbone`` names."""
    if name == "fpn":
        return FPNBackbone(channels, frozen_bn, dtype, remat)
    if name == "c4":
        return C4Backbone(frozen_bn, dtype, remat)
    if name == "darknet":
        return DarknetBackbone(dtype, remat)
    raise ValueError(f"unknown backbone {name!r}")
