"""ResNet-50 bottom-up backbone (port of
``maskrcnn_tpu/models/backbones/resnet.py``).

Caffe/chainer conventions kept: the downsampling stride sits on the FIRST
1×1 conv of each stage's first block, the stem is a 7×7/2 conv then a 2×2/2
max-pool, and BatchNorm has eps 2e-5 (frozen unless ``frozen_bn=False``).
The stem is the direct 7×7/2 conv with padding 3; the JAX package's
space-to-depth stem computes the same sums from the same ``(7, 7, 3, 64)``
kernel.

Every conv computes in ``dtype`` (float32 parameters cast per call, as
flax's ``dtype=``), so with bfloat16 the activations, the residual adds and
the BatchNorm outputs are bf16 and each BatchNorm reduces in float32.
Modules take NCHW tensors (the model keeps them ``channels_last``) and the
``train`` flag as an argument, as the flax modules do. Module names follow
the flax tree (``Conv_k`` → ``conv{k}``, ``Norm_k`` → ``bn{k}``) so the
weight bridge is a renaming.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.layers import Conv2d


class Norm(nn.Module):
    """BatchNorm as the JAX package's ``Norm`` (flax ``nn.BatchNorm``,
    momentum 0.9, eps 2e-5), NCHW.

    Frozen, or not training: the running statistics. Training and not
    frozen: the batch statistics over (N, H, W), in float32 with flax's fast
    variance ``E[x²] − E[x]²`` clipped at 0, and the running statistics
    move to ``0.9·running + 0.1·batch`` with the biased variance (which
    ``torch.nn.BatchNorm2d`` does not do). ``weight`` and ``bias`` are
    parameters either way, as flax's ``scale``/``bias`` are, so training
    gives them gradients and weight decay. The output is cast to ``dtype``.
    ``update_stats`` is cleared while a checkpointed backbone recomputes its
    forward, so the statistics move once per forward."""

    momentum = 0.9

    def __init__(self, channels: int, frozen: bool = True,
                 dtype: torch.dtype = torch.float32, eps: float = 2e-5):
        super().__init__()
        self.frozen, self.dtype, self.eps = frozen, dtype, eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.frozen or not train:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean.detach() * (1.0 - m))
                    self.running_var.mul_(m).add_(var.detach() * (1.0 - m))
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.dtype)


@contextlib.contextmanager
def _norms_flagged(module: nn.Module, flag: str, value: bool):
    """Inside, every :class:`Norm` of ``module`` has ``flag`` set to
    ``value``; after, to ``not value``."""
    norms = [m for m in module.modules() if isinstance(m, Norm)]
    for m in norms:
        setattr(m, flag, value)
    try:
        yield
    finally:
        for m in norms:
            setattr(m, flag, not value)


def statistics_held(module: nn.Module):
    """Inside, no :class:`Norm` of ``module`` moves its running statistics:
    for the recomputation of a checkpointed forward."""
    return _norms_flagged(module, "update_stats", False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int = 1,
                 frozen_bn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()

        def conv(ci, co, k, s=1):
            return Conv2d(ci, co, k, stride=s, padding=k // 2, bias=False,
                          compute_dtype=dtype)

        def norm(c):
            return Norm(c, frozen_bn, dtype)

        self.conv0, self.bn0 = conv(cin, mid, 1, stride), norm(mid)
        self.conv1, self.bn1 = conv(mid, mid, 3), norm(mid)
        self.conv2, self.bn2 = conv(mid, out, 1), norm(out)
        if cin != out or stride != 1:
            self.proj, self.proj_bn = conv(cin, out, 1, stride), norm(out)
        else:
            self.proj = None

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn0(self.conv0(x), train))
        h = F.relu(self.bn1(self.conv1(h), train))
        h = self.bn2(self.conv2(h), train)
        residual = x if self.proj is None else self.proj_bn(self.proj(x), train)
        return F.relu(h + residual.to(h.dtype))


class ResStage(nn.Module):
    def __init__(self, n_blocks: int, cin: int, mid: int, out: int,
                 stride: int, frozen_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(n_blocks):
            self.add_module(f"block{i}", Bottleneck(
                cin if i == 0 else out, mid, out, stride if i == 0 else 1,
                frozen_bn, dtype))

    def forward(self, x, train: bool = False):
        for block in self.children():
            x = block(x, train)
        return x


class ResNet50(nn.Module):
    """Returns (c2, c3, c4, c5) at strides 4/8/16/32, in ``dtype``; with
    ``include_c5=False`` (the C4 backbone) (c2, c3, c4) and no res5."""

    def __init__(self, frozen_bn: bool = True,
                 dtype: torch.dtype = torch.float32, include_c5: bool = True):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = Norm(64, frozen_bn, dtype)
        args = (frozen_bn, dtype)
        self.res2 = ResStage(3, 64, 64, 256, 1, *args)
        self.res3 = ResStage(4, 256, 128, 512, 2, *args)
        self.res4 = ResStage(6, 512, 256, 1024, 2, *args)
        self.res5 = ResStage(3, 1024, 512, 2048, 2, *args) if include_c5 else None

    def forward(self, x, train: bool = False):
        h = F.relu(self.bn1(self.conv1(x), train))
        h = F.max_pool2d(h, 2, 2)
        c2 = self.res2(h, train)
        c3 = self.res3(c2, train)
        c4 = self.res4(c3, train)
        if self.res5 is None:
            return c2, c3, c4
        return c2, c3, c4, self.res5(c4, train)


class Res5Stage(nn.Module):
    """res5 on its own with every stride 1, for the Res5 ROI head: 1024 →
    2048 channels at the input's size, parameters under ``res5`` as in the
    flax tree (``head/res5/res5``)."""

    def __init__(self, frozen_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.res5 = ResStage(3, 1024, 512, 2048, 1, frozen_bn, dtype)

    def forward(self, x, train: bool = False):
        return self.res5(x, train)
