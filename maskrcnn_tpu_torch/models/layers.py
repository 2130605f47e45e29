"""Layers that compute in a chosen dtype, as flax's ``dtype=`` does.

The parameters stay float32; each call casts its input, weight and bias to
``compute_dtype`` and returns that dtype (flax ``nn.Conv``/``nn.Dense`` with
``dtype=bfloat16``). The dtype is explicit per module rather than left to
``torch.autocast``, whose per-op policy would run the BatchNorms and the
residual adds in float32 where the JAX package rounds to bf16 after each.
At float32 every cast is a no-op.

cuDNN chooses the engine of each convolution problem (the forward, and the
dgrad and wgrad of its backward) the first time it sees the problem, and
keeps it for every later call. Inside :func:`tuned_convolutions` it times
its candidates and keeps the fastest; outside, it takes the one its
heuristics rank first. The paths that replay a CUDA graph open the scope
around the eager pass that comes before the capture.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F

from maskrcnn_tpu_torch.utils import tracing

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """``cfg.model.dtype`` → torch dtype; anything else raises."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: the port computes in "
                         f"{' or '.join(DTYPES)}")
    return DTYPES[name]


def _cast(p, dt):
    return None if p is None else p.to(dt)


# How many of its heuristics' candidates cuDNN times for a problem (its
# default is 10). On an H100's float32 ResNet-50-FPN train step, 4 run
# within 3% of the default's step time and add a fifth or less of the
# 24-26 s of set-up that the default adds.
BENCHMARK_LIMIT = 4


@contextlib.contextmanager
def tuned_convolutions():
    """cuDNN times each convolution problem first run inside this scope,
    forward, dgrad and wgrad, and caches the fastest engine for it
    (``torch.backends.cudnn.benchmark`` on, ``benchmark_limit`` at
    :data:`BENCHMARK_LIMIT`; both restored on exit, and no other flag
    touched). The cache is keyed by the problem and not by the flags, so a
    graph captured afterwards, and every later call, runs the timed engine,
    and nothing is timed inside a capture."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.benchmark_limit
    cudnn.benchmark, cudnn.benchmark_limit = True, BENCHMARK_LIMIT
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = before


def _count_problem(x, weight, *geometry):
    """With tracing on: a forward convolution problem seen for the first time
    counts as ``conv_problems_tuned`` where cuDNN times it (inside
    :func:`tuned_convolutions`), else ``conv_problems_untuned``."""
    if not tracing.is_on():
        return
    layout = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
              else torch.contiguous_format)
    key = (tuple(x.shape), tuple(weight.shape), *geometry, x.dtype, layout)
    name = ("conv_problems_tuned" if torch.backends.cudnn.benchmark
            else "conv_problems_untuned")
    tracing.count_first(name, key, x.device)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        x, weight = x.to(dt), self.weight.to(dt)
        _count_problem(x, weight, "conv", self.stride, self.padding,
                       self.dilation, self.groups)
        return self._conv_forward(x, weight, _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        x, weight = x.to(dt), self.weight.to(dt)
        _count_problem(x, weight, "transposed", self.stride, self.padding,
                       self.output_padding, self.dilation, self.groups)
        return F.conv_transpose2d(x, weight, _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))
