"""Layers that compute in a chosen dtype, as flax's ``dtype=`` does.

The parameters stay float32; each call casts its input, weight and bias to
``compute_dtype`` and returns that dtype (flax ``nn.Conv``/``nn.Dense`` with
``dtype=bfloat16``). The dtype is explicit per module rather than left to
``torch.autocast``, whose per-op policy would run the BatchNorms and the
residual adds in float32 where the JAX package rounds to bf16 after each.
At float32 every cast is a no-op.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """``cfg.model.dtype`` → torch dtype; anything else raises."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: the port computes in "
                         f"{' or '.join(DTYPES)}")
    return DTYPES[name]


def _cast(p, dt):
    return None if p is None else p.to(dt)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))
