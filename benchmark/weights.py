"""Weights made on the device from the seed, the same for the program and
the reference.

Every kernel of a conv, transposed conv or dense layer (and the mask head's
final 1×1 kernel) is LeCun normal: a unit normal clipped to ±2 over the
truncated normal's standard deviation, times ``sqrt(1 / fan_in)``, as the
port's own initializer draws it. Biases stay 0 and BatchNorm at scale 1,
bias 0, mean 0, variance 1. All the draws are one ``torch.randn`` call of a
``torch.Generator`` on the device; each kernel is a slice of it, taken in
the order of the reference model's parameters, so one seed gives one set
of weights on any device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.data import chosen_load
from benchmark.reference.maskrcnn import MaskRCNN

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fan_ins(model: nn.Module) -> dict:
    """Parameter name → fan-in, for every kernel that is drawn."""
    out = {}
    for prefix, m in model.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(m, nn.ConvTranspose2d):
            out[f"{dot}weight"] = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        elif isinstance(m, nn.Conv2d):
            out[f"{dot}weight"] = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        elif isinstance(m, nn.Linear):
            out[f"{dot}weight"] = m.in_features
        elif hasattr(m, "conv2_weight"):
            out[f"{dot}conv2_weight"] = m.conv2_weight.shape[1]
    return out


def make_weights(ref_cfg, seed: int, device, load: str | None = None) -> dict:
    """Parameter name → float32 tensor on ``device`` for every parameter of
    the configuration's model, with the chosen ``load`` (a name in
    :data:`benchmark.data.LOADS`, or of a file under ``benchmark/loads/``)
    applied."""
    shell = MaskRCNN(ref_cfg, device="meta")
    fan = _fan_ins(shell)
    params = dict(shell.named_parameters())
    drawn = [(name, p.shape) for name, p in params.items() if name in fan]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    weights, at = {}, 0
    for name, shape in drawn:
        n = math.prod(shape)
        std = math.sqrt(1.0 / fan[name]) / _TRUNC_STD
        weights[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, p in params.items():
        if name not in weights:
            init = torch.ones if name.endswith("weight") else torch.zeros
            weights[name] = init(p.shape, device=device)
    if load is not None:
        chosen_load(load)(weights)
    return weights


def load_into(model: nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``model``'s parameters in place; every
    parameter must be named."""
    params = dict(model.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"parameters that do not match: {sorted(missing)[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
