"""The cards' published peaks, one table for the kernels' bounds and the
bench's model-FLOPs utilization (MFU).

Dense rates only, never the sparse ones, from NVIDIA's data sheet at the
card's full power limit: a card set below it runs slower under load, so a
share of these peaks is stated beside the card's power limit. The rate a
run can reach depends on its math mode: float32 outside the tensor cores
(TF32 off), TF32 on the tensor cores, or bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Peaks(NamedTuple):
    float32: float  # FLOP/s, float32 outside the tensor cores
    tf32: float  # FLOP/s, TF32 on the tensor cores
    bfloat16: float  # FLOP/s, bf16 on the tensor cores
    hbm_bytes_per_s: float  # device memory


# H100 SXM5 (80 GB HBM3), the card ``torch.cuda.get_device_name`` calls
# "NVIDIA H100 80GB HBM3"
H100_SXM = Peaks(float32=67e12, tf32=494.7e12, bfloat16=989.4e12,
                 hbm_bytes_per_s=3.35e12)

# (substring of the device name, its peaks); the first match wins
CARDS = [("H100 80GB HBM3", H100_SXM)]

MATH_MODES = Peaks._fields[:3]


def card_peaks(device_name: str) -> Peaks | None:
    """The peaks of the card whose name holds a row's substring, or None
    for a card the table does not know."""
    for key, peaks in CARDS:
        if key.lower() in device_name.lower():
            return peaks
    return None


def math_mode(dtype: str) -> str:
    """The math mode of a run whose convs and dense layers compute in
    ``dtype`` (``model.dtype``): ``bfloat16``, else ``tf32`` where PyTorch
    lets matmuls or cuDNN use TF32, else ``float32``."""
    if dtype == "bfloat16":
        return "bfloat16"
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        return "tf32"
    return "float32"


def peak_flops(device_name: str, math: str) -> float | None:
    """Dense FLOP/s of the named card in math mode ``math`` (one of
    :data:`MATH_MODES`); None for an unknown card."""
    if math not in MATH_MODES:
        raise ValueError(f"math mode {math!r} is not one of {MATH_MODES}")
    peaks = card_peaks(device_name)
    return None if peaks is None else getattr(peaks, math)
