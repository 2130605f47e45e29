"""Device choice for the port's entry points: the GPU unless asked."""

from __future__ import annotations

import functools
import subprocess

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one, raise rather than fall back to
    the CPU. Pass ``device="cpu"`` to run on the CPU on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def card_name_and_power_limit() -> str:
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``: a
    time measured on the card is only comparable at the same power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once per (values, dtype,
    device) and shared: a step that reads it copies nothing from the host,
    so the card can capture the step into a CUDA graph (a copy from the
    host waits for the device). Never write into it."""
    arr = np.array(values, order="C")
    return _constant(arr.tobytes(), arr.dtype.str, arr.shape, dtype,
                     torch.device(device))


@functools.lru_cache(maxsize=None)
def _constant(data: bytes, np_dtype: str, shape: tuple, dtype, device):
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()
    return torch.as_tensor(arr, dtype=dtype, device=device)
