"""Constants on a device, made once per (values, dtype, device)."""

from __future__ import annotations

import functools

import numpy as np
import torch


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, shared; never write into it."""
    arr = np.array(values, order="C")
    return _constant(arr.tobytes(), arr.dtype.str, arr.shape, dtype,
                     torch.device(device))


@functools.lru_cache(maxsize=None)
def _constant(data: bytes, np_dtype: str, shape: tuple, dtype, device):
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape).copy()
    return torch.as_tensor(arr, dtype=dtype, device=device)
