"""FPN level assignment for ROIs (port of ``maskrcnn_tpu/ops/levels.py``)."""

from __future__ import annotations

import torch

from benchmark.reference.boxes import box_area


def map_rois_to_fpn_levels(
    rois: torch.Tensor,
    k_min: int = 0,
    k_max: int = 4,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
) -> torch.Tensor:
    """(..., 4) yxyx ROIs → (...,) int32 pyramid level in [k_min, k_max].

    ``clip(floor(4 + log2(sqrt(area)/224 + 1e-6)), 0, 4)`` — the reference's
    equation without Detectron's −2 shift, so a 224-px ROI maps to index 4
    (P6). Degenerate or padded ROIs (area ≤ 0) land on ``k_min``.
    """
    s = torch.sqrt(box_area(rois).clamp(min=0.0))
    target = torch.floor(canonical_level + torch.log2(s / canonical_scale + 1e-6))
    return target.clamp(k_min, k_max).to(torch.int32)
