"""Anchor generation — all static / trace-time.

Spec: chainercv ``generate_anchor_base`` + ``_enumerate_shifted_anchor`` as
used by the reference multilevel RPN
(reference chainer_maskrcnn/model/rpn/multilevel_region_proposal_network.py:70-71,128-129):
a 16 px base window scaled per level (scale = anchor_size / 16), 3 aspect
ratios [0.5, 1, 2], shifted over the feature grid by the level's stride.

Because the TPU pipeline uses bucketed static image sizes, anchors are plain
numpy computed once at trace time and closed over as constants — no device
work, no recompute per step.
"""

from __future__ import annotations

import numpy as np


def generate_anchor_base(
    base_size: float = 16.0,
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
    anchor_scales: tuple[float, ...] = (8.0, 16.0, 32.0),
) -> np.ndarray:
    """(len(ratios)*len(scales), 4) yxyx anchors centered on (base/2, base/2)."""
    py = base_size / 2.0
    px = base_size / 2.0
    n = len(ratios) * len(anchor_scales)
    anchor_base = np.zeros((n, 4), dtype=np.float32)
    for i, ratio in enumerate(ratios):
        for j, scale in enumerate(anchor_scales):
            h = base_size * scale * np.sqrt(ratio)
            w = base_size * scale * np.sqrt(1.0 / ratio)
            idx = i * len(anchor_scales) + j
            anchor_base[idx, 0] = py - h / 2.0
            anchor_base[idx, 1] = px - w / 2.0
            anchor_base[idx, 2] = py + h / 2.0
            anchor_base[idx, 3] = px + w / 2.0
    return anchor_base


def shifted_anchors(anchor_base: np.ndarray, feat_stride: int, height: int, width: int) -> np.ndarray:
    """Enumerate anchors over an H×W feature grid → (H*W*A, 4) float32.

    Row-major over (y, x) grid positions, anchors innermost — same enumeration
    order as chainercv's ``_enumerate_shifted_anchor`` so that score/loc maps
    reshaped as (H, W, A) line up (reference multilevel RPN :126-146 relies on
    this ordering when concatenating levels).
    """
    shift_y = np.arange(0, height * feat_stride, feat_stride, dtype=np.float32)
    shift_x = np.arange(0, width * feat_stride, feat_stride, dtype=np.float32)
    sx, sy = np.meshgrid(shift_x, shift_y)
    shift = np.stack([sy.ravel(), sx.ravel(), sy.ravel(), sx.ravel()], axis=1)

    a = anchor_base.shape[0]
    k = shift.shape[0]
    anchors = anchor_base[None, :, :] + shift[:, None, :]
    return anchors.reshape(k * a, 4).astype(np.float32)


def multilevel_anchors(
    feat_shapes: list[tuple[int, int]],
    feat_strides: list[int],
    anchor_scales: list[float],
    base_size: float = 16.0,
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0),
) -> list[np.ndarray]:
    """Per-level anchor arrays for an FPN pyramid.

    Mirrors the reference's per-level ``generate_anchor_base(scales=[s])``
    with a *single* scale per level × 3 ratios → 3 anchors per position
    (reference multilevel_region_proposal_network.py:70-71).
    """
    assert len(feat_shapes) == len(feat_strides) == len(anchor_scales)
    out = []
    for (h, w), stride, scale in zip(feat_shapes, feat_strides, anchor_scales):
        base = generate_anchor_base(base_size, ratios, (scale,))
        out.append(shifted_anchors(base, stride, h, w))
    return out
