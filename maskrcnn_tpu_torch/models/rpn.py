"""Multilevel RPN head and fixed-shape proposal generation (port of
``maskrcnn_tpu/models/rpn.py``).

One 3×3 conv (+relu) shared across levels, then 1×1 score (2A) and loc (4A)
convs, computed in ``dtype``; locs and scores return as float32. Output rows run row-major over each level's grid with the anchor
index innermost, levels concatenated fine→coarse — the order of
:func:`anchors_for` — so NCHW conv outputs are permuted to NHWC before the
reshape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.layers import Conv2d
from maskrcnn_tpu_torch.ops.anchors import multilevel_anchors
from maskrcnn_tpu_torch.ops.boxes import clip_boxes, loc2bbox
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels
from maskrcnn_tpu_torch.ops.nms import nms_padded


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int = 256,
                 n_anchor: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=dtype)
        self.conv = Conv2d(in_channels, mid_channels, 3, padding=1, **kw)
        self.score = Conv2d(mid_channels, n_anchor * 2, 1, **kw)
        self.loc = Conv2d(mid_channels, n_anchor * 4, 1, **kw)

    def forward(self, features):
        """NCHW levels → (locs (B, ΣHWA, 4), scores (B, ΣHWA, 2)) float32."""
        locs, scores = [], []
        for f in features:
            b = f.shape[0]
            h = F.relu(self.conv(f))
            locs.append(self.loc(h).float().permute(0, 2, 3, 1).reshape(b, -1, 4))
            scores.append(self.score(h).float().permute(0, 2, 3, 1).reshape(b, -1, 2))
        return torch.cat(locs, dim=1), torch.cat(scores, dim=1)


class Proposals(NamedTuple):
    rois: torch.Tensor  # (B, R, 4) yxyx image coords
    levels: torch.Tensor  # (B, R) int32 FPN head level
    valid: torch.Tensor  # (B, R) bool
    scores: torch.Tensor  # (B, R) objectness


def anchors_for(cfg: Config, feat_shapes, feat_strides) -> np.ndarray:
    """Static concatenated anchors (A_total, 4) for one image size."""
    per_level = multilevel_anchors(
        feat_shapes, list(feat_strides),
        list(cfg.anchors.scales[: len(feat_shapes)]),
        cfg.anchors.base_size, cfg.anchors.ratios,
    )
    return np.concatenate(per_level, axis=0)


def top_k_stable(x: torch.Tensor, k: int):
    """Exact top-k along the last dim; ties go to the lower index (a stable
    descending sort), the order JAX's ``lax.top_k`` gives."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def generate_proposals(locs, scores, anchors, scale, img_hw, n_pre: int,
                       n_post: int, nms_thresh: float = 0.7,
                       min_size: float = 16.0, n_levels: int = 5) -> Proposals:
    """Decode → clip → min-size filter → top-``n_pre`` → NMS → ``n_post``
    slots, per image. ``img_hw`` (B, 2) is the true content size inside the
    padded canvas; ``scale`` (B,) the resize scale."""
    fg = torch.softmax(scores, dim=-1)[..., 1]  # (B, A)
    out = []
    for i in range(locs.shape[0]):
        boxes = clip_boxes(loc2bbox(anchors, locs[i]), (img_hw[i, 0], img_hw[i, 1]))
        ms = min_size * scale[i]
        ok = ((boxes[:, 2] - boxes[:, 0]) >= ms) & ((boxes[:, 3] - boxes[:, 1]) >= ms)
        masked = torch.where(ok, fg[i], torch.full_like(fg[i], -float("inf")))
        top_scores, top_idx = top_k_stable(masked, min(n_pre, boxes.shape[0]))
        top_boxes = boxes[top_idx]
        idx, valid = nms_padded(top_boxes, top_scores, nms_thresh, n_post,
                                torch.isfinite(top_scores))
        idx = idx.long()
        rois = top_boxes[idx]
        roi_scores = torch.where(valid, top_scores[idx], torch.zeros_like(rois[:, 0]))
        levels = torch.where(valid, map_rois_to_fpn_levels(rois, 0, n_levels - 1),
                             torch.zeros_like(valid, dtype=torch.int32))
        out.append((rois, levels, valid, roi_scores))
    return Proposals(*(torch.stack(t) for t in zip(*out)))
