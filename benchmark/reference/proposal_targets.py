"""Head training targets (port of ``maskrcnn_tpu/targets/proposal_targets.py``:
``proposal_targets``, ``mask_targets`` and ``keypoint_targets``).

- GT boxes are appended to the proposals as candidates and given FPN levels;
- IoU argmax assignment, labels shifted +1 with background 0;
- ``n_sample`` ROI slots at ``pos_ratio``: positives (IoU ≥ 0.5) fill slots
  ``[0, n_pos)``, negatives (IoU in [lo, hi)) follow, the rest are invalid;
- loc targets are ``bbox2loc`` normalized by mean/std;
- mask targets resample each positive's GT mask crop bilinearly at the
  ROI's cell centers and threshold at 0.5;
- keypoint targets are the heatmap bin of each visible keypoint of the
  assigned GT inside the ROI's grid, or −1.

The random subsets come from uniform priorities that the caller passes in
(``pos_u``, ``neg_u``), ranked by a stable descending sort, so a test can
feed the draws of another framework. Batched over the leading image
dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.boxes import bbox2loc, box_iou
from benchmark.reference.levels import map_rois_to_fpn_levels
from benchmark.reference.device import device_constant


class ProposalTargets(NamedTuple):
    rois: torch.Tensor  # (B, n, 4)
    levels: torch.Tensor  # (B, n) int32
    labels: torch.Tensor  # (B, n) int32, 0 = background
    locs: torch.Tensor  # (B, n, 4) normalized
    assignment: torch.Tensor  # (B, n) int64 index into GT slots
    is_pos: torch.Tensor  # (B, n) bool
    valid: torch.Tensor  # (B, n) bool


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-image gather along dim 1: x (B, N, ...) at idx (B, n)."""
    tail = x.shape[2:]
    expanded = idx.reshape(idx.shape + (1,) * len(tail)).expand(*idx.shape, *tail)
    return torch.gather(x, 1, expanded)


def proposal_targets(
    pos_u: torch.Tensor,  # (B, R+G) uniform priorities of the positives
    neg_u: torch.Tensor,  # (B, R+G) of the negatives
    rois: torch.Tensor,  # (B, R, 4)
    roi_valid: torch.Tensor,  # (B, R) bool
    roi_levels: torch.Tensor,  # (B, R) int32
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_labels: torch.Tensor,  # (B, G) int32, 0-based fg classes
    gt_valid: torch.Tensor,  # (B, G) bool
    n_sample: int = 256,
    pos_ratio: float = 0.25,
    pos_iou_thresh: float = 0.5,
    neg_iou_thresh_hi: float = 0.5,
    neg_iou_thresh_lo: float = 0.0,
    loc_normalize_mean: tuple = (0.0, 0.0, 0.0, 0.0),
    loc_normalize_std: tuple = (0.1, 0.1, 0.2, 0.2),
    n_levels: int = 5,
) -> ProposalTargets:
    dev = rois.device
    n_pos_cap = int(round(n_sample * pos_ratio))
    mean = device_constant(loc_normalize_mean, torch.float32, dev)
    std = device_constant(loc_normalize_std, torch.float32, dev)

    all_rois = torch.cat([rois, gt_boxes], dim=1)  # (B, R+G, 4)
    all_valid = torch.cat([roi_valid, gt_valid], dim=1)
    all_levels = torch.cat(
        [roi_levels, map_rois_to_fpn_levels(gt_boxes, 0, n_levels - 1)], dim=1)
    n_cand = all_rois.shape[1]

    iou = box_iou(all_rois, gt_boxes)  # (B, R+G, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou, assignment = iou.max(dim=2)
    max_iou = torch.where(gt_valid.any(dim=1, keepdim=True), max_iou,
                          torch.zeros_like(max_iou))
    labels_all = _take(gt_labels, assignment) + 1  # background is 0

    is_pos = all_valid & (max_iou >= pos_iou_thresh)
    is_neg = (all_valid & (max_iou < neg_iou_thresh_hi)
              & (max_iou >= neg_iou_thresh_lo))
    n_pos = is_pos.sum(dim=1).clamp(max=n_pos_cap)  # (B,)
    n_neg = torch.minimum(n_sample - n_pos, is_neg.sum(dim=1))

    minus_one = torch.full_like(pos_u, -1.0)
    pos_order = torch.argsort(-torch.where(is_pos, pos_u, minus_one), dim=1,
                              stable=True)
    neg_order = torch.argsort(-torch.where(is_neg, neg_u, minus_one), dim=1,
                              stable=True)

    slot = torch.arange(n_sample, device=dev)[None, :]
    slot_is_pos = slot < n_pos[:, None]
    neg_slot = (slot - n_pos[:, None]).clamp(0, n_cand - 1)
    idx = torch.where(slot_is_pos,
                      _take(pos_order, slot.clamp(max=n_cand - 1).expand_as(neg_slot)),
                      _take(neg_order, neg_slot))
    valid = slot_is_pos | ((slot - n_pos[:, None]) < n_neg[:, None])

    s_rois = _take(all_rois, idx)
    s_levels = torch.where(valid, _take(all_levels, idx), 0)
    s_assign = torch.where(valid, _take(assignment, idx), 0)
    s_labels = torch.where(slot_is_pos & valid, _take(labels_all, idx), 0)
    locs = (bbox2loc(s_rois, _take(gt_boxes, s_assign)) - mean) / std
    return ProposalTargets(s_rois, s_levels.to(torch.int32),
                           s_labels.to(torch.int32), locs, s_assign,
                           slot_is_pos, valid)


def _axis_interp_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """(..., n) float coords → (..., n, size) bilinear interpolation rows.
    A coord more than half a pixel beyond the border gets an all-zero row
    (background), the border semantics of a crop."""
    ok = ((coords >= -0.5) & (coords <= size - 0.5)).float()
    c = coords.clamp(0.0, size - 1.0)
    lo = torch.floor(c)
    hi = torch.clamp(lo + 1.0, max=size - 1.0)
    lw = c - lo
    m = torch.zeros(coords.shape + (size,), dtype=torch.float32,
                    device=coords.device)
    m.scatter_add_(-1, lo.long()[..., None], ((1.0 - lw) * ok)[..., None])
    m.scatter_add_(-1, hi.long()[..., None], (lw * ok)[..., None])
    return m


def mask_targets(
    sample: ProposalTargets,
    gt_masks: torch.Tensor,  # (B, G, S, S) GT mask cropped to its GT box:
    #   float in [0, 1], or uint8 in [0, 255] (the loaders' transport)
    gt_boxes: torch.Tensor,  # (B, G, 4)
    mask_size: int = 28,
) -> torch.Tensor:
    """(B, n, mask_size, mask_size) binary float targets: each output cell
    samples the assigned GT's mask crop at the cell center, mapped from ROI
    to GT-box coordinates, thresholded at 0.5."""
    s = gt_masks.shape[-1]
    gmask = _take(gt_masks, sample.assignment)  # (B, n, S, S)
    gmask = gmask.float() / 255.0 if gmask.dtype == torch.uint8 else gmask.float()
    gbox = _take(gt_boxes, sample.assignment)  # (B, n, 4)
    gh = (gbox[..., 2] - gbox[..., 0]).clamp(min=1e-3)[..., None]
    gw = (gbox[..., 3] - gbox[..., 1]).clamp(min=1e-3)[..., None]
    cell = (torch.arange(mask_size, dtype=torch.float32, device=gbox.device)
            + 0.5) / mask_size
    roi = sample.rois
    ys = roi[..., 0:1] + cell * (roi[..., 2:3] - roi[..., 0:1])
    xs = roi[..., 1:2] + cell * (roi[..., 3:4] - roi[..., 1:2])
    # into the GT crop's pixel frame (half-pixel convention)
    by = _axis_interp_matrix((ys - gbox[..., 0:1]) / gh * s - 0.5, s)
    bx = _axis_interp_matrix((xs - gbox[..., 1:2]) / gw * s - 0.5, s)
    interp = by @ gmask @ bx.transpose(-1, -2)
    return (interp >= 0.5).float()


def keypoint_targets(
    sample: ProposalTargets,
    gt_keypoints: torch.Tensor,  # (B, G, K, 3) (y, x, v) in image coordinates
    mask_size: int = 56,
) -> torch.Tensor:
    """(B, n, K) int32 bin labels in [0, mask_size²), or −1 to ignore: each
    keypoint of the assigned GT mapped into the ROI's S×S grid, label
    y·S + x where v == 2 and the point falls inside, else −1. The ROI's
    coordinates and the grid position truncate toward zero, as the JAX
    package does."""
    kps = _take(gt_keypoints, sample.assignment).float()  # (B, n, K, 3)
    roi = torch.trunc(sample.rois)
    y0, x0 = roi[..., 0:1], roi[..., 1:2]
    h = (roi[..., 2:3] - y0).clamp(min=1.0)
    w = (roi[..., 3:4] - x0).clamp(min=1.0)
    yy = torch.trunc((kps[..., 0] - y0) / h * mask_size).to(torch.int32)
    xx = torch.trunc((kps[..., 1] - x0) / w * mask_size).to(torch.int32)
    v = kps[..., 2].to(torch.int32)
    ok = ((v == 2) & (yy >= 0) & (yy < mask_size)
          & (xx >= 0) & (xx < mask_size))
    return torch.where(ok, yy * mask_size + xx, torch.full_like(yy, -1))
