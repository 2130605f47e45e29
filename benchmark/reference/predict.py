"""Two-pass inference in plain torch, in stages that a comparison can stop
between: :func:`candidates` runs the backbone, the RPN with its proposals'
NMS and the box branch, and decodes every (class, ROI) pair;
:func:`detections` runs per-class NMS and the global top-``max_detections``
merge on them; :func:`second_pass` runs the mask or keypoint branch on
given detection boxes, labels and pass-1 levels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.boxes import clip_boxes, loc2bbox
from benchmark.reference.config import Config
from benchmark.reference.maskrcnn import MaskRCNN, backbone_geometry, pyramid_shapes
from benchmark.reference.nms import nms_padded
from benchmark.reference.rpn import anchors_for, generate_proposals, top_k_stable


class Candidates(NamedTuple):
    """One image's pass 1: every foreground class of every proposal slot."""

    boxes: torch.Tensor  # (n_fg, R, 4) decoded, clipped, yxyx
    scores: torch.Tensor  # (n_fg, R) class probabilities
    valid: torch.Tensor  # (n_fg, R) proposal valid and above score_thresh
    levels: torch.Tensor  # (R,) pass-1 pyramid level of each proposal
    features: list  # the backbone's levels, for the second pass


def candidates(cfg: Config, model: MaskRCNN, image, img_hw, scale) -> Candidates:
    """image (H, W, 3) uint8, img_hw (2,), scale () device tensors."""
    h, w = image.shape[:2]
    dev = image.device
    shapes = pyramid_shapes(cfg, (h, w))
    anchors = torch.as_tensor(anchors_for(cfg, shapes, backbone_geometry(cfg)[0]),
                              device=dev)
    features, rpn_locs, rpn_scores = model(image[None])
    p = cfg.proposals
    props = generate_proposals(
        rpn_locs, rpn_scores, anchors, scale[None], img_hw[None],
        n_pre=p.n_test_pre_nms, n_post=p.n_test_post_nms,
        nms_thresh=p.nms_thresh, min_size=p.min_size, n_levels=len(shapes))
    rois, rvalid, levels = props.rois[0], props.valid[0], props.levels[0]
    r = rois.shape[0]
    locs, roi_scores = model.head_box(
        features, rois, torch.zeros(r, dtype=torch.int32, device=dev), levels)
    probs = torch.softmax(roi_scores, dim=-1)
    n_fg = cfg.model.n_fg_class
    mean = torch.tensor(cfg.sampler.loc_normalize_mean, device=dev)
    std = torch.tensor(cfg.sampler.loc_normalize_std, device=dev)
    boxes = clip_boxes(loc2bbox(rois, locs * std + mean), (img_hw[0], img_hw[1]))
    cls_scores = probs[:, 1:].T
    cls_valid = rvalid[None, :] & (cls_scores > cfg.eval.score_thresh)
    return Candidates(boxes[None].expand(n_fg, -1, -1), cls_scores, cls_valid,
                      levels, features)


class Detections(NamedTuple):
    boxes: torch.Tensor  # (D, 4)
    scores: torch.Tensor  # (D,)
    labels: torch.Tensor  # (D,) 0-based foreground class
    valid: torch.Tensor  # (D,)
    levels: torch.Tensor  # (D,) pass-1 level


def detections(cfg: Config, cand: Candidates) -> Detections:
    """Per-class greedy NMS, then the global top-``max_detections``."""
    d = cfg.eval.max_detections
    n_keep = min(cfg.proposals.n_test_post_nms, d)
    keep_idx, keep_valid = nms_padded(cand.boxes, cand.scores,
                                      cfg.eval.nms_thresh, n_keep, cand.valid)
    keep_idx = keep_idx.long()
    kept = torch.gather(cand.scores, 1, keep_idx)
    kept = torch.where(keep_valid, kept, torch.full_like(kept, -float("inf")))
    kept = kept.reshape(-1)
    if kept.shape[0] < d:
        kept = torch.nn.functional.pad(kept, (0, d - kept.shape[0]),
                                       value=-float("inf"))
    top, top_i = top_k_stable(kept, d)
    det_valid = torch.isfinite(top)
    safe_i = torch.where(det_valid, top_i, torch.zeros_like(top_i))
    label = torch.div(safe_i, n_keep, rounding_mode="floor")
    roi = keep_idx.reshape(-1)[safe_i]
    return Detections(cand.boxes[label, roi],
                      torch.where(det_valid, top, torch.zeros_like(top)),
                      torch.where(det_valid, label, torch.zeros_like(label)),
                      det_valid, cand.levels[roi])


def second_pass(cfg: Config, model: MaskRCNN, features, boxes, labels, levels):
    """(D, 4) boxes, (D,) labels and pass-1 levels → (D, S, S) sigmoid mask
    probabilities of each box's class, or (D, 56, 56, K) heatmap logits."""
    d = boxes.shape[0]
    zeros = torch.zeros(d, dtype=torch.int32, device=boxes.device)
    if cfg.model.head == "fpn_keypoint":
        return model.head_mask(features, boxes, zeros, levels)
    return torch.sigmoid(model.head_mask(features, boxes, zeros, levels,
                                         labels.long()))
