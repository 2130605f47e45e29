"""Two-pass inference: boxes first, then masks on the refined boxes (port of
``maskrcnn_tpu/eval/predict.py``, its native-gather path).

Pass 1 runs backbone, RPN, proposals and the box branch, decodes boxes
per class (loc · std + mean → loc2bbox → clip; one class-agnostic loc, or
each class's own for the Res5 head), and
keeps every (ROI, class) pair above ``score_thresh`` for an exact per-class
greedy NMS (every class of every image of the batch in one call). A global
top-``max_detections`` by score merges the classes. Pass 2 pools the
refined boxes — at the pass-1 ROI's level under ``mask_levels="pass1"`` —
and runs the class-gathered mask branch, or the keypoint branch, whose
56×56 heatmap logits come back as they are. Fixed shapes throughout:
detections live in ``max_detections`` padded slots with a validity mask.
With ``model.dtype="bfloat16"`` the convolutions and dense layers compute
in bf16 and the pools read bf16 features; the RPN outputs, proposals, NMS,
box decoding, scores and mask logits stay float32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.maskrcnn import (
    MaskRCNN,
    backbone_geometry,
    pyramid_shapes,
)
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals, top_k_stable
from maskrcnn_tpu_torch.ops.boxes import clip_boxes, loc2bbox
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels
from maskrcnn_tpu_torch.ops.nms import nms_padded


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4) yxyx in network-input coords
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 0-based fg class
    valid: torch.Tensor  # (B, D) bool
    masks: torch.Tensor | None  # (B, D, S, S) sigmoid probs (the mask head)
    heatmaps: torch.Tensor | None  # (B, D, 56, 56, K) float32 logits (the
    #   keypoint head)


def decode_boxes(cfg: Config, rois, locs, probs, rvalid, img_hw):
    """One image: rois (R, 4), locs (R, 4) class-agnostic or (R, (C+1)·4)
    per class (the Res5 head), probs (R, C+1), rvalid (R,) → (cls_boxes
    (n_fg, R, 4), cls_scores (n_fg, R), cls_valid (n_fg, R))."""
    n_fg = cfg.model.n_fg_class
    mean = torch.tensor(cfg.sampler.loc_normalize_mean, device=locs.device)
    std = torch.tensor(cfg.sampler.loc_normalize_std, device=locs.device)
    hw = (img_hw[0], img_hw[1])
    if locs.shape[-1] == 4:
        boxes = clip_boxes(loc2bbox(rois, locs * std + mean), hw)
        cls_boxes = boxes[None].expand(n_fg, -1, -1)
    else:  # each foreground class's own loc, background's column dropped
        r = rois.shape[0]
        locs_fg = (locs.reshape(r, -1, 4)[:, 1:] * std + mean).transpose(0, 1)
        cls_boxes = clip_boxes(loc2bbox(
            rois[None].expand(n_fg, -1, -1).reshape(-1, 4),
            locs_fg.reshape(-1, 4)), hw).reshape(n_fg, r, 4)
    cls_scores = probs[:, 1:].T
    cls_valid = rvalid[None, :] & (cls_scores > cfg.eval.score_thresh)
    return cls_boxes, cls_scores, cls_valid


def merge_top(cls_boxes, cls_scores, roi_levels, keep_idx, keep_valid, d: int):
    """One image: the global top-``d`` kept (class, ROI) pairs by score →
    (boxes (d, 4), scores, labels int32, valid, pass-1 levels int32)."""
    n_fg, n_keep = keep_idx.shape
    keep_idx = keep_idx.long()
    kept = torch.gather(cls_scores, 1, keep_idx)
    kept = torch.where(keep_valid, kept, torch.full_like(kept, -float("inf")))
    kept = kept.reshape(n_fg * n_keep)
    if n_fg * n_keep < d:
        kept = torch.nn.functional.pad(kept, (0, d - n_fg * n_keep),
                                       value=-float("inf"))
    top_scores, top_i = top_k_stable(kept, d)
    det_valid = torch.isfinite(top_scores)
    safe_i = torch.where(det_valid, top_i, torch.zeros_like(top_i))
    label = torch.div(safe_i, n_keep, rounding_mode="floor")
    roi_idx = keep_idx.reshape(-1)[safe_i]
    det_boxes = cls_boxes[label, roi_idx]
    det_levels = roi_levels[roi_idx].to(torch.int32)
    det_scores = torch.where(det_valid, top_scores, torch.zeros_like(top_scores))
    det_labels = torch.where(det_valid, label, torch.zeros_like(label))
    return det_boxes, det_scores, det_labels.to(torch.int32), det_valid, det_levels


def predict_masks(cfg: Config, model: MaskRCNN, roi_feats, det_boxes,
                  det_labels, det_levels):
    """Pass 2: (B, D) detections → (masks, heatmaps): (B, D, S, S) sigmoid
    mask probs of each detection's class (S = 28 for the FPN mask head, 14
    for the light and Res5 heads) and None, or None and (B, D, 56, 56, K)
    heatmap logits for the keypoint head. ``roi_feats`` is
    ``model.roi_features(features)``."""
    b, d = det_boxes.shape[:2]
    flat_boxes = det_boxes.reshape(b * d, 4)
    if cfg.eval.mask_levels == "pass1":
        flat_levels = det_levels.reshape(b * d)
    else:
        flat_levels = map_rois_to_fpn_levels(flat_boxes, 0, len(roi_feats) - 1)
    flat_bi = torch.arange(b, dtype=torch.int32,
                           device=det_boxes.device).repeat_interleave(d)
    if cfg.model.head == "fpn_keypoint":
        heat = model.head_mask(roi_feats, flat_boxes, flat_bi, flat_levels)
        return None, heat.reshape(b, d, *heat.shape[1:])
    logits = model.head_mask(roi_feats, flat_boxes, flat_bi, flat_levels,
                             det_labels.reshape(b * d))
    return torch.sigmoid(logits).reshape(b, d, *logits.shape[1:]), None


def make_predict_fn(cfg: Config, model: MaskRCNN, image_size=None):
    """``predict(images, img_hw, scale) -> Detections`` on the model's device.

    images (B, H, W, 3) uint8 or float; img_hw (B, 2) true content size;
    scale (B,) resize scale. Arrays or tensors; moved to the model's device.
    """
    h, w = image_size or cfg.train.image_size
    feat_strides, _ = backbone_geometry(cfg)
    feat_shapes = pyramid_shapes(cfg, (h, w))
    dev = model.device
    anchors = torch.as_tensor(anchors_for(cfg, feat_shapes, feat_strides),
                              device=dev)
    n_levels = len(feat_shapes)
    d = cfg.eval.max_detections
    # only the top-d kept boxes of a class can reach the global top-d
    n_keep_pc = min(cfg.proposals.n_test_post_nms, d)

    @torch.inference_mode()
    def predict(images, img_hw, scale) -> Detections:
        images = torch.as_tensor(images, device=dev)
        img_hw = torch.as_tensor(img_hw, dtype=torch.float32, device=dev)
        scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        b = images.shape[0]
        features, rpn_locs, rpn_scores = model(images)
        roi_feats = model.roi_features(features)
        props = generate_proposals(
            rpn_locs, rpn_scores, anchors, scale, img_hw,
            n_pre=cfg.proposals.n_test_pre_nms,
            n_post=cfg.proposals.n_test_post_nms,
            nms_thresh=cfg.proposals.nms_thresh,
            min_size=cfg.proposals.min_size, n_levels=n_levels,
        )
        r = props.rois.shape[1]
        batch_idx = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(r)
        locs, roi_scores = model.head_box(
            roi_feats, props.rois.reshape(b * r, 4), batch_idx,
            props.levels.reshape(b * r))
        probs = torch.softmax(roi_scores, dim=-1).reshape(b, r, -1)
        locs = locs.reshape(b, r, -1)
        cls_boxes, cls_scores, cls_valid = (torch.stack(t) for t in zip(*(
            decode_boxes(cfg, props.rois[i], locs[i], probs[i],
                         props.valid[i], img_hw[i]) for i in range(b))))
        # every image's per-class NMS in one call: (B, n_fg) problems
        keep_idx, keep_valid = nms_padded(
            cls_boxes, cls_scores, cfg.eval.nms_thresh, n_keep_pc, cls_valid)
        det_boxes, det_scores, det_labels, det_valid, det_levels = (
            torch.stack(t) for t in zip(*(
                merge_top(cls_boxes[i], cls_scores[i], props.levels[i],
                          keep_idx[i], keep_valid[i], d) for i in range(b))))
        masks, heatmaps = predict_masks(cfg, model, roi_feats, det_boxes,
                                        det_labels, det_levels)
        return Detections(det_boxes, det_scores, det_labels, det_valid, masks,
                          heatmaps)

    return predict
