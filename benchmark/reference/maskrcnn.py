"""The Mask R-CNN facade in plain torch: backbone + RPN + ROI heads for the
FPN backbone with the FPN mask or keypoint head and the Darknet backbone
with the keypoint head; any other head comes from a module of its own,
``heads_<head>.py`` beside this one (:func:`build_head`). The pools are :mod:`benchmark.reference.roi_align`'s
(the region form on a pyramid, the pointwise form on one level), trained
through autograd. Features
travel between stages as ``(B, H, W, C)`` views of the channels_last NCHW
maps the convolutions produce. The weights are whatever the caller loads:
the constructor leaves the layers as torch made them.
"""

from __future__ import annotations

import importlib
import importlib.util

import torch
from torch import nn

from benchmark.reference.config import Config
from benchmark.reference.backbones import build_backbone
from benchmark.reference.heads import FPNKeypointHead, FPNMaskHead
from benchmark.reference.layers import compute_dtype
from benchmark.reference.rpn import RPNHead
from benchmark.reference.roi_align import (
    multilevel_roi_align,
    multilevel_roi_align_train,
)

_BACKBONE_STRIDES = {"fpn": (4, 8, 16, 32, 64), "c4": (16,), "darknet": (16,)}


def backbone_channels(cfg: Config) -> int:
    """The width of every level the backbone gives: the FPN's
    ``fpn_channels``, res4's 1024 (C4) or Darknet's 256."""
    m = cfg.model
    return {"fpn": m.fpn_channels, "c4": 1024, "darknet": 256}[m.backbone]


def backbone_geometry(cfg: Config):
    """Static (feat_strides, spatial_scales) of a config."""
    strides = _BACKBONE_STRIDES[cfg.model.backbone]
    return strides, tuple(1.0 / s for s in strides)


def pyramid_shapes(cfg: Config, image_size) -> list[tuple[int, int]]:
    """Per-level feature shapes for a static image size; P6 is a stride-2
    1×1 conv on P5, so ``ceil(P5/2)`` (800 → P5 25 → P6 13)."""
    h, w = image_size
    if cfg.model.backbone == "fpn":
        if h % 32 or w % 32:
            raise ValueError("FPN image sizes must be multiples of 32")
        shapes = [(h // s, w // s) for s in (4, 8, 16, 32)]
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
        return shapes
    if h % 16 or w % 16:
        raise ValueError("image sizes must be multiples of 16")
    return [(h // 16, w // 16)]


def build_head(cfg: Config, dtype: torch.dtype) -> nn.Module:
    """The configuration's ROI heads: the FPN mask or keypoint head, or for
    any other ``model.head`` the ``build(cfg, width, dtype)`` of the module
    ``benchmark/reference/heads_<head>.py``, which a configuration that
    needs such a head brings as a file of its own."""
    m = cfg.model
    width = backbone_channels(cfg)
    if m.head == "fpn":
        return FPNMaskHead(m.n_class, m.n_mask_convs, width, dtype)
    if m.head == "fpn_keypoint":
        return FPNKeypointHead(m.n_class, m.n_keypoints, m.n_mask_convs,
                               width, dtype, m.kp_upsample)
    name = f"heads_{m.head}"
    if importlib.util.find_spec(f"{__package__}.{name}") is None:
        raise ValueError(f"unknown head {m.head!r}: no reference head module "
                         f"benchmark/reference/{name}.py")
    return importlib.import_module(f"{__package__}.{name}").build(cfg, width, dtype)


class MaskRCNN(nn.Module):
    """``MaskRCNN(cfg, device)``: the layers on ``device``, channels_last."""

    def __init__(self, cfg: Config, device):
        super().__init__()
        m = cfg.model
        dt = compute_dtype(m.dtype)
        self.cfg = cfg
        self.extractor = build_backbone(m.backbone, m.fpn_channels,
                                        m.freeze_bn, dt, m.remat)
        self.rpn_head = RPNHead(backbone_channels(cfg), 256,
                                len(cfg.anchors.ratios), dt)
        self.head = build_head(cfg, dt)
        self.eval()
        self.to(torch.device(device), memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.rpn_head.conv.weight.device

    @property
    def spatial_scales(self):
        return backbone_geometry(self.cfg)[1]

    def extract(self, images: torch.Tensor, train: bool = False):
        """images (B, H, W, 3), uint8 in [0, 255] or float in [0, 1] → list
        of (B, Hl, Wl, C) levels in the compute dtype, fine→coarse. ``train``
        selects the batch statistics of a trainable BatchNorm (and moves its
        running statistics); frozen BatchNorm ignores it. uint8 divides by
        255 in float32; the stem casts to the compute dtype."""
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        x = images.float().permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return [p.permute(0, 2, 3, 1) for p in self.extractor(x, train)]

    def rpn(self, features):
        """→ (rpn_locs (B, A, 4), rpn_scores (B, A, 2))."""
        return self.rpn_head([f.permute(0, 3, 1, 2) for f in features])

    def roi_features(self, features):
        """The maps the ROI heads pool from: the backbone's levels, or what
        the head makes of them where it has a ``roi_features`` of its own
        (a head brought by file, such as Light-Head's thin map)."""
        own = getattr(self.head, "roi_features", None)
        return features if own is None else own(features)

    def pool(self, roi_feats, rois, roi_batch_idx, roi_levels, out_size):
        """Batched multilevel ROIAlign over flattened (B·R,) ROI slots."""
        return multilevel_roi_align(roi_feats, rois, roi_batch_idx, roi_levels,
                                    out_size, self.spatial_scales)

    def head_box(self, roi_feats, rois, roi_batch_idx, roi_levels):
        """Pass 1: pooled 7×7 → (locs, scores)."""
        s = self.head.roi_size_box
        pooled = self.pool(roi_feats, rois, roi_batch_idx, roi_levels, (s, s))
        return self.head.box(pooled)

    def head_mask(self, roi_feats, rois, roi_batch_idx, roi_levels,
                  class_idx=None):
        """Pass 2: pooled on refined boxes → mask logits, only each ROI's
        ``class_idx`` channel when given (the mask heads), or (R, 56, 56, K)
        heatmap logits (the keypoint head, which takes no ``class_idx``)."""
        s = self.head.roi_size_mask
        pooled = self.pool(roi_feats, rois, roi_batch_idx, roi_levels, (s, s))
        return self.head.predict_mask(pooled, class_idx)

    def head_train(self, roi_feats, rois_bn, levels_bn, n_pos: int,
                   class_idx=None):
        """Train-path head over (B, n) ROI slots with positives FIRST: box
        branch on every slot, mask or keypoint branch on the (B, :n_pos)
        prefix → (locs, scores, mask logits or heatmaps). On a pyramid both
        branches pool from one shared window per ROI; on one level, two
        pools."""
        sb, sm = self.head.roi_size_box, self.head.roi_size_mask
        if len(roi_feats) > 1:
            pooled_box, pooled_mask = multilevel_roi_align_train(
                roi_feats, rois_bn, levels_bn, n_pos, (sb, sb), (sm, sm),
                self.spatial_scales)
            locs, scores = self.head.box(pooled_box)
            return locs, scores, self.head.predict_mask(pooled_mask, class_idx)
        b, n = rois_bn.shape[:2]
        images = torch.arange(b, dtype=torch.int32, device=rois_bn.device)
        locs, scores = self.head_box(
            roi_feats, rois_bn.reshape(b * n, 4), images.repeat_interleave(n),
            levels_bn.reshape(b * n))
        masks = self.head_mask(
            roi_feats, rois_bn[:, :n_pos].reshape(b * n_pos, 4),
            images.repeat_interleave(n_pos),
            levels_bn[:, :n_pos].reshape(b * n_pos), class_idx)
        return locs, scores, masks

    def forward(self, images, train: bool = False):
        features = self.extract(images, train)
        rpn_locs, rpn_scores = self.rpn(features)
        return features, rpn_locs, rpn_scores
