"""MaskRCNN facade: backbone + RPN + ROI head (port of
``maskrcnn_tpu/models/maskrcnn.py``, FPN backbone with the FPN mask head).

Stages are methods — ``extract``, ``rpn``, ``pool``, ``head_box``,
``head_mask``, ``head_train`` — that two-pass predict and the train step
compose around the parameter-free glue (proposals, NMS, targets). Features travel between stages in the JAX layout,
one ``(B, H, W, C)`` tensor per level; they are NHWC views of the
channels_last NCHW maps the convolutions produce, so the round trip copies
nothing.

``cfg.model.dtype`` is the compute dtype of every conv and dense layer
(parameters stay float32), ``freeze_bn`` picks the running or, in training,
the batch statistics of the backbone's BatchNorms, ``remat`` checkpoints
the backbone, and ``roi_align_acc`` is the accumulator of the shared pool's
backward (:func:`multilevel_roi_align_train`).
"""

from __future__ import annotations

import torch
from torch import nn

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.backbones.fpn import FPNBackbone
from maskrcnn_tpu_torch.models.heads.fpn_heads import FPNMaskHead
from maskrcnn_tpu_torch.models.init import init_weights
from maskrcnn_tpu_torch.models.layers import compute_dtype
from maskrcnn_tpu_torch.models.rpn import RPNHead
from maskrcnn_tpu_torch.ops.roi_align import (
    multilevel_roi_align,
    multilevel_roi_align_train,
)
from maskrcnn_tpu_torch.utils.device import resolve_device

_BACKBONE_STRIDES = {"fpn": (4, 8, 16, 32, 64), "c4": (16,), "darknet": (16,)}


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


class MaskRCNN(nn.Module):
    """``MaskRCNN(cfg, device=None, seed=0)``: built with seeded random
    weights on ``device`` (the GPU unless the caller names another)."""

    def __init__(self, cfg: Config, device=None, seed: int = 0):
        super().__init__()
        m = cfg.model
        if m.backbone != "fpn" or m.head != "fpn":
            raise NotImplementedError(
                f"backbone={m.backbone!r} head={m.head!r}: the port covers the "
                "FPN backbone with the FPN mask head")
        dt = compute_dtype(m.dtype)
        self.acc_dtype = compute_dtype(m.roi_align_acc)
        self.cfg = cfg
        self.extractor = FPNBackbone(m.fpn_channels, m.freeze_bn, dt, m.remat)
        self.rpn_head = RPNHead(m.fpn_channels, 256, len(cfg.anchors.ratios), dt)
        self.head = FPNMaskHead(m.n_class, m.n_mask_convs, m.fpn_channels, dt)
        init_weights(self, seed)
        self.eval()
        self.to(resolve_device(device), memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.extractor.conv_p2.weight.device

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

    def pool(self, features, rois, roi_batch_idx, roi_levels, out_size):
        """Batched multilevel ROIAlign over flattened (B·R,) ROI slots."""
        impl = self.cfg.model.roi_align
        return multilevel_roi_align(
            features, rois, roi_batch_idx, roi_levels, out_size,
            self.spatial_scales, impl=None if impl == "auto" else
            ("gather" if impl == "fused" else impl),
        )

    def head_box(self, features, rois, roi_batch_idx, roi_levels):
        """Pass 1: pooled 7×7 → (locs, scores)."""
        s = self.head.roi_size_box
        pooled = self.pool(features, rois, roi_batch_idx, roi_levels, (s, s))
        locs, scores, _ = self.head(pooled)
        return locs, scores

    def head_mask(self, features, rois, roi_batch_idx, roi_levels,
                  class_idx=None):
        """Pass 2: pooled 14×14 on refined boxes → mask logits."""
        s = self.head.roi_size_mask
        pooled = self.pool(features, rois, roi_batch_idx, roi_levels, (s, s))
        return self.head.predict_mask(pooled, class_idx)

    def head_train(self, features, rois_bn, levels_bn, n_pos: int,
                   class_idx=None):
        """Train-path head over (B, n) ROI slots with positives FIRST: box
        branch on every slot, mask branch on the (B, :n_pos) prefix →
        (locs, scores, masks). Both branches pool from one shared window
        per ROI (:func:`multilevel_roi_align_train`), whose backward is the
        region-scatter kernel, accumulating in ``cfg.model.roi_align_acc``;
        the other ROIAlign forms have no train path."""
        sb, sm = self.head.roi_size_box, self.head.roi_size_mask
        impl = self.cfg.model.roi_align
        if impl not in ("auto", "region", "fused"):
            raise NotImplementedError(
                f"roi_align={impl!r} has no backward in the port: train with "
                "'auto', 'region' or 'fused'")
        pooled_box, pooled_mask = multilevel_roi_align_train(
            features, rois_bn, levels_bn, n_pos, (sb, sb), (sm, sm),
            self.spatial_scales, acc_dtype=self.acc_dtype)
        locs, scores = self.head.box(pooled_box)
        return locs, scores, self.head.predict_mask(pooled_mask, class_idx)

    def forward(self, images, train: bool = False):
        features = self.extract(images, train)
        rpn_locs, rpn_scores = self.rpn(features)
        return features, rpn_locs, rpn_scores
