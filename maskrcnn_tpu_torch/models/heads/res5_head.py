"""Res5 ROI head (port of ``maskrcnn_tpu/models/heads/res5_head.py``).

The 7×7 pool of the C4 feature goes through ResNet's res5 with every stride
1, a 3×3 conv2048 + relu and a global average pool to PER-CLASS ``cls_loc``
(``n_class·4``) and ``score``. Mask branch, on the same trunk: 2×2/2
transposed conv to 256 + relu, then a 3×3 conv to ``n_class − 1`` at 14².
res5's BatchNorms follow ``model.freeze_bn``; with trainable BatchNorm and
``train=True`` their statistics run over the ROIs' 7×7 positions. Every
layer computes in ``dtype``; locs, scores and mask logits return as
float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from maskrcnn_tpu_torch.models.backbones.resnet import Res5Stage
from maskrcnn_tpu_torch.models.heads.light_head import select_class
from maskrcnn_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear


class Res5Head(nn.Module):
    mask_size = 14
    roi_size_box = 7
    roi_size_mask = 7

    def __init__(self, n_class: int, frozen_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=dtype)
        self.res5 = Res5Stage(frozen_bn, dtype)
        self.conv1 = Conv2d(2048, 2048, 3, padding=1, **kw)
        self.cls_loc = Linear(2048, n_class * 4, **kw)
        self.score = Linear(2048, n_class, **kw)
        self.deconv1 = ConvTranspose2d(2048, 256, 2, stride=2, **kw)
        self.conv2 = Conv2d(256, n_class - 1, 3, padding=1, **kw)

    def _trunk(self, pooled, train: bool):
        h = F.relu(self.res5(pooled.permute(0, 3, 1, 2), train))
        return F.relu(self.conv1(h))

    def _mask(self, h, class_idx):
        out = self.conv2(F.relu(self.deconv1(h))).float()
        return select_class(out.permute(0, 2, 3, 1), class_idx)

    def _box(self, h):
        gap = h.mean(dim=(2, 3))
        return self.cls_loc(gap).float(), self.score(gap).float()

    def box(self, pooled, train: bool = False):
        """pooled (R, 7, 7, 1024) → (locs (R, n_class·4), scores (R,
        n_class)), float32."""
        return self._box(self._trunk(pooled, train))

    def predict_mask(self, pooled, class_idx=None, train: bool = False):
        """pooled (R, 7, 7, 1024) → (R, 14, 14, n_class − 1) float32 logits,
        or each ROI's ``class_idx`` channel (R, 14, 14)."""
        return self._mask(self._trunk(pooled, train), class_idx)

    def forward(self, pooled_box, pooled_mask=None, train: bool = False):
        """Both branches from the trunk of ``pooled_box`` (the two pools are
        the same 7×7 here), as the JAX head computes them."""
        h = self._trunk(pooled_box, train)
        locs, scores = self._box(h)
        if pooled_mask is None:
            return locs, scores, None
        return locs, scores, self._mask(h, None)
