"""Light-Head R-CNN head (port of ``maskrcnn_tpu/models/heads/light_head.py``,
arXiv:1711.07264).

The thin feature map: two large separable conv paths on the one C4 level,
(15, 1) then (1, 15) and (1, 15) then (15, 1), 1024 → 256 → 490 channels,
summed with no activation. ROIs pool 7×7 from it for both branches. Box
branch: the pool flattened in HWC order (as flax's reshape), fc 2048 +
relu, class-agnostic ``cls_loc`` (4) and ``score``. Mask branch: three 3×3
conv256 + relu, then the 2×2/2 transposed conv to ``n_class − 1`` at 14².
``compat_mask_bug=True`` is the reference graph, which deconvolves the raw
490-channel pool and has no ``conv2``..``conv4`` (flax creates no
parameters for them either). Every layer computes in ``dtype``; locs,
scores and mask logits return as float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from maskrcnn_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear


def _nchw(pooled: torch.Tensor) -> torch.Tensor:
    return pooled.permute(0, 3, 1, 2)


def select_class(out: torch.Tensor, class_idx) -> torch.Tensor:
    """(R, S, S, K) mask logits → each ROI's ``class_idx`` channel (R, S, S),
    the index clamped into [0, K) as the JAX package's gathers clip it; all
    of them when ``class_idx`` is None."""
    if class_idx is None:
        return out
    idx = class_idx.long().clamp(0, out.shape[-1] - 1)
    return torch.gather(out, 3, idx[:, None, None, None].expand(
        -1, *out.shape[1:3], 1))[..., 0]


class ThinFeatureMap(nn.Module):
    def __init__(self, in_channels: int = 1024, c_mid: int = 256,
                 c_out: int = 490, k: int = 15,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p = k // 2
        kw = dict(compute_dtype=dtype)
        self.conv_ul = Conv2d(in_channels, c_mid, (k, 1), padding=(p, 0), **kw)
        self.conv_bl = Conv2d(c_mid, c_out, (1, k), padding=(0, p), **kw)
        self.conv_ur = Conv2d(in_channels, c_mid, (1, k), padding=(0, p), **kw)
        self.conv_br = Conv2d(c_mid, c_out, (k, 1), padding=(p, 0), **kw)

    def forward(self, x):
        """NCHW (B, 1024, H, W) → (B, 490, H, W) in ``dtype``."""
        return self.conv_bl(self.conv_ul(x)) + self.conv_br(self.conv_ur(x))


class LightHead(nn.Module):
    mask_size = 14
    roi_size_box = 7
    roi_size_mask = 7  # one 7×7 pool feeds both branches
    thin_channels = 490

    def __init__(self, n_class: int, compat_mask_bug: bool = False,
                 in_channels: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=dtype)
        c = self.thin_channels
        self.compat_mask_bug = compat_mask_bug
        self.thin = ThinFeatureMap(in_channels, c_out=c, dtype=dtype)
        self.fc = Linear(c * self.roi_size_box ** 2, 2048, **kw)
        self.cls_loc = Linear(2048, 4, **kw)
        self.score = Linear(2048, n_class, **kw)
        if not compat_mask_bug:
            self.conv2 = Conv2d(c, 256, 3, padding=1, **kw)
            self.conv3 = Conv2d(256, 256, 3, padding=1, **kw)
            self.conv4 = Conv2d(256, 256, 3, padding=1, **kw)
        self.deconv1 = ConvTranspose2d(c if compat_mask_bug else 256,
                                       n_class - 1, 2, stride=2, **kw)

    def thin_map(self, feature: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1024) → the thin map (B, H, W, 490), an NHWC view."""
        return self.thin(feature.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def box(self, pooled):
        """pooled (R, 7, 7, 490) → (locs (R, 4), scores (R, n_class)),
        float32."""
        h = F.relu(self.fc(pooled.reshape(pooled.shape[0], -1)))
        return self.cls_loc(h).float(), self.score(h).float()

    def predict_mask(self, pooled, class_idx=None):
        """pooled (R, 7, 7, 490) → (R, 14, 14, n_class − 1) float32 logits,
        or each ROI's ``class_idx`` channel (R, 14, 14)."""
        h = _nchw(pooled)
        if not self.compat_mask_bug:
            h = F.relu(self.conv2(h))
            h = F.relu(self.conv3(h))
            h = F.relu(self.conv4(h))
        return select_class(self.deconv1(h).float().permute(0, 2, 3, 1),
                            class_idx)

    def forward(self, pooled_box, pooled_mask=None):
        locs, scores = self.box(pooled_box)
        if pooled_mask is None:
            return locs, scores, None
        return locs, scores, self.predict_mask(pooled_mask)
