"""FPN box+mask ROI head (port of ``maskrcnn_tpu/models/heads/fpn_heads.py``).

Box branch: pooled 7×7 → 3×3 conv256+relu → fc1024 → fc1024 → class-agnostic
loc (4) + score (n_class). Mask branch: pooled 14×14 → n× 3×3 conv256+relu →
2×2/2 transposed conv → 1×1 conv to n_class−1 (no relu between the last
two). Pooled inputs arrive in the JAX layout (R, S, S, C); the box branch
flattens its conv output in HWC order, as the JAX head does, so ``fc1``
takes the JAX kernel's rows unpermuted. Every conv, dense layer, the
transposed conv and the class-gathered final conv compute in ``dtype``;
locs, scores and mask logits return as float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from maskrcnn_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear


def _nchw(pooled: torch.Tensor) -> torch.Tensor:
    """(R, S, S, C) → an NCHW view in channels_last memory."""
    return pooled.permute(0, 3, 1, 2)


class BoxBranch(nn.Module):
    def __init__(self, n_class: int, in_channels: int = 256, roi_size: int = 7,
                 n_loc: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=dtype)
        self.conv1 = Conv2d(in_channels, 256, 3, padding=1, **kw)
        self.fc1 = Linear(256 * roi_size * roi_size, 1024, **kw)
        self.fc2 = Linear(1024, 1024, **kw)
        self.cls_loc = Linear(1024, n_loc, **kw)
        self.score = Linear(1024, n_class, **kw)

    def forward(self, pooled):
        """pooled (R, S, S, C) → (locs (R, n_loc), scores (R, n_class)),
        float32."""
        h = F.relu(self.conv1(_nchw(pooled)))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # HWC flatten
        h = F.relu(self.fc1(h))
        h = F.relu(self.fc2(h))
        return self.cls_loc(h).float(), self.score(h).float()


class MaskBranch(nn.Module):
    """With ``class_idx`` the final 1×1 conv evaluates only each ROI's class
    channel → (R, 28, 28); without it, every channel → (R, 28, 28, n_out).
    Logits are float32."""

    def __init__(self, n_out: int, n_convs: int = 4, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for i in range(n_convs):
            self.add_module(f"mask{i + 1}", Conv2d(
                in_channels if i == 0 else 256, 256, 3, padding=1,
                compute_dtype=dtype))
        self.n_convs = n_convs
        self.deconv1 = ConvTranspose2d(256, 256, 2, stride=2, compute_dtype=dtype)
        self.conv2_weight = nn.Parameter(torch.empty(n_out, 256))
        self.conv2_bias = nn.Parameter(torch.zeros(n_out))

    def forward(self, pooled, class_idx=None):
        h = _nchw(pooled)
        for i in range(self.n_convs):
            h = F.relu(getattr(self, f"mask{i + 1}")(h))
        h = self.deconv1(h)  # (R, 256, 28, 28)
        dt = self.dtype
        if class_idx is None:
            out = (torch.einsum("rchw,oc->rhwo", h, self.conv2_weight.to(dt))
                   + self.conv2_bias.to(dt))
            return out.float()
        idx = class_idx.long().clamp(0, self.conv2_weight.shape[0] - 1)
        out = (torch.einsum("rchw,rc->rhw", h, self.conv2_weight[idx].to(dt))
               + self.conv2_bias[idx].to(dt)[:, None, None])
        return out.float()


class FPNMaskHead(nn.Module):
    mask_size = 28
    roi_size_box = 7
    roi_size_mask = 14

    def __init__(self, n_class: int, n_mask_convs: int = 4, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.box = BoxBranch(n_class, in_channels, self.roi_size_box, dtype=dtype)
        self.mask = MaskBranch(n_class - 1, n_mask_convs, in_channels, dtype)

    def forward(self, pooled_box, pooled_mask=None, class_idx=None):
        locs, scores = self.box(pooled_box)
        if pooled_mask is None:
            return locs, scores, None
        return locs, scores, self.mask(pooled_mask, class_idx)

    def predict_mask(self, pooled_mask, class_idx=None):
        return self.mask(pooled_mask, class_idx)
