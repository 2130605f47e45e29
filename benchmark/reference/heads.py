"""FPN ROI heads, box+mask and box+keypoint (port of
``maskrcnn_tpu/models/heads/fpn_heads.py``).

Box branch: pooled 7×7 → 3×3 conv256+relu → fc1024 → fc1024 → class-agnostic
loc (4) + score (n_class). Mask branch: pooled 14×14 → n× 3×3 conv256+relu →
2×2/2 transposed conv → 1×1 conv to n_class−1 (no relu between the last
two). Keypoint branch: pooled 14×14 → n× 3×3 conv256+relu → 2×2/2
transposed conv → 1×1 conv to n_keypoints → bilinear ×2 in float32 → 56×56
heatmap logits. Pooled inputs arrive in the JAX layout (R, S, S, C); the box
branch flattens its conv output in HWC order, as the JAX head does, so
``fc1`` takes the JAX kernel's rows unpermuted. Every conv, dense layer, the
transposed conv and the class-gathered final conv compute in ``dtype``;
locs, scores, mask logits and heatmaps return as float32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.layers import Conv2d, ConvTranspose2d, Linear


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


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear ×2 with align_corners=True on (R, C, H, W): output pixel i
    samples input coordinate i·(n−1)/(2n−1). Two float32 interpolation
    matrices, rows first, built as the JAX package builds them."""

    def mat(n: int) -> torch.Tensor:
        coords = torch.arange(2 * n, device=x.device) * (n - 1) / (2 * n - 1)
        lo = torch.floor(coords).long()
        hi = (lo + 1).clamp(max=n - 1)
        w_hi = coords - lo
        m = torch.zeros((2 * n, n), device=x.device)
        rows = torch.arange(2 * n, device=x.device)
        m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
        m.index_put_((rows, hi), w_hi, accumulate=True)
        return m

    x = torch.einsum("ih,rchw->rciw", mat(x.shape[2]), x)
    return torch.einsum("jw,rciw->rcij", mat(x.shape[3]), x)


class KeypointBranch(nn.Module):
    """n_convs× conv256 → 2×2/2 transposed conv → 1×1 conv to n_keypoints →
    bilinear ×2: 14² pooled → (R, 56, 56, K) float32 heatmap logits.
    ``upsample="half_pixel"`` is the JAX package's ``jax.image.resize``
    (``"linear"``), which at ×2 equals ``F.interpolate(...,
    align_corners=False)``; ``"align_corners"`` is chainer's resize."""

    def __init__(self, n_keypoints: int, n_convs: int = 8, in_channels: int = 256,
                 dtype: torch.dtype = torch.float32, upsample: str = "half_pixel"):
        super().__init__()
        if upsample not in ("half_pixel", "align_corners"):
            raise ValueError(f"kp_upsample={upsample!r}: 'half_pixel' or "
                             "'align_corners'")
        for i in range(n_convs):
            self.add_module(f"mask{i + 1}", Conv2d(
                in_channels if i == 0 else 256, 256, 3, padding=1,
                compute_dtype=dtype))
        self.n_convs = n_convs
        self.upsample = upsample
        self.deconv1 = ConvTranspose2d(256, 256, 2, stride=2, compute_dtype=dtype)
        self.conv2 = Conv2d(256, n_keypoints, 1, compute_dtype=dtype)

    def forward(self, pooled):
        h = _nchw(pooled)
        for i in range(self.n_convs):
            h = F.relu(getattr(self, f"mask{i + 1}")(h))
        h = self.conv2(self.deconv1(h)).float()  # (R, K, 28, 28)
        if self.upsample == "align_corners":
            h = _upsample2x_align_corners(h)
        else:
            h = F.interpolate(h, scale_factor=2, mode="bilinear",
                              align_corners=False)
        return h.permute(0, 2, 3, 1)


class FPNKeypointHead(nn.Module):
    mask_size = 56
    roi_size_box = 7
    roi_size_mask = 14

    def __init__(self, n_class: int, n_keypoints: int = 17, n_mask_convs: int = 8,
                 in_channels: int = 256, dtype: torch.dtype = torch.float32,
                 upsample: str = "half_pixel"):
        super().__init__()
        self.box = BoxBranch(n_class, in_channels, self.roi_size_box, dtype=dtype)
        self.mask = KeypointBranch(n_keypoints, n_mask_convs, in_channels, dtype,
                                   upsample)

    def forward(self, pooled_box, pooled_mask=None):
        locs, scores = self.box(pooled_box)
        if pooled_mask is None:
            return locs, scores, None
        return locs, scores, self.mask(pooled_mask)

    def predict_mask(self, pooled_mask, class_idx=None):
        """Heatmaps of every keypoint: there is no class to gather."""
        if class_idx is not None:
            raise ValueError("the keypoint head takes no class_idx")
        return self.mask(pooled_mask)
