"""The 5-term Mask R-CNN loss, fixed-shape with validity masks (port of
``maskrcnn_tpu/train/losses.py``).

chainercv's ``_fast_rcnn_loc_loss``: smooth-L1 on positive rows only,
normalized by #(label ≥ 0); σ=3 for the RPN, σ=1 for the head. Ignored
entries carry label −1 (chainer's ``ignore_label``); padded slots are mapped
to −1 before the loss. Every loss is ``numerator_sum / valid_count``, the
count being that of the batch it is given.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F


def smooth_l1(x: torch.Tensor, t: torch.Tensor, sigma: float) -> torch.Tensor:
    """Elementwise smooth-L1 (chainercv ``_smooth_l1_loss``, no reduction)."""
    sigma2 = sigma ** 2
    diff = x - t
    abs_diff = diff.abs()
    return torch.where(abs_diff < 1.0 / sigma2, 0.5 * diff * diff * sigma2,
                       abs_diff - 0.5 / sigma2)


def _count(count: torch.Tensor) -> torch.Tensor:
    """Valid-count denominator, at least 1."""
    return count.float().clamp(min=1.0)


def fast_rcnn_loc_loss(pred_loc, gt_loc, labels, sigma: float) -> torch.Tensor:
    """pred_loc, gt_loc (N, 4); labels (N,): >0 pos, 0 neg, −1 ignore →
    smooth-L1 summed over positive rows / #(label ≥ 0)."""
    pos = (labels > 0).float()[:, None]
    loss = (smooth_l1(pred_loc, gt_loc, sigma) * pos).sum()
    return loss / _count((labels >= 0).sum())


def softmax_ce_ignore(logits, labels) -> torch.Tensor:
    """logits (N, C); labels (N,), −1 = ignore → mean softmax cross-entropy
    over the non-ignored rows."""
    valid = labels >= 0
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / _count(valid.sum())


def sigmoid_mask_loss(mask_logits, mask_targets, labels, is_pos) -> torch.Tensor:
    """Sigmoid cross-entropy of each positive's GT-class mask channel,
    averaged over all pixels of the positive samples. ``mask_logits`` is
    (N, S, S), already gathered to the GT class, or the full (N, S, S, n_fg)
    stack; ``labels`` (N,) use background 0."""
    if mask_logits.dim() == 3:
        sel = mask_logits
    else:
        ch = (labels.long() - 1).clamp(0, mask_logits.shape[-1] - 1)
        sel = torch.gather(
            mask_logits, 3,
            ch[:, None, None, None].expand(-1, *mask_logits.shape[1:3], 1))[..., 0]
    ce = (sel.clamp(min=0.0) - sel * mask_targets
          + torch.log1p(torch.exp(-sel.abs())))
    w = is_pos.float()[:, None, None]
    return (ce * w).sum() / (_count(w.sum()) * ce.shape[1] * ce.shape[2])


class LossBreakdown(NamedTuple):
    loss: torch.Tensor
    rpn_loc_loss: torch.Tensor
    rpn_cls_loss: torch.Tensor
    roi_loc_loss: torch.Tensor
    roi_cls_loss: torch.Tensor
    mask_loss: torch.Tensor


def select_roi_locs(roi_cls_locs, labels) -> torch.Tensor:
    """Class-agnostic heads (N, 4) pass through; per-class heads
    (N, n_class·4) gather the GT class's 4-vector."""
    if roi_cls_locs.shape[-1] == 4:
        return roi_cls_locs
    per_class = roi_cls_locs.reshape(roi_cls_locs.shape[0], -1, 4)
    safe = labels.clamp(0, per_class.shape[1] - 1).long()
    return torch.gather(per_class, 1, safe[:, None, None].expand(-1, 1, 4))[:, 0]
