"""RPN training targets (port of ``maskrcnn_tpu/targets/anchor_targets.py``).

chainercv ``AnchorTargetCreator`` over the concatenated anchors of all
pyramid levels: 256 sampled anchors per image, positive at IoU ≥ 0.7 plus
every anchor that reaches a GT's best IoU, negative below 0.3, anchors not
fully inside the image ignored (label −1). Labels cover ALL anchors; the
"sampling" disables surplus positives and negatives at random.

The random subsets come from uniform priorities that the caller passes in
(``pos_u``, ``neg_u``), so a test can feed the draws of another framework.
Batched over the leading image dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskrcnn_tpu_torch.ops.boxes import bbox2loc, box_iou


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (B, A) int32: 1 pos, 0 neg, -1 ignore
    locs: torch.Tensor  # (B, A, 4) float32 bbox2loc targets (pos rows valid)


def keep_top_random(mask: torch.Tensor, u: torch.Tensor, k, k_max: int):
    """Keep a uniformly random subset of at most ``k`` True entries of each
    row of ``mask`` (B, N): those whose priority ``u`` reaches the ``k``-th
    largest priority among the row's True entries. ``k`` is an int or a (B,)
    tensor ≤ ``k_max``; ``k == 0`` keeps none. A threshold, not an index
    set: fewer than ``k`` True entries keeps them all."""
    k_max = min(k_max, mask.shape[-1])
    pri = torch.where(mask, u, torch.full_like(u, -1.0))
    top_vals = torch.topk(pri, k_max, dim=-1).values  # descending
    k = torch.as_tensor(k, device=mask.device).expand(mask.shape[0])
    kth = torch.gather(top_vals, 1, (k - 1).clamp(0, k_max - 1)[:, None].long())
    return mask & (pri >= kth) & (k > 0)[:, None]


def anchor_targets(
    pos_u: torch.Tensor,  # (B, A) uniform priorities of the positives
    neg_u: torch.Tensor,  # (B, A) of the negatives
    anchors: torch.Tensor,  # (A, 4)
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_valid: torch.Tensor,  # (B, G) bool
    img_hw: torch.Tensor,  # (B, 2) true content extent
    n_sample: int = 256,
    pos_iou_thresh: float = 0.7,
    neg_iou_thresh: float = 0.3,
    pos_ratio: float = 0.5,
) -> AnchorTargets:
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[None, :, 2] <= img_hw[:, None, 0])
              & (anchors[None, :, 3] <= img_hw[:, None, 1]))  # (B, A)

    iou = box_iou(anchors[None], gt_boxes)  # (B, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    max_iou, argmax_gt = iou.max(dim=2)
    max_iou = torch.where(gt_valid.any(dim=1, keepdim=True), max_iou,
                          torch.zeros_like(max_iou))

    # anchors that reach a GT's best IoU among the inside anchors are
    # positive (ties included), plus those at or above the threshold
    gt_max = torch.where(inside[:, :, None], iou,
                         torch.full_like(iou, -1.0)).amax(dim=1)  # (B, G)
    is_gt_argmax = ((iou >= gt_max[:, None, :] - 1e-7) & gt_valid[:, None, :]
                    & (gt_max[:, None, :] > 0)).any(dim=2)

    label = torch.full(inside.shape, -1, dtype=torch.int32, device=anchors.device)
    label = torch.where(inside & (max_iou < neg_iou_thresh), 0, label)
    label = torch.where(
        inside & (is_gt_argmax | (max_iou >= pos_iou_thresh)), 1, label)

    n_pos_cap = int(n_sample * pos_ratio)
    pos = label == 1
    pos_keep = keep_top_random(pos, pos_u, n_pos_cap, n_pos_cap)
    label = torch.where(pos & ~pos_keep, -1, label)

    n_pos = (label == 1).sum(dim=1)
    neg = label == 0
    neg_keep = keep_top_random(neg, neg_u, n_sample - n_pos, n_sample)
    label = torch.where(neg & ~neg_keep, -1, label)

    gt_sel = torch.gather(gt_boxes, 1, argmax_gt[:, :, None].expand(-1, -1, 4))
    return AnchorTargets(label, bbox2loc(anchors[None], gt_sel))
