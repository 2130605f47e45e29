"""Box ops on torch tensors in (y0, x0, y1, x1) order.

Port of ``maskrcnn_tpu/ops/boxes.py`` (chainercv ``loc2bbox`` / ``bbox_iou``
semantics). Elementwise and broadcast math only; padded (invalid) boxes flow
through as ordinary numbers and are masked by the caller.
"""

from __future__ import annotations

import torch

# Clamp on the decoded log-size offsets (log(1000 / 16), the Detectron bound)
# so garbage padded inputs cannot overflow exp.
_MAX_DLOG = 4.135166556742356


def box_hw(boxes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Heights and widths of (..., 4) yxyx boxes."""
    return boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    h, w = box_hw(boxes)
    return h * w


def loc2bbox(src_bbox: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """Decode (ty, tx, th, tw) offsets on top of ``src`` boxes → yxyx boxes."""
    src_height, src_width = box_hw(src_bbox)
    src_ctr_y = src_bbox[..., 0] + 0.5 * src_height
    src_ctr_x = src_bbox[..., 1] + 0.5 * src_width

    dh = loc[..., 2].clamp(-_MAX_DLOG, _MAX_DLOG)
    dw = loc[..., 3].clamp(-_MAX_DLOG, _MAX_DLOG)
    ctr_y = loc[..., 0] * src_height + src_ctr_y
    ctr_x = loc[..., 1] * src_width + src_ctr_x
    h = torch.exp(dh) * src_height
    w = torch.exp(dw) * src_width
    return torch.stack(
        [ctr_y - 0.5 * h, ctr_x - 0.5 * w, ctr_y + 0.5 * h, ctr_x + 0.5 * w],
        dim=-1,
    )


def bbox2loc(src_bbox: torch.Tensor, dst_bbox: torch.Tensor) -> torch.Tensor:
    """Encode ``dst`` boxes relative to ``src`` boxes as (ty, tx, th, tw);
    sizes are floored at the float epsilon so padded boxes stay finite."""
    height, width = box_hw(src_bbox)
    ctr_y = src_bbox[..., 0] + 0.5 * height
    ctr_x = src_bbox[..., 1] + 0.5 * width
    base_height, base_width = box_hw(dst_bbox)
    base_ctr_y = dst_bbox[..., 0] + 0.5 * base_height
    base_ctr_x = dst_bbox[..., 1] + 0.5 * base_width

    eps = torch.finfo(src_bbox.dtype).eps
    height, width = height.clamp(min=eps), width.clamp(min=eps)
    base_height = base_height.clamp(min=eps)
    base_width = base_width.clamp(min=eps)
    return torch.stack(
        [(base_ctr_y - ctr_y) / height, (base_ctr_x - ctr_x) / width,
         torch.log(base_height / height), torch.log(base_width / width)],
        dim=-1,
    )


def box_iou(bbox_a: torch.Tensor, bbox_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) × (..., M, 4) yxyx boxes → (..., N, M).

    Degenerate or padded boxes have zero area and hence zero IoU.
    """
    a = bbox_a[..., :, None, :]
    b = bbox_b[..., None, :, :]
    ty = torch.maximum(a[..., 0], b[..., 0])
    tx = torch.maximum(a[..., 1], b[..., 1])
    by = torch.minimum(a[..., 2], b[..., 2])
    bx = torch.minimum(a[..., 3], b[..., 3])
    inter = (by - ty).clamp(min=0.0) * (bx - tx).clamp(min=0.0)
    area_a = box_area(bbox_a).clamp(min=0.0)
    area_b = box_area(bbox_b).clamp(min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12),
                       torch.zeros_like(inter))


def clip_boxes(boxes: torch.Tensor, img_size) -> torch.Tensor:
    """Clip yxyx boxes to [0, H] × [0, W]; ``img_size`` = (H, W), numbers or
    0-d tensors."""
    h = torch.as_tensor(img_size[0], dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(img_size[1], dtype=boxes.dtype, device=boxes.device)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    return torch.stack(
        [
            torch.clamp(boxes[..., 0], zero, h),
            torch.clamp(boxes[..., 1], zero, w),
            torch.clamp(boxes[..., 2], zero, h),
            torch.clamp(boxes[..., 3], zero, w),
        ],
        dim=-1,
    )
