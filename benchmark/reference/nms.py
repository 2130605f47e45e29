"""Fixed-shape exact greedy NMS in plain torch.

``nms_padded`` sorts by score (stable), solves the greedy recurrence
``keep[i] = valid[i] and no kept j before i with IoU(j, i) > t`` by Jacobi
sweeps over the full suppression matrix until nothing changes (the
recurrence is acyclic, so its fixpoint is unique and equals sequential
greedy NMS), and compacts the kept boxes into ``n_out`` slots with a
validity mask. Leading dimensions batch independent problems.
"""

from __future__ import annotations

import torch

from benchmark.reference.boxes import box_iou

_NEG_INF = -1e30


def suppression(boxes_s, iou_thresh: float) -> torch.Tensor:
    """sup[..., j, i]: box j lies before box i and IoU(j, i) > thresh."""
    n = boxes_s.shape[-2]
    pos = torch.arange(n, device=boxes_s.device)
    return (box_iou(boxes_s, boxes_s) > iou_thresh) & (pos[:, None] < pos[None, :])


def greedy_keep(boxes_s, valid_s, iou_thresh: float) -> torch.Tensor:
    """Jacobi sweeps ``keep ← valid & ¬(keepᵀ·sup)`` to the fixpoint →
    (..., N) bool, for boxes already sorted by descending score."""
    sup = suppression(boxes_s, iou_thresh).float()
    keep = valid_s
    for _ in range(boxes_s.shape[-2] + 1):
        hit = torch.matmul(keep.float()[..., None, :], sup)[..., 0, :]
        new = valid_s & (hit < 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
               n_out: int, valid: torch.Tensor | None = None):
    """Greedy NMS over (..., N) padded boxes → (indices int32 (..., n_out),
    out_valid bool (..., n_out)); indices are 0 in invalid slots and
    score-descending among kept boxes. Invalid boxes score −1e30 and never
    suppress; score ties keep input order."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.argsort(-masked, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    valid_s = torch.gather(valid, -1, order)
    lead = scores.shape[:-1]
    keep = greedy_keep(boxes_s.reshape(-1, n, 4), valid_s.reshape(-1, n),
                       iou_thresh).reshape(lead + (n,))
    rank = torch.cumsum(keep.long(), dim=-1) - 1
    in_range = keep & (rank < n_out)
    slot = torch.where(in_range, rank, torch.full_like(rank, n_out))
    indices = torch.zeros(lead + (n_out + 1,), dtype=torch.long,
                          device=boxes.device).scatter_(-1, slot, order)
    out_valid = torch.zeros(lead + (n_out + 1,), dtype=torch.bool,
                            device=boxes.device).scatter_(-1, slot, in_range)
    indices, out_valid = indices[..., :n_out], out_valid[..., :n_out]
    indices = torch.where(out_valid, indices, torch.zeros_like(indices))
    return indices.to(torch.int32), out_valid
