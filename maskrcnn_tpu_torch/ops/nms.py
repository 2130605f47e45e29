"""Fixed-shape exact greedy NMS (port of ``maskrcnn_tpu/ops/nms.py``).

``nms_padded`` keeps ``n_out`` slots plus a validity mask. It solves the
greedy recurrence ``keep[i] = valid[i] and no kept j before i with
IoU(j, i) > t`` by Jacobi iteration over the full IoU matrix, stopping at
convergence. The system is acyclic (edges only run from earlier to later
boxes in score order), so the fixpoint is unique and equals sequential
greedy NMS; any exact method returns the same indices. The JAX package
streams chunks above 4096 boxes to bound TPU memory; one H100 holds the
6000-box matrix of the test-time RPN budget (144 MB) outright.

Leading dimensions batch independent problems: per-class NMS in predict
runs (n_fg, R) scores in one call.
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.ops.boxes import box_iou

_NEG_INF = -1e30


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_thresh: float,
    n_out: int,
    valid: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over (..., N) padded boxes → (..., n_out) slots.

    Args:
      boxes: (..., N, 4) yxyx.
      scores: (..., N).
      iou_thresh: suppression threshold (0.7 RPN, 0.3 per-class predict).
      n_out: number of output slots.
      valid: optional (..., N) bool; invalid slots are never selected and
        never suppress.

    Returns:
      (indices int32 (..., n_out), out_valid bool (..., n_out)); indices are
      0 in invalid slots and score-descending among kept boxes. Invalid
      boxes score −1e30 and score ties keep input order (stable sort).
    """
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    masked = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.argsort(-masked, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    valid_s = torch.gather(valid, -1, order)

    pos = torch.arange(n, device=boxes.device)
    earlier = pos[:, None] < pos[None, :]
    # sup[..., j, i]: kept box j (earlier in score order) suppresses box i
    sup = ((box_iou(boxes_s, boxes_s) > iou_thresh) & earlier).float()
    keep = valid_s
    for _ in range(n + 1):
        hit = torch.matmul(keep.float()[..., None, :], sup)[..., 0, :]
        new = valid_s & (hit < 0.5)
        if torch.equal(new, keep):
            break
        keep = new

    # compact the kept boxes (already score-sorted) into n_out slots
    rank = torch.cumsum(keep.long(), dim=-1) - 1
    in_range = keep & (rank < n_out)
    slot = torch.where(in_range, rank, torch.full_like(rank, n_out))
    lead = keep.shape[:-1]
    indices = torch.zeros(lead + (n_out + 1,), dtype=torch.long,
                          device=boxes.device).scatter_(-1, slot, order)
    out_valid = torch.zeros(lead + (n_out + 1,), dtype=torch.bool,
                            device=boxes.device).scatter_(-1, slot, in_range)
    indices, out_valid = indices[..., :n_out], out_valid[..., :n_out]
    indices = torch.where(out_valid, indices, torch.zeros_like(indices))
    return indices.to(torch.int32), out_valid
