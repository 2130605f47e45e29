"""Fixed-shape exact greedy NMS (port of ``maskrcnn_tpu/ops/nms.py``).

``nms_padded`` keeps ``n_out`` slots plus a validity mask: it sorts by
score, solves the greedy recurrence ``keep[i] = valid[i] and no kept j
before i with IoU(j, i) > t`` and compacts the kept boxes, all on the
tensors' device with no host sync, so a train step that runs it can be
captured into a CUDA graph. The recurrence is acyclic (edges only run from
earlier to later boxes in score order), so its fixpoint is unique and
equals sequential greedy NMS; any exact method returns the same indices.
On the card it is the hand-written kernel of
:mod:`maskrcnn_tpu_torch.kernels.nms_cuda` (a 64-bit suppression mask over
the upper triangle, 9 MB an image at the train step's 12000 boxes, then a
walk 64 boxes at a time, one SM a problem, every problem of the call at
once); on the CPU its plain version, the Jacobi loop. The JAX package
streams chunks above 4096 boxes to bound TPU memory; the indices are the
same.

Leading dimensions batch independent problems, one kernel launch a call:
the RPN runs a batch's (B, n_pre) scores in one call, predict's per-class
NMS a batch's (B, n_fg, R).
"""

from __future__ import annotations

import torch

from maskrcnn_tpu_torch.kernels.nms_cuda import nms_greedy

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

    lead = scores.shape[:-1]
    keep = nms_greedy(boxes_s.reshape(-1, n, 4).contiguous(),
                      valid_s.reshape(-1, n).contiguous(), iou_thresh,
                      n_out).reshape(lead + (n,))

    # compact the kept boxes (already score-sorted) into n_out slots
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


def batched_nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    iou_thresh: float,
    n_out: int,
    valid: torch.Tensor | None = None,
    coord_bound: float = 4096.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS in one pass (JAX ``batched_nms_padded``): each box
    moves by ``class_id · 2·coord_bound`` on both axes, so boxes of different
    classes never overlap. ``coord_bound`` must exceed every coordinate's
    magnitude. Same arguments and results as :func:`nms_padded`, plus
    ``class_ids`` (N,)."""
    offset = class_ids.to(boxes.dtype)[:, None] * (2.0 * coord_bound)
    return nms_padded(boxes + offset, scores, iou_thresh, n_out, valid)
