"""Instance-segmentation AP evaluation on host.

Two metrics:
- ``eval_instance_segmentation_voc`` — VOC-style mask AP@0.5, the behavioral
  spec of chainercv's function used by the reference evaluator
  (reference evaluator.py:86-90): score-descending greedy matching of
  predicted masks to unmatched same-class GT by mask IoU, continuous
  (area-under-PR) AP per class, mAP over classes present in GT.
- ``eval_instance_segmentation_coco_style`` — AP averaged over IoU
  0.50:0.95:0.05 (the reference has NO COCO-API evaluation — SURVEY §2 #21
  flags this as a gap; BASELINE.json's metric requires it).

Pure numpy; inputs are per-image lists. Masks are (N, H, W) bool arrays.
"""

from __future__ import annotations

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, H, W) × (M, H, W) bool → (N, M) IoU."""
    n, m = len(a), len(b)
    out = np.zeros((n, m), np.float32)
    a_area = a.reshape(n, -1).sum(axis=1)
    b_area = b.reshape(m, -1).sum(axis=1)
    af = a.reshape(n, -1)
    bf = b.reshape(m, -1)
    inter = af.astype(np.float32) @ bf.astype(np.float32).T
    union = a_area[:, None] + b_area[None, :] - inter
    np.divide(inter, np.maximum(union, 1), out=out)
    return out


def _voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Continuous (every-point) VOC AP."""
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())


def _per_class_ap(
    pred_masks, pred_labels, pred_scores, gt_masks, gt_labels,
    n_class: int, iou_thresh: float,
) -> np.ndarray:
    """AP per class at one IoU threshold. NaN for classes with no GT."""
    n_img = len(pred_masks)
    # Collect detections per class: (score, img, idx), and GT counts.
    ap = np.full(n_class, np.nan, np.float64)

    # Precompute per-image IoU between predictions and GT of same class.
    for cls in range(n_class):
        scores, matches = [], []
        n_gt = 0
        for i in range(n_img):
            p_sel = np.where(pred_labels[i] == cls)[0]
            g_sel = np.where(gt_labels[i] == cls)[0]
            n_gt += len(g_sel)
            if len(p_sel) == 0:
                continue
            order = np.argsort(-pred_scores[i][p_sel])
            p_sel = p_sel[order]
            if len(g_sel) == 0:
                scores.extend(pred_scores[i][p_sel].tolist())
                matches.extend([0] * len(p_sel))
                continue
            iou = mask_iou(pred_masks[i][p_sel], gt_masks[i][g_sel])
            taken = np.zeros(len(g_sel), bool)
            for k in range(len(p_sel)):
                j = int(iou[k].argmax())
                if iou[k, j] >= iou_thresh and not taken[j]:
                    taken[j] = True
                    matches.append(1)
                else:
                    matches.append(0)
                scores.append(float(pred_scores[i][p_sel[k]]))
        if n_gt == 0:
            continue
        if not scores:
            ap[cls] = 0.0
            continue
        order = np.argsort(-np.asarray(scores), kind="stable")
        m = np.asarray(matches)[order]
        tp = np.cumsum(m)
        fp = np.cumsum(1 - m)
        rec = tp / n_gt
        prec = tp / np.maximum(tp + fp, 1)
        ap[cls] = _voc_ap(rec, prec)
    return ap


def eval_instance_segmentation_voc(
    pred_masks, pred_labels, pred_scores, gt_masks, gt_labels,
    n_class: int, iou_thresh: float = 0.5,
) -> dict:
    """{'ap': (n_class,) with NaN for absent classes, 'map': float}."""
    ap = _per_class_ap(
        pred_masks, pred_labels, pred_scores, gt_masks, gt_labels,
        n_class, iou_thresh,
    )
    return {"ap": ap, "map": float(np.nanmean(ap)) if np.isfinite(ap).any() else 0.0}


def eval_instance_segmentation_coco_style(
    pred_masks, pred_labels, pred_scores, gt_masks, gt_labels, n_class: int
) -> dict:
    """COCO-style mask AP: mean over IoU thresholds 0.50:0.95:0.05."""
    thresholds = np.arange(0.5, 1.0, 0.05)
    aps = np.stack([
        _per_class_ap(pred_masks, pred_labels, pred_scores, gt_masks,
                      gt_labels, n_class, float(t))
        for t in thresholds
    ])  # (T, n_class)
    ap_per_class = np.nanmean(aps, axis=0)
    return {
        "ap": ap_per_class,
        "map": float(np.nanmean(ap_per_class)) if np.isfinite(ap_per_class).any() else 0.0,
        "map50": float(np.nanmean(aps[0])) if np.isfinite(aps[0]).any() else 0.0,
        "map75": float(np.nanmean(aps[5])) if np.isfinite(aps[5]).any() else 0.0,
    }
