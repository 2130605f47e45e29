"""Keypoint evaluation: OKS-based AP and PCK.

The reference trains keypoint models (train_keypoints.py) but ships NO
keypoint evaluation at all (its evaluator only does mask mAP — SURVEY §2
#21); this fills the gap with the COCO OKS metric (object keypoint
similarity) and the simpler PCK (percentage of correct keypoints), so
keypoint configs have a quality signal beyond the loss curve.
"""

from __future__ import annotations

import numpy as np

# COCO per-keypoint sigmas (kappa_i); extras (neck/chest/pelvis of the
# 20-kp depth model) reuse the shoulder/hip scale.
COCO_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
], np.float32)


def keypoint_sigmas(k: int) -> np.ndarray:
    if k <= 17:
        return COCO_SIGMAS[:k]
    extra = np.full(k - 17, 0.079, np.float32)
    return np.concatenate([COCO_SIGMAS, extra])


def oks(
    pred: np.ndarray,  # (K, 2) (y, x)
    gt: np.ndarray,  # (K, 3) (y, x, v)
    area: float,
    sigmas: np.ndarray | None = None,
) -> float:
    """Object keypoint similarity of one instance pair (COCO eqn)."""
    k = gt.shape[0]
    sigmas = sigmas if sigmas is not None else keypoint_sigmas(k)
    vis = gt[:, 2] > 0
    if not vis.any():
        return 0.0
    d2 = ((pred[:, 0] - gt[:, 0]) ** 2 + (pred[:, 1] - gt[:, 1]) ** 2)
    var = (2 * sigmas) ** 2
    e = d2 / (2 * var * max(area, 1.0))
    return float(np.exp(-e[vis]).mean())


def eval_keypoints_oks_ap(
    pred_kps,  # per image: (N, K, 3) (y, x, score)
    pred_scores,  # per image: (N,) instance scores
    gt_kps,  # per image: (M, K, 3) (y, x, v)
    gt_areas,  # per image: (M,) box areas
    thresholds: np.ndarray | None = None,
) -> dict:
    """COCO-style keypoint AP: greedy OKS matching, AP over OKS thresholds."""
    thresholds = (
        thresholds if thresholds is not None else np.arange(0.5, 1.0, 0.05)
    )
    scores_all, oks_all = [], []
    n_gt = 0
    for p_kp, p_sc, g_kp, g_area in zip(pred_kps, pred_scores, gt_kps, gt_areas):
        n_gt += len(g_kp)
        if len(p_kp) == 0:
            continue
        order = np.argsort(-np.asarray(p_sc), kind="stable")
        taken = np.zeros(len(g_kp), bool)
        for i in order:
            best, best_j = 0.0, -1
            for j in range(len(g_kp)):
                if taken[j]:
                    continue
                o = oks(p_kp[i][:, :2], g_kp[j], float(g_area[j]))
                if o > best:
                    best, best_j = o, j
            if best_j >= 0 and best > 0:
                taken[best_j] = True
            scores_all.append(float(p_sc[i]))
            oks_all.append(best)

    if n_gt == 0:
        return {"ap": 0.0, "ap50": 0.0, "ap75": 0.0}
    if not scores_all:
        return {"ap": 0.0, "ap50": 0.0, "ap75": 0.0}

    order = np.argsort(-np.asarray(scores_all), kind="stable")
    oks_arr = np.asarray(oks_all)[order]

    def ap_at(t):
        tp = np.cumsum(oks_arr >= t)
        fp = np.cumsum(oks_arr < t)
        rec = tp / n_gt
        prec = tp / np.maximum(tp + fp, 1)
        # continuous AP
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    aps = [ap_at(t) for t in thresholds]
    return {"ap": float(np.mean(aps)), "ap50": ap_at(0.5), "ap75": ap_at(0.75)}


def pck(
    pred_kps,  # per image: (N, K, 3)
    gt_kps,  # per image: (M, K, 3) — N must equal M, index-aligned
    gt_boxes,  # per image: (M, 4) yxyx for the normalization scale
    alpha: float = 0.2,
) -> float:
    """Percentage of visible keypoints within alpha·max(box side) of GT."""
    correct = total = 0
    for p, g, boxes in zip(pred_kps, gt_kps, gt_boxes):
        for i in range(min(len(p), len(g))):
            side = max(
                boxes[i][2] - boxes[i][0], boxes[i][3] - boxes[i][1]
            )
            vis = g[i][:, 2] > 0
            d = np.sqrt(
                (p[i][:, 0] - g[i][:, 0]) ** 2
                + (p[i][:, 1] - g[i][:, 1]) ** 2
            )
            correct += int((d[vis] <= alpha * side).sum())
            total += int(vis.sum())
    return correct / max(total, 1)
