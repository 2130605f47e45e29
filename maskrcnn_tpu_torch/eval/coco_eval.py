"""COCO-API instance-segmentation evaluation — pycocotools matching semantics.

The reference has NO COCO-API evaluation (its only metric is VOC mask
mAP@0.5, reference evaluator.py:86-90); BASELINE.json's north-star metric is
COCO val AP, so this module implements the full COCOeval semantics from the
published algorithm definition (Lin et al., COCO; pycocotools cocoeval):

- greedy score-descending matching per (image, category), each GT matched at
  most once, with the pycocotools tie-breaking order (candidate GTs visited
  ignored-last; a detection may *upgrade* its match to a higher-IoU GT while
  scanning, but never downgrades from a non-ignored to an ignored GT),
- crowd regions: a crowd GT is always "ignore", may match many detections,
  and its IoU against a detection uses intersection / detection-area
  (pycocotools iscrowd semantics) so detections inside a crowd are absorbed
  rather than counted as false positives,
- area-range tiers (all / small <32² / medium 32²..96² / large >96²): GTs
  outside the range are ignored, and unmatched detections outside the range
  are ignored rather than counted as false positives,
- maxDets tiers {1, 10, 100}: only the top-k scored detections per image
  enter matching,
- 101-point interpolated AP: precision is interpolated (running max from the
  right) and sampled on the recall grid 0:0.01:1, then averaged; mean over
  IoU thresholds 0.50:0.05:0.95 and over categories with at least one
  non-ignored GT.

Pure numpy, masks-based (instance segmentation — the framework's headline
task). Validated against a hand-enumerated golden fixture in
tests/test_eval.py.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_GRID = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def mask_iou_crowd(dt: np.ndarray, gt: np.ndarray,
                   gt_crowd: np.ndarray) -> np.ndarray:
    """(N,H,W) dt × (M,H,W) gt bool masks → (N,M) IoU; crowd GT columns use
    intersection / dt-area (pycocotools iscrowd semantics)."""
    n, m = len(dt), len(gt)
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float64)
    df = dt.reshape(n, -1).astype(np.float64)
    gf = gt.reshape(m, -1).astype(np.float64)
    inter = df @ gf.T
    d_area = df.sum(axis=1)
    g_area = gf.sum(axis=1)
    union = d_area[:, None] + g_area[None, :] - inter
    union = np.where(gt_crowd[None, :], d_area[:, None], union)
    return inter / np.maximum(union, 1.0)


def _match_image(
    iou: np.ndarray,  # (D, G) detections already score-sorted
    gt_ignore: np.ndarray,  # (G,) bool — crowd or out-of-area-range
    gt_crowd: np.ndarray,  # (G,) bool
    thresholds: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy pycocotools matching → (dt_match (T, D) gt index or -1,
    gt_matched (T, G) bool). GTs are visited non-ignored first."""
    d, g = iou.shape
    t_n = len(thresholds)
    order_g = np.argsort(gt_ignore, kind="stable")  # ignored last
    dtm = np.full((t_n, d), -1, np.int64)
    gtm = np.zeros((t_n, g), bool)
    for ti, t in enumerate(thresholds):
        for di in range(d):
            best_iou = min(t, 1.0 - 1e-10)
            best = -1
            for gi in order_g:
                if gtm[ti, gi] and not gt_crowd[gi]:
                    continue
                # already found a non-ignored match and the remaining
                # candidates are all ignored: stop (pycocotools break)
                if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if iou[di, gi] < best_iou:
                    continue
                best_iou = iou[di, gi]
                best = gi
            if best >= 0:
                dtm[ti, di] = best
                gtm[ti, best] = True
    return dtm, gtm


def evaluate_coco(
    pred_masks: list,  # per image (N, H, W) bool
    pred_labels: list,  # per image (N,) int
    pred_scores: list,  # per image (N,) float
    gt_masks: list,  # per image (M, H, W) bool
    gt_labels: list,  # per image (M,) int
    n_class: int,
    gt_crowd: list | None = None,  # per image (M,) bool; default no crowds
) -> dict:
    """Full COCO-API evaluation → the standard 12-number report plus the
    per-class AP vector (NaN for classes with no GT)."""
    n_img = len(pred_masks)
    if gt_crowd is None:
        gt_crowd = [np.zeros(len(g), bool) for g in gt_labels]

    # per-(image, class) match state for every (area-range, maxDet) combo is
    # derivable from one matching run at maxDet=100 per area range: smaller
    # maxDets just truncate the score-sorted detection list. pycocotools
    # evaluates per area range because gt_ignore changes; we do the same.
    results = {}
    per_class_ap_all = np.full(n_class, np.nan)

    # precompute per-image, per-class sorted detections and IoUs
    by_img_cls: dict[tuple[int, int], dict] = {}
    for i in range(n_img):
        pl = np.asarray(pred_labels[i])
        gl = np.asarray(gt_labels[i])
        for cls in set(pl.tolist()) | set(gl.tolist()):
            p_sel = np.where(pl == cls)[0]
            g_sel = np.where(gl == cls)[0]
            order = np.argsort(-np.asarray(pred_scores[i])[p_sel],
                               kind="stable")
            p_sel = p_sel[order]
            dt_m = np.asarray(pred_masks[i])[p_sel]
            gt_m = np.asarray(gt_masks[i])[g_sel]
            crowd = np.asarray(gt_crowd[i])[g_sel]
            def area_of(m, k):
                # an empty selection can arrive as shape (0,) (indexing an
                # empty per-image mask list), where reshape(0, -1) is invalid
                if k == 0:
                    return np.zeros(0, np.float64)
                return m.reshape(k, -1).sum(axis=1).astype(np.float64)

            by_img_cls[(i, int(cls))] = dict(
                scores=np.asarray(pred_scores[i])[p_sel],
                dt_area=area_of(dt_m, len(p_sel)),
                gt_area=area_of(gt_m, len(g_sel)),
                crowd=crowd,
                iou=mask_iou_crowd(dt_m, gt_m, crowd),
            )

    for rng_name, (a_lo, a_hi) in AREA_RANGES.items():
        # per class: gather match flags over all images at maxDet=100,
        # then derive the smaller maxDet tiers by truncation per image.
        ap_per_cls = {k: np.full(n_class, np.nan) for k in MAX_DETS}
        ar_per_cls = {k: np.full(n_class, np.nan) for k in MAX_DETS}
        for cls in range(n_class):
            # accumulate (score, tp/ignore flags per threshold) per maxDet
            acc = {k: {"scores": [], "matched": [], "ignored": []}
                   for k in MAX_DETS}
            n_pos = 0
            for i in range(n_img):
                e = by_img_cls.get((i, cls))
                if e is None:
                    continue
                g_ign = e["crowd"] | (e["gt_area"] < a_lo) | (
                    e["gt_area"] > a_hi)
                n_pos += int((~g_ign).sum())
                for k in MAX_DETS:
                    iou = e["iou"][:k]
                    scores = e["scores"][:k]
                    d_area = e["dt_area"][:k]
                    dtm, _ = _match_image(
                        iou, g_ign, e["crowd"], IOU_THRESHOLDS)
                    matched = dtm >= 0  # (T, D)
                    # ignore: matched to an ignored GT, or unmatched and
                    # detection area outside the range
                    m_ign = np.zeros_like(matched)
                    for ti in range(len(IOU_THRESHOLDS)):
                        for di in range(matched.shape[1]):
                            if matched[ti, di]:
                                m_ign[ti, di] = g_ign[dtm[ti, di]]
                            else:
                                m_ign[ti, di] = (
                                    d_area[di] < a_lo or d_area[di] > a_hi
                                )
                    acc[k]["scores"].append(scores)
                    acc[k]["matched"].append(matched)
                    acc[k]["ignored"].append(m_ign)
            if n_pos == 0:
                continue
            for k in MAX_DETS:
                if acc[k]["scores"]:
                    scores = np.concatenate(acc[k]["scores"])
                    matched = np.concatenate(acc[k]["matched"], axis=1)
                    ignored = np.concatenate(acc[k]["ignored"], axis=1)
                else:
                    scores = np.zeros(0)
                    matched = np.zeros((len(IOU_THRESHOLDS), 0), bool)
                    ignored = np.zeros((len(IOU_THRESHOLDS), 0), bool)
                order = np.argsort(-scores, kind="mergesort")
                matched = matched[:, order]
                ignored = ignored[:, order]
                ap_t = np.zeros(len(IOU_THRESHOLDS))
                rec_t = np.zeros(len(IOU_THRESHOLDS))
                for ti in range(len(IOU_THRESHOLDS)):
                    keep = ~ignored[ti]
                    tp = np.cumsum(matched[ti][keep])
                    fp = np.cumsum(~matched[ti][keep])
                    rec = tp / n_pos
                    prec = tp / np.maximum(tp + fp, 1e-12)
                    rec_t[ti] = rec[-1] if len(rec) else 0.0
                    # 101-point interpolation: running max from the right,
                    # sampled at the recall grid
                    for j in range(len(prec) - 1, 0, -1):
                        prec[j - 1] = max(prec[j - 1], prec[j])
                    idx = np.searchsorted(rec, RECALL_GRID, side="left")
                    p_at = np.where(idx < len(prec),
                                    prec[np.minimum(idx, max(len(prec) - 1, 0))],
                                    0.0) if len(prec) else np.zeros_like(
                                        RECALL_GRID)
                    ap_t[ti] = p_at.mean()
                ap_per_cls[k][cls] = ap_t.mean()
                ar_per_cls[k][cls] = rec_t.mean()
        results[rng_name] = {"ap": ap_per_cls, "ar": ar_per_cls}
        if rng_name == "all":
            per_class_ap_all = ap_per_cls[100]

    def _mean(v):
        return float(np.nanmean(v)) if np.isfinite(v).any() else 0.0

    # AP50/AP75 need per-threshold AP at range=all, maxDet=100: recompute
    # cheaply from stored per-class values is not possible post-mean, so
    # track them during the range="all" pass instead.
    ap50, ap75 = _ap_at_thresholds(
        by_img_cls, n_img, n_class, (0.5, 0.75))

    report = {
        "AP": _mean(results["all"]["ap"][100]),
        "AP50": ap50,
        "AP75": ap75,
        "APs": _mean(results["small"]["ap"][100]),
        "APm": _mean(results["medium"]["ap"][100]),
        "APl": _mean(results["large"]["ap"][100]),
        "AR1": _mean(results["all"]["ar"][1]),
        "AR10": _mean(results["all"]["ar"][10]),
        "AR100": _mean(results["all"]["ar"][100]),
        "ARs": _mean(results["small"]["ar"][100]),
        "ARm": _mean(results["medium"]["ar"][100]),
        "ARl": _mean(results["large"]["ar"][100]),
        "ap_per_class": per_class_ap_all,
    }
    return report


def _ap_at_thresholds(by_img_cls, n_img, n_class, thresholds) -> tuple:
    """Per-threshold AP at area=all, maxDet=100 (for AP50/AP75)."""
    out = []
    for t in thresholds:
        t_arr = np.asarray([t])
        ap = np.full(n_class, np.nan)
        for cls in range(n_class):
            scores_l, matched_l, ignored_l = [], [], []
            n_pos = 0
            for i in range(n_img):
                e = by_img_cls.get((i, cls))
                if e is None:
                    continue
                g_ign = e["crowd"].copy()
                n_pos += int((~g_ign).sum())
                iou = e["iou"][:100]
                dtm, _ = _match_image(iou, g_ign, e["crowd"], t_arr)
                matched = dtm[0] >= 0
                m_ign = np.zeros_like(matched)
                for di in range(len(matched)):
                    if matched[di]:
                        m_ign[di] = g_ign[dtm[0, di]]
                scores_l.append(e["scores"][:100])
                matched_l.append(matched)
                ignored_l.append(m_ign)
            if n_pos == 0:
                continue
            if scores_l:
                scores = np.concatenate(scores_l)
                matched = np.concatenate(matched_l)
                ignored = np.concatenate(ignored_l)
            else:
                scores = np.zeros(0)
                matched = np.zeros(0, bool)
                ignored = np.zeros(0, bool)
            order = np.argsort(-scores, kind="mergesort")
            matched, ignored = matched[order], ignored[order]
            keep = ~ignored
            tp = np.cumsum(matched[keep])
            fp = np.cumsum(~matched[keep])
            rec = tp / n_pos
            prec = tp / np.maximum(tp + fp, 1e-12)
            for j in range(len(prec) - 1, 0, -1):
                prec[j - 1] = max(prec[j - 1], prec[j])
            if len(prec):
                idx = np.searchsorted(rec, RECALL_GRID, side="left")
                p_at = np.where(idx < len(prec),
                                prec[np.minimum(idx, len(prec) - 1)], 0.0)
                ap[cls] = p_at.mean()
            else:
                ap[cls] = 0.0
        out.append(float(np.nanmean(ap)) if np.isfinite(ap).any() else 0.0)
    return tuple(out)
