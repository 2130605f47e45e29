"""Dataset evaluators (port of ``maskrcnn_tpu/eval/evaluator.py``): VOC mask
mAP@0.5 with per-class ``ap/<name>`` and COCO mask AP with pycocotools
semantics over a stream of batches that carry GT masks, and OKS keypoint AP
over batches that carry GT keypoints.

Prediction and mask pasting run on the model's device; only the boolean
masks, labels and scores go to the host, for the numpy scorers
(:mod:`.detection_eval`, :mod:`.coco_eval`, copies of the JAX package's).
The keypoint evaluator moves each valid detection's box, score and heatmaps
to the host and decodes and scores them there (:mod:`.keypoint_eval`, a
copy).
"""

from __future__ import annotations

import numpy as np
import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.eval.coco_eval import evaluate_coco
from maskrcnn_tpu_torch.eval.detection_eval import eval_instance_segmentation_voc
from maskrcnn_tpu_torch.eval.keypoint_eval import eval_keypoints_oks_ap
from maskrcnn_tpu_torch.eval.postprocess import decode_keypoints, paste_masks
from maskrcnn_tpu_torch.eval.predict import make_predict_fn


def predict_for_sizes(cfg: Config, model, predict_cache: dict | None):
    """image size → predict function, one per bucket, kept in
    ``predict_cache`` across calls (the evaluators' and the exports').

    On the card each function keeps one CUDA graph per batch size and
    image dtype, each in a memory pool of its own: a bucket's first batch
    runs eagerly, its second captures, the rest replay, also across
    evaluations (the graphs read the parameters where the optimizer
    updates them). A shorter last batch is a signature of its own, so
    within one evaluation it runs eagerly as that signature's first
    request and captures only if it comes again."""
    cache = {} if predict_cache is None else predict_cache

    def predict_for(hw):
        if hw not in cache:
            cache[hw] = make_predict_fn(cfg, model, image_size=hw)
        return cache[hw]

    return predict_for


def crop_to_full_mask(gt_masks_crops, gt_boxes, gt_valid, img_hw):
    """(G_valid, H, W) bool: each valid GT's box-crop mask resized to its box
    and thresholded at 0.5, on the crops' device. uint8 crops encode [0, 1]
    as 0..255."""
    crops = torch.as_tensor(gt_masks_crops)
    if crops.dtype == torch.uint8:
        crops = crops.float() / 255.0
    return paste_masks(gt_boxes, crops, gt_valid, img_hw, threshold=0.5)


def evaluate_dataset(
    cfg: Config,
    model,
    batches,  # iterable of Batch with gt_masks present
    n_batches: int,
    label_names: list[str] | None = None,
    predict_cache: dict | None = None,
) -> dict:
    """Runs the two-pass predict over ``n_batches`` and computes mask mAP.

    ``predict_cache`` (image size → predict fn) keeps one predict per
    bucket across calls. Returns ``map`` (VOC), ``coco/*`` and
    ``ap/<name>`` for each class with GT.
    """
    predict_for = predict_for_sizes(cfg, model, predict_cache)
    pred_masks, pred_labels, pred_scores = [], [], []
    gt_masks_all, gt_labels_all = [], []

    for _, batch in zip(range(n_batches), batches):
        predict = predict_for(tuple(batch.images.shape[1:3]))
        det = predict(batch.images, batch.img_hw, batch.scale)
        dev = det.boxes.device  # the model's
        valid_all = det.valid.cpu().numpy()
        labels_all = det.labels.cpu().numpy()
        scores_all = det.scores.cpu().numpy()
        gt_valid = np.asarray(batch.gt_valid)
        for i in range(batch.images.shape[0]):
            hw = (int(batch.img_hw[i][0]), int(batch.img_hw[i][1]))
            valid = valid_all[i]
            pred_masks.append(paste_masks(
                det.boxes[i], det.masks[i], det.valid[i], hw).cpu().numpy())
            pred_labels.append(labels_all[i][valid])
            pred_scores.append(scores_all[i][valid])
            gt_masks_all.append(crop_to_full_mask(
                torch.as_tensor(batch.gt_masks[i], device=dev),
                torch.as_tensor(batch.gt_boxes[i], device=dev),
                torch.as_tensor(gt_valid[i], device=dev), hw).cpu().numpy())
            gt_labels_all.append(np.asarray(batch.gt_labels[i])[gt_valid[i]])

    n_class = cfg.model.n_fg_class
    voc = eval_instance_segmentation_voc(
        pred_masks, pred_labels, pred_scores, gt_masks_all, gt_labels_all,
        n_class,
    )
    # crowd regions never reach a Batch, so gt_crowd stays empty
    coco = evaluate_coco(
        pred_masks, pred_labels, pred_scores, gt_masks_all, gt_labels_all,
        n_class,
    )
    report = {"map": voc["map"], "coco/map": coco["AP"],
              "coco/map50": coco["AP50"], "coco/map75": coco["AP75"],
              "coco/map_small": coco["APs"], "coco/map_medium": coco["APm"],
              "coco/map_large": coco["APl"], "coco/ar1": coco["AR1"],
              "coco/ar10": coco["AR10"], "coco/ar100": coco["AR100"]}
    names = label_names or [str(i) for i in range(n_class)]
    for i, name in enumerate(names):
        if np.isfinite(voc["ap"][i]):
            report[f"ap/{name}"] = float(voc["ap"][i])
    return report


def evaluate_keypoint_dataset(
    cfg: Config,
    model,
    batches,  # iterable of Batch with gt_keypoints present
    n_batches: int,
    predict_cache: dict | None = None,
) -> dict:
    """OKS keypoint AP (``ap``, ``ap50``, ``ap75``) of the two-pass predict
    over ``n_batches``; a ground truth's area is its box's."""
    predict_for = predict_for_sizes(cfg, model, predict_cache)
    pred_kps, pred_scores = [], []
    gt_kps, gt_areas = [], []
    for _, batch in zip(range(n_batches), batches):
        predict = predict_for(tuple(batch.images.shape[1:3]))
        det = predict(batch.images, batch.img_hw, batch.scale)
        for i in range(batch.images.shape[0]):
            valid = det.valid[i]
            boxes = det.boxes[i][valid].cpu().numpy()
            heat = det.heatmaps[i][valid].cpu().numpy()
            pred_kps.append(decode_keypoints(
                boxes, heat, np.ones(len(boxes), bool)))
            pred_scores.append(det.scores[i][valid].cpu().numpy())
            gv = np.asarray(batch.gt_valid[i])
            gt_kps.append(np.asarray(batch.gt_keypoints[i])[gv])
            gboxes = np.asarray(batch.gt_boxes[i])[gv]
            gt_areas.append(
                (gboxes[:, 2] - gboxes[:, 0]) * (gboxes[:, 3] - gboxes[:, 1]))
    return eval_keypoints_oks_ap(pred_kps, pred_scores, gt_kps, gt_areas)
