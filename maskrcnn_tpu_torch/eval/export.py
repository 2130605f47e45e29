"""COCO results export (port of ``maskrcnn_tpu/eval/export.py``): ``segm``
and ``keypoints`` result files in the format ``pycocotools``' ``loadRes``
reads, so that detections can be scored offline against real annotations.

Detections are mapped back to the original image coordinates (predict runs
on the resized, padded bucket: boxes divide by the image's scale) and
labels back to the annotation file's sparse category ids. Masks are pasted
on the model's device (:func:`paste_masks`) at the original size and encoded
on the host with pycocotools' compressed column-major RLE; keypoints are
decoded on the host (:func:`decode_keypoints`).
"""

from __future__ import annotations

import json

import numpy as np

from maskrcnn_tpu_torch.eval.evaluator import predict_for_sizes
from maskrcnn_tpu_torch.eval.postprocess import decode_keypoints, paste_masks


def _encode_compressed_counts(counts) -> str:
    """pycocotools rleToString: 6-bit chunks, continuation bit, delta from
    counts[i-2] for i > 2, printable offset 48."""
    out = []
    counts = [int(c) for c in counts]
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5  # arithmetic shift: negatives stay negative
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def rle_encode(mask: np.ndarray) -> dict:
    """(H, W) bool/0-1 mask → COCO compressed RLE dict (column-major runs,
    first run counts zeros)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return {"size": [h, w], "counts": ""}
    change = np.flatnonzero(flat[1:] != flat[:-1])
    counts = np.diff(np.concatenate([[-1], change, [flat.size - 1]]))
    if flat[0] == 1:  # runs always start with a (possibly zero) 0-run
        counts = np.concatenate([[0], counts])
    return {"size": [int(h), int(w)],
            "counts": _encode_compressed_counts(counts)}


def _predict_index_order(cfg, model, loader, n_images, predict_cache):
    """Predict ``loader``'s images in index order (not the shuffled epoch
    order), a batch at a time, and yield ``(image index, batch slot, batch,
    detections)`` per real image. The last batch is padded by repeating its
    final index; padded slots are not yielded. ``predict_cache`` (image
    size → predict fn) can be the evaluator's."""
    if loader.flip:
        raise ValueError("export requires a flip=False loader "
                         "(deterministic, un-augmented examples)")
    bs = cfg.train.batch_size
    n = len(loader.ids) if n_images is None else min(n_images, len(loader.ids))
    predict_for = predict_for_sizes(cfg, model, predict_cache)
    for start in range(0, n, bs):
        idx = list(range(start, min(start + bs, n)))
        batch = loader.batch(idx + [idx[-1]] * (bs - len(idx)))
        predict = predict_for(tuple(batch.images.shape[1:3]))
        det = predict(batch.images, batch.img_hw, batch.scale)
        for k, i in enumerate(idx):
            yield i, k, batch, det


def _xywh(box) -> list[float]:
    y0, x0, y1, x1 = (float(v) for v in box)
    return [round(x0, 2), round(y0, 2), round(x1 - x0, 2), round(y1 - y0, 2)]


def export_coco_results(
    cfg,
    model,
    loader,  # COCODetectionLoader with flip=False
    out_path: str,
    n_images: int | None = None,
    score_thresh: float = 0.0,
    predict_cache: dict | None = None,
) -> int:
    """Predict ``loader``'s images in index order and write a COCO results
    JSON (segm format: image_id, category_id, segmentation, score, bbox) in
    original image coordinates. A label past the file's categories (a model
    with more classes than the file) has no category and is dropped.
    Returns the number of entries written."""
    results = []
    n_cats = len(loader.index.cat_ids)
    for i, k, batch, det in _predict_index_order(
            cfg, model, loader, n_images, predict_cache):
        if det.masks is None:
            raise ValueError("COCO segm export needs a mask head "
                             f"(head={cfg.model.head!r} yields no masks)")
        img_id = loader.ids[i]
        info = loader.index.images[img_id]
        h0, w0 = int(info["height"]), int(info["width"])
        valid = det.valid[k] & (det.scores[k] >= score_thresh)
        boxes0 = det.boxes[k] / float(batch.scale[k])  # original coordinates
        masks = paste_masks(boxes0, det.masks[k], valid, (h0, w0)).cpu().numpy()
        valid = valid.cpu().numpy()
        labels = det.labels[k].cpu().numpy()[valid]
        scores = det.scores[k].cpu().numpy()[valid]
        sel = boxes0.cpu().numpy()[valid]
        for d in range(len(scores)):
            if not 0 <= int(labels[d]) < n_cats:
                continue
            results.append({
                "image_id": int(img_id),
                "category_id": int(loader.index.cat_ids[int(labels[d])]),
                "segmentation": rle_encode(masks[d]),
                "bbox": _xywh(sel[d]),
                "score": round(float(scores[d]), 5),
            })
    with open(out_path, "w") as f:
        json.dump(results, f)
    return len(results)


def export_coco_keypoint_results(
    cfg,
    model,
    loader,  # COCODetectionLoader(keypoints=True) with flip=False
    out_path: str,
    n_images: int | None = None,
    score_thresh: float = 0.0,
    predict_cache: dict | None = None,
) -> int:
    """COCO person-keypoints results JSON: ``keypoints`` as the flat
    [x1, y1, v1, x2, y2, v2, ...] list in original image coordinates, each
    v the keypoint's heatmap probability (``loadRes`` scores by ``score``).
    Returns the number of entries written."""
    cat_id = loader.index.cat_ids[0] if loader.index.cat_ids else 1
    results = []
    for i, k, batch, det in _predict_index_order(
            cfg, model, loader, n_images, predict_cache):
        if det.heatmaps is None:
            raise ValueError("keypoint export needs a keypoint head "
                             f"(head={cfg.model.head!r} yields no heatmaps)")
        img_id = loader.ids[i]
        valid = det.valid[k] & (det.scores[k] >= score_thresh)
        sel = (det.boxes[k][valid] / float(batch.scale[k])).cpu().numpy()
        kps = decode_keypoints(sel, det.heatmaps[k][valid].cpu().numpy(),
                               np.ones(len(sel), bool))
        scores = det.scores[k][valid].cpu().numpy()
        for d in range(len(scores)):
            flat = []
            for y, x, v in kps[d]:
                flat += [round(float(x), 2), round(float(y), 2),
                         round(float(v), 4)]
            results.append({
                "image_id": int(img_id),
                "category_id": int(cat_id),
                "keypoints": flat,
                "bbox": _xywh(sel[d]),
                "score": round(float(scores[d]), 5),
            })
    with open(out_path, "w") as f:
        json.dump(results, f)
    return len(results)
