"""Seed-made traffic data: COCO-shaped synthetic images with their boxes,
labels and instance masks or keypoints, and the chosen loads that make
random weights fill the detection slots.

A frozen copy of the port's synthetic generator: a dark noise canvas with
1–6 class-coloured rectangles or ellipses, their exact boxes, labels, mask
crops at ``gt_mask_size`` and, for a keypoint head, ``n_keypoints``
visible keypoints on the box's anti-diagonal. ``Synthetic(cfg,
seed).batch(i)`` is a pure function of ``(seed, i)``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import NamedTuple

import numpy as np


class Batch(NamedTuple):
    """One fixed-shape batch of numpy arrays, with the fields (and their
    order) of the program's train batch."""

    images: np.ndarray  # (B, H, W, 3) uint8
    img_hw: np.ndarray  # (B, 2) float32 true content size
    scale: np.ndarray  # (B,) float32 resize scale
    gt_boxes: np.ndarray  # (B, G, 4) yxyx
    gt_labels: np.ndarray  # (B, G) int32 0-based foreground class
    gt_valid: np.ndarray  # (B, G) bool
    gt_masks: np.ndarray | None = None  # (B, G, S, S) uint8 box crops
    gt_keypoints: np.ndarray | None = None  # (B, G, K, 3) (y, x, v)


def stack(batches: list) -> Batch:
    """K batches → one whose every field has a leading (K, ...) axis."""
    return Batch(*(None if x[0] is None else np.stack(x) for x in zip(*batches)))


class Synthetic:
    def __init__(self, cfg, seed: int):
        self.cfg = cfg
        self.seed = seed
        self.is_keypoint = cfg.model.head == "fpn_keypoint"

    def _example(self, rng: np.random.RandomState):
        cfg = self.cfg
        h, w = cfg.train.image_size
        g, s = cfg.train.max_gt, cfg.train.gt_mask_size
        img = rng.uniform(0.0, 0.15, (h, w, 3)).astype(np.float32)
        boxes = np.zeros((g, 4), np.float32)
        labels = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        masks = np.zeros((g, s, s), np.float32)
        k = cfg.model.n_keypoints
        kps = np.zeros((g, k, 3), np.float32)
        for i in range(rng.randint(1, min(6, g) + 1)):
            bh = rng.uniform(h * 0.15, h * 0.5)
            bw = rng.uniform(w * 0.15, w * 0.5)
            y0 = rng.uniform(0, h - bh)
            x0 = rng.uniform(0, w - bw)
            y1, x1 = y0 + bh, x0 + bw
            cls = rng.randint(0, cfg.model.n_fg_class)
            # the class fixes the colour (a learnable classification)
            base = np.array([
                ((cls * 2654435761) % 255) / 255.0,
                ((cls * 40503 + 89) % 255) / 255.0,
                ((cls * 9176 + 191) % 255) / 255.0,
            ], np.float32)
            color = np.clip(
                0.35 + 0.6 * base + rng.uniform(-0.05, 0.05, 3), 0.0, 1.0
            ).astype(np.float32)
            ellipse = rng.randint(0, 2) == 1
            cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
            iy0, iy1 = int(np.floor(y0)), min(int(np.ceil(y1)), h)
            ix0, ix1 = int(np.floor(x0)), min(int(np.ceil(x1)), w)
            yy, xx = np.mgrid[iy0:iy1, ix0:ix1].astype(np.float32)
            if ellipse:
                inside = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1.0
            else:
                inside = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
            img[iy0:iy1, ix0:ix1][inside] = color

            boxes[i] = [y0, x0, y1, x1]
            labels[i] = cls
            valid[i] = True
            # the mask crop: the shape rasterized inside its box at s×s
            if ellipse:
                gy, gx = np.meshgrid(y0 + (np.arange(s) + 0.5) / s * bh,
                                     x0 + (np.arange(s) + 0.5) / s * bw,
                                     indexing="ij")
                masks[i] = (
                    ((gy - cy) / (bh / 2)) ** 2 + ((gx - cx) / (bw / 2)) ** 2 <= 1.0
                ).astype(np.float32)
            else:
                masks[i] = 1.0
            # keypoints: a lattice along the box's anti-diagonal, all visible
            t = (np.arange(k) + 0.5) / k
            kps[i, :, 0] = y0 + t * bh
            kps[i, :, 1] = x0 + (1.0 - t) * bw
            kps[i, :, 2] = 2.0
        return img, boxes, labels, valid, masks, kps

    def batch(self, index: int) -> Batch:
        b = self.cfg.train.batch_size
        h, w = self.cfg.train.image_size
        rng = np.random.RandomState((self.seed * 100_003 + index) % 2**32)
        ims, boxes, labels, valid, masks, kps = (
            np.stack(x) for x in zip(*(self._example(rng) for _ in range(b))))
        return Batch(
            images=(ims * 255.0 + 0.5).astype(np.uint8),
            img_hw=np.full((b, 2), (h, w), np.float32),
            scale=np.ones((b,), np.float32),
            gt_boxes=boxes, gt_labels=labels, gt_valid=valid,
            gt_masks=(None if self.is_keypoint
                      else (masks * 255.0 + 0.5).astype(np.uint8)),
            gt_keypoints=kps if self.is_keypoint else None,
        )


def class_score_names(weights: dict) -> tuple[str, str]:
    """The class-score layer's (weight, bias) names: the one parameter
    under ``head.`` whose name ends in ``score.weight`` (the FPN heads'
    ``head.box.score.weight``, the C4 heads' ``head.score.weight``) and its
    ``score.bias``. Raises unless there is exactly one."""
    found = [name for name in weights
             if name.startswith("head.") and name.endswith("score.weight")]
    if len(found) != 1:
        raise KeyError(f"want one class-score layer under head., found {found}")
    return found[0], found[0][:-len("weight")] + "bias"


def spread_class_scores(weights: dict, scale: float = 8.0) -> dict:
    """The class-score layer's weights scaled by ``scale`` in place. At
    random init the class logits spread by about 0.25, so every class scores
    near 1/81, under the 0.05 threshold; scaled by 8 enough (ROI, class)
    pairs pass to fill every one of the ``max_detections`` slots. A chosen
    load, not a property of trained weights."""
    weights[class_score_names(weights)[0]].mul_(scale)
    return weights


def visualize_load(weights: dict) -> dict:
    """The class-score layer's weights scaled by 32 and every foreground
    class's bias raised by 2: a chosen load under the ``visualize`` preset's
    0.7 threshold, which a spread of 8 does not clear."""
    spread_class_scores(weights, 32.0)
    weights[class_score_names(weights)[1]][1:] += 2.0
    return weights


def visualize_fill(weights: dict) -> dict:
    """:func:`visualize_load` with the foreground bias raised by 4: random
    weights from most seeds then put several of the keypoint model's ten
    proposals over the 0.7 threshold in every request, where the +2 of
    :func:`visualize_load` leaves many requests with none."""
    visualize_load(weights)
    weights[class_score_names(weights)[1]][1:] += 2.0
    return weights


LOADS = {"spread_class_scores": spread_class_scores,
         "visualize_load": visualize_load, "visualize_fill": visualize_fill}
LOADS_DIR = Path(__file__).resolve().parent / "loads"


def chosen_load(name: str):
    """The chosen load ``name``: one of :data:`LOADS`, or the ``apply`` of
    ``benchmark/loads/<name>.py``, which a configuration that needs a load
    of its own brings as a file."""
    if name in LOADS:
        return LOADS[name]
    path = LOADS_DIR / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no chosen load {name!r} in LOADS and no file {path}")
    module_spec = importlib.util.spec_from_file_location(f"benchmark_load_{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.apply
