"""Synthetic detection data (port of ``maskrcnn_tpu/data/synthetic.py``):
deterministic COCO-shaped batches.

A dark noise canvas with 1–6 class-coloured rectangles or ellipses, with
their exact boxes, labels and instance masks stored as fixed-size box crops,
or, for the keypoint head, ``cfg.model.n_keypoints`` visible keypoints on a
diagonal lattice inside each box.
``SyntheticDetectionData(cfg, seed).batch(i)`` draws the same numpy random
stream as the JAX package's class of that name and returns the same arrays
bit for bit, as a :class:`maskrcnn_tpu_torch.train.step.Batch` (images and
mask crops uint8; ``gt_masks`` for the mask head, ``gt_keypoints`` for the
keypoint head). ``SyntheticRequests(cfg, seed).batch(i)`` is its image
part: ``images``, ``img_hw`` and ``scale`` of the same batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.train.step import Batch


class Request(NamedTuple):
    images: np.ndarray  # (B, H, W, 3) uint8
    img_hw: np.ndarray  # (B, 2) float32 true content size
    scale: np.ndarray  # (B,) float32 resize scale


class SyntheticDetectionData:
    """Deterministic stream of fixed-shape train batches: ``batch(i)`` is a
    pure function of ``(seed, i)``; iterating yields ``batch(0)``,
    ``batch(1)``, ..."""

    def __init__(self, cfg: Config, seed: int = 0):
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
        rng = np.random.RandomState(self.seed * 100_003 + index)
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

    def iter_from(self, step: int = 0):
        """Step-pure stream from ``batch(step)`` on: a run resumed at step k
        sees exactly the batches an uninterrupted run would."""
        i = step
        while True:
            yield self.batch(i)
            i += 1

    def __iter__(self):
        return self.iter_from(0)


class SyntheticRequests(SyntheticDetectionData):
    def batch(self, index: int) -> Request:
        return Request(*super().batch(index)[:3])
