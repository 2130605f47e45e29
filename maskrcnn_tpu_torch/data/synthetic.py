"""Synthetic predict requests (port of the image part of
``maskrcnn_tpu/data/synthetic.py``).

``SyntheticRequests(cfg, seed).batch(i)`` draws the same numpy random
stream as the JAX package's ``SyntheticDetectionData.batch(i)`` and returns
its images (uint8), ``img_hw`` and ``scale``: a dark noise canvas with
1–6 class-coloured rectangles or ellipses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from maskrcnn_tpu_torch.config import Config


class Request(NamedTuple):
    images: np.ndarray  # (B, H, W, 3) uint8
    img_hw: np.ndarray  # (B, 2) float32 true content size
    scale: np.ndarray  # (B,) float32 resize scale


class SyntheticRequests:
    def __init__(self, cfg: Config, seed: int = 0):
        self.cfg = cfg
        self.seed = seed

    def _image(self, rng: np.random.RandomState) -> np.ndarray:
        cfg = self.cfg
        h, w = cfg.train.image_size
        img = rng.uniform(0.0, 0.15, (h, w, 3)).astype(np.float32)
        for _ in range(rng.randint(1, min(6, cfg.train.max_gt) + 1)):
            bh = rng.uniform(h * 0.15, h * 0.5)
            bw = rng.uniform(w * 0.15, w * 0.5)
            y0 = rng.uniform(0, h - bh)
            x0 = rng.uniform(0, w - bw)
            y1, x1 = y0 + bh, x0 + bw
            cls = rng.randint(0, cfg.model.n_fg_class)
            base = np.array([
                ((cls * 2654435761) % 255) / 255.0,
                ((cls * 40503 + 89) % 255) / 255.0,
                ((cls * 9176 + 191) % 255) / 255.0,
            ], np.float32)
            color = np.clip(
                0.35 + 0.6 * base + rng.uniform(-0.05, 0.05, 3), 0.0, 1.0
            ).astype(np.float32)
            ellipse = rng.randint(0, 2) == 1
            iy0, iy1 = int(np.floor(y0)), min(int(np.ceil(y1)), h)
            ix0, ix1 = int(np.floor(x0)), min(int(np.ceil(x1)), w)
            yy, xx = np.mgrid[iy0:iy1, ix0:ix1].astype(np.float32)
            if ellipse:
                cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
                inside = ((yy - cy) / (bh / 2)) ** 2 + ((xx - cx) / (bw / 2)) ** 2 <= 1.0
            else:
                inside = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
            img[iy0:iy1, ix0:ix1][inside] = color
        return img

    def batch(self, index: int) -> Request:
        b = self.cfg.train.batch_size
        h, w = self.cfg.train.image_size
        rng = np.random.RandomState(self.seed * 100_003 + index)
        ims = [self._image(rng) for _ in range(b)]
        return Request(
            images=(np.stack(ims) * 255.0 + 0.5).astype(np.uint8),
            img_hw=np.full((b, 2), (h, w), np.float32),
            scale=np.ones((b,), np.float32),
        )
