"""Depth-camera keypoint dataset and its augmentation (port of
``maskrcnn_tpu/data/depth.py``).

A txt manifest lists npz files, one a line, relative to the manifest's
directory; each holds ``depth`` (H, W) in millimetres and ``keypoints``
(K, 2) as (x, y). The image is the depth normalised as (d − 1000) / 3000,
clipped to [0, 1] and stacked to 3 channels; with augmentation it gets a
uniform brightness jitter of ±15/255 and, with ``flip``, a horizontal
flip in half the examples, which swaps left and right joint rows (the
Kinect skeleton's :func:`flip_permutation`) and mirrors x as ``w0 − x``.
A keypoint is visible (v = 2) when it is finite and inside the frame;
the one ground-truth box is the visible keypoints' extent ±10 px, clipped
to the frame (the whole frame when none is visible). The image is resized
with ``cv2.resize`` into the top-left of ``cfg.train.image_size``.

numpy and cv2 on the host, cv2 imported inside the functions that use it;
batches are the port's :class:`Batch` of numpy arrays (images float32).
The stream is a pure function of the step (:meth:`iter_from`), and an
example's draws depend on (seed, epoch, dataset index) only.
"""

from __future__ import annotations

import os

import numpy as np

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.data.keypoints import DEPTH_KEYPOINT_NAMES, flip_permutation
from maskrcnn_tpu_torch.train.step import Batch


class DepthKeypointDataset:
    n_keypoints = 20

    def __init__(self, cfg: Config, manifest: str, augment: bool = True,
                 flip: bool = True, seed: int = 0):
        self.cfg = cfg
        root = os.path.dirname(os.path.abspath(manifest))
        with open(manifest) as f:
            self.files = [os.path.join(root, line.strip())
                          for line in f if line.strip()]
        self.augment = augment
        self.flip = flip
        self.kp_flip_perm = flip_permutation(DEPTH_KEYPOINT_NAMES)
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self._order_cache = None

    def __len__(self):
        return len(self.files)

    def get_example(self, i: int, rng: np.random.RandomState | None = None):
        import cv2

        if rng is None:
            rng = self.rng
        cfg = self.cfg
        data = np.load(self.files[i])
        depth = data["depth"].astype(np.float32)
        kp_xy = data["keypoints"].astype(np.float32)  # (K, 2) as (x, y)

        img = np.clip((depth - 1000.0) / 3000.0, 0.0, 1.0)
        if self.augment:
            img = np.clip(img + rng.uniform(-15, 15) / 255.0, 0.0, 1.0)

        h0, w0 = depth.shape
        do_flip = self.augment and self.flip and rng.rand() < 0.5
        if do_flip:
            img = img[:, ::-1]
            if len(kp_xy) == len(self.kp_flip_perm):
                kp_xy = kp_xy[self.kp_flip_perm]
            kp_xy = np.stack([w0 - kp_xy[:, 0], kp_xy[:, 1]], axis=1)
        img = np.stack([img, img, img], axis=-1)
        vis = (np.isfinite(kp_xy).all(axis=1)
               & (kp_xy[:, 0] >= 0) & (kp_xy[:, 0] < w0)
               & (kp_xy[:, 1] >= 0) & (kp_xy[:, 1] < h0))
        kps = np.zeros((self.n_keypoints, 3), np.float32)
        k = min(len(kp_xy), self.n_keypoints)
        kps[:k, 0] = kp_xy[:k, 1]  # y
        kps[:k, 1] = kp_xy[:k, 0]  # x
        kps[:k, 2] = np.where(vis[:k], 2.0, 0.0)

        vy = kps[kps[:, 2] == 2, 0]
        vx = kps[kps[:, 2] == 2, 1]
        if len(vy):
            box = np.array([max(vy.min() - 10, 0), max(vx.min() - 10, 0),
                            min(vy.max() + 10, h0), min(vx.max() + 10, w0)],
                           np.float32)
        else:
            box = np.array([0, 0, h0, w0], np.float32)

        bh, bw = cfg.train.image_size
        scale = min(bh / h0, bw / w0)
        nh, nw = int(h0 * scale), int(w0 * scale)
        canvas = np.zeros((bh, bw, 3), np.float32)
        canvas[:nh, :nw] = cv2.resize(img, (nw, nh))
        box *= scale
        kps[:, :2] *= scale

        g = cfg.train.max_gt
        boxes = np.zeros((g, 4), np.float32)
        labels = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        all_kps = np.zeros((g, self.n_keypoints, 3), np.float32)
        boxes[0] = box
        valid[0] = True
        all_kps[0] = kps
        return dict(image=canvas, img_hw=np.array([nh, nw], np.float32),
                    scale=np.float32(scale), gt_boxes=boxes, gt_labels=labels,
                    gt_valid=valid, gt_keypoints=all_kps)

    def batch(self, indices, rngs=None) -> Batch:
        if rngs is None:
            rngs = [None] * len(indices)
        ex = [self.get_example(i % len(self), rng)
              for i, rng in zip(indices, rngs)]

        def stack(k):
            return np.stack([e[k] for e in ex])

        return Batch(images=stack("image"), img_hw=stack("img_hw"),
                     scale=np.array([e["scale"] for e in ex], np.float32),
                     gt_boxes=stack("gt_boxes"), gt_labels=stack("gt_labels"),
                     gt_valid=stack("gt_valid"), gt_masks=None,
                     gt_keypoints=stack("gt_keypoints"))

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        order = np.arange(len(self))
        np.random.RandomState(
            (self.seed * 100_003 + epoch) % (2**31 - 1)).shuffle(order)
        self._order_cache = (epoch, order)
        return order

    def iter_from(self, step: int = 0):
        """Batches from ``step`` on: each epoch a seeded permutation, each
        example's augmentation drawn from (seed, epoch, dataset index), so
        the draws do not depend on the batch size."""
        b = self.cfg.train.batch_size
        per_epoch = max(1, len(self) // b)
        while True:
            epoch, j = divmod(step, per_epoch)
            order = self._epoch_order(epoch)
            idxs = order.take(np.arange(j * b, (j + 1) * b), mode="wrap")
            rngs = [np.random.RandomState(
                (self.seed * 100_003 + epoch * 131_071 + int(i)) % (2**31 - 1))
                for i in idxs]
            yield self.batch(idxs, rngs)
            step += 1

    def __iter__(self):
        return self.iter_from(0)
