"""A seeded depth-keypoint manifest for tests and smoke runs.

:func:`write_depth` writes ``n`` npz files in the format that
:class:`maskrcnn_tpu_torch.data.depth.DepthKeypointDataset` reads and a
``list.txt`` manifest naming them. Each frame's depth is uniform in
1000–4000 mm with a nearer figure: its 20 keypoints (x, y) scatter around a
centre, and some are NaN or out of frame, so that both of the loader's
visibility tests and its box clipping run. It tests the path; it is not a
recording of a depth camera.
"""

from __future__ import annotations

import os

import numpy as np


def write_depth(root: str, n: int, hw: tuple[int, int] = (48, 64),
                seed: int = 0) -> str:
    """Write ``n`` frames of size ``hw`` under ``root`` → the manifest's path."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    names = []
    for i in range(n):
        depth = rng.uniform(1000, 4000, (h, w)).astype(np.float32)
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        kp = np.stack([cx + rng.normal(0, w / 6, 20),
                       cy + rng.normal(0, h / 5, 20)], axis=1).astype(np.float32)
        # the figure stands nearer than the background around its joints
        ys = np.clip(kp[:, 1].astype(int), 0, h - 1)
        xs = np.clip(kp[:, 0].astype(int), 0, w - 1)
        depth[ys, xs] = rng.uniform(1200, 1800, 20)
        kp[rng.rand(20) < 0.1] = np.nan  # not recorded
        out = rng.rand(20) < 0.1  # out of frame, on one side or the other
        kp[out, 0] = np.where(rng.rand(int(out.sum())) < 0.5, -5.0, w + 5.0)
        name = f"frame_{i:04d}.npz"
        np.savez(os.path.join(root, name), depth=depth, keypoints=kp)
        names.append(name)
    manifest = os.path.join(root, "list.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(names) + "\n")
    return manifest
