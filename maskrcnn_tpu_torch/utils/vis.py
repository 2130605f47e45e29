"""Keypoint and detection drawing (copy of ``maskrcnn_tpu/utils/vis.py``).

The 20-keypoint depth-camera skeleton is Kinect-style (its names and flip
map in :mod:`maskrcnn_tpu_torch.data.keypoints`) with the reference
viewer's limb list; the 17-keypoint one is COCO's person skeleton.
:func:`vis_keypoints` draws limbs and joints above a score threshold and
blends them onto the image; :func:`vis_detections` draws boxes, labels
and scores and blends each mask in. numpy and cv2, imported inside the
functions that draw.
"""

from __future__ import annotations

import numpy as np

from maskrcnn_tpu_torch.data.keypoints import COCO_KEYPOINT_NAMES, DEPTH_KEYPOINT_NAMES

# COCO-17 skeleton (standard person-keypoints limb list).
_COCO_CONNECTIONS = [
    ("left_eye", "right_eye"), ("left_eye", "nose"), ("right_eye", "nose"),
    ("left_eye", "left_ear"), ("right_eye", "right_ear"),
    ("left_shoulder", "left_elbow"), ("left_elbow", "left_wrist"),
    ("right_shoulder", "right_elbow"), ("right_elbow", "right_wrist"),
    ("left_shoulder", "right_shoulder"),
    ("left_shoulder", "left_hip"), ("right_shoulder", "right_hip"),
    ("left_hip", "right_hip"),
    ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
    ("right_hip", "right_knee"), ("right_knee", "right_ankle"),
]

# Kinect-style 20-kp limb list — reference vis.py:40-57 verbatim pairs.
_DEPTH_CONNECTIONS = [
    ("ShoulderRight", "ElbowRight"), ("ElbowRight", "WristRight"),
    ("ShoulderLeft", "ElbowLeft"), ("ElbowLeft", "WristLeft"),
    ("HipRight", "KneeRight"), ("KneeRight", "AnkleRight"),
    ("HipLeft", "KneeLeft"), ("KneeLeft", "AnkleLeft"),
    ("ShoulderRight", "Neck"), ("Neck", "ShoulderLeft"),
    ("Neck", "Head"), ("Neck", "SpineBase"),
    ("SpineBase", "HipRight"), ("SpineBase", "HipLeft"),
]


def kp_connections(names: list[str]) -> list[tuple[int, int]]:
    pairs = _DEPTH_CONNECTIONS if "SpineBase" in names else _COCO_CONNECTIONS
    idx = {n: i for i, n in enumerate(names)}
    return [(idx[a], idx[b]) for a, b in pairs if a in idx and b in idx]


def _colormap(n: int) -> np.ndarray:
    """n distinct BGR colors along an HSV sweep (uint8)."""
    import cv2

    hsv = np.zeros((n, 1, 3), np.uint8)
    hsv[:, 0, 0] = np.linspace(0, 179, n, endpoint=False).astype(np.uint8)
    hsv[:, 0, 1] = 255
    hsv[:, 0, 2] = 255
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)[:, 0, :]


def vis_keypoints(
    img: np.ndarray,  # (H, W, 3) uint8 BGR — drawn in place on a copy
    keypoints: np.ndarray,  # (K, 3): (y, x, score)
    names: list[str] | None = None,
    thresh: float = 0.2,
    alpha: float = 0.7,
) -> np.ndarray:
    """Skeleton overlay (reference vis.py:60-116 behavior)."""
    import cv2

    names = names or (
        DEPTH_KEYPOINT_NAMES if len(keypoints) > 17 else COCO_KEYPOINT_NAMES
    )
    limbs = kp_connections(names)
    colors = _colormap(len(limbs) + len(keypoints))

    canvas = img.copy()
    for li, (a, b) in enumerate(limbs):
        if keypoints[a, 2] >= thresh and keypoints[b, 2] >= thresh:
            pa = (int(keypoints[a, 1]), int(keypoints[a, 0]))
            pb = (int(keypoints[b, 1]), int(keypoints[b, 0]))
            cv2.line(canvas, pa, pb, tuple(int(c) for c in colors[li]), 2)
    for ki in range(len(keypoints)):
        if keypoints[ki, 2] >= thresh:
            p = (int(keypoints[ki, 1]), int(keypoints[ki, 0]))
            cv2.circle(canvas, p, 3,
                       tuple(int(c) for c in colors[len(limbs) + ki]), -1)
    return cv2.addWeighted(img, 1.0 - alpha, canvas, alpha, 0)


def vis_detections(
    img: np.ndarray,  # (H, W, 3) uint8 BGR
    boxes: np.ndarray,  # (D, 4) yxyx
    labels: np.ndarray,
    scores: np.ndarray,
    masks: np.ndarray | None = None,  # (D, H, W) bool
    label_names: list[str] | None = None,
    thresh: float = 0.5,
    alpha: float = 0.4,
) -> np.ndarray:
    import cv2

    canvas = img.copy()
    colors = _colormap(max(int(labels.max()) + 1 if len(labels) else 1, 1))
    for i in range(len(boxes)):
        if scores[i] < thresh:
            continue
        color = tuple(int(c) for c in colors[int(labels[i]) % len(colors)])
        y0, x0, y1, x1 = boxes[i].astype(int)
        cv2.rectangle(canvas, (x0, y0), (x1, y1), color, 2)
        name = (label_names[int(labels[i])] if label_names else str(int(labels[i])))
        cv2.putText(canvas, f"{name} {scores[i]:.2f}", (x0, max(y0 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        if masks is not None:
            m = masks[i]
            overlay = canvas.copy()
            overlay[m] = color
            canvas = cv2.addWeighted(canvas, 1 - alpha, overlay, alpha, 0)
    return canvas
