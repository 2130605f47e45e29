"""Keypoint skeleton metadata + horizontal-flip permutations.

Specs:
- the 20-keypoint depth-camera skeleton is Kinect-style (reference
  vis.py:7-28: SpineBase, SpineMid, Neck, Head, Shoulder/Elbow/Wrist/Hand
  L+R, Hip/Knee/Ankle/Foot L+R) with a left/right ``keypoint_flip_map``
  (vis.py:29-36),
- the 17-keypoint model is standard COCO person keypoints
  (reference COCOKeypointsLoader, coco_dataset.py:100-161).

The flip permutation is what horizontal-flip augmentation must apply to
keypoint *rows* in addition to mirroring x coordinates — mirroring alone
relabels every left joint as a right joint. (The reference never flips
during training, so it never hit this; its flip map also omits the
Ankle/Hand pairs — we derive ALL left/right pairs from the names.)
"""

from __future__ import annotations

import numpy as np

COCO_KEYPOINT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

# Kinect-style, reference vis.py:7-28 — exact names and order.
DEPTH_KEYPOINT_NAMES = [
    "SpineBase", "SpineMid", "Neck", "Head",
    "ShoulderLeft", "ElbowLeft", "WristLeft", "HandLeft",
    "ShoulderRight", "ElbowRight", "WristRight", "HandRight",
    "HipLeft", "KneeLeft", "AnkleLeft", "FootLeft",
    "HipRight", "KneeRight", "AnkleRight", "FootRight",
]


def _partner(name: str) -> str | None:
    for a, b in (("left", "right"), ("Left", "Right")):
        if a in name:
            return name.replace(a, b)
        if b in name:
            return name.replace(b, a)
    return None


def flip_permutation(names: list[str]) -> np.ndarray:
    """perm such that ``kp_flipped = kp[perm]`` swaps left/right joints."""
    perm = np.arange(len(names))
    index = {n: i for i, n in enumerate(names)}
    for i, n in enumerate(names):
        p = _partner(n)
        if p is not None:
            if p not in index:
                raise ValueError(f"no flip partner for keypoint {n!r}")
            perm[i] = index[p]
    return perm


def keypoint_names(n_keypoints: int) -> list[str]:
    if n_keypoints == 17:
        return COCO_KEYPOINT_NAMES
    if n_keypoints == 20:
        return DEPTH_KEYPOINT_NAMES
    # unknown skeleton: identity flip (caller may disable flip augmentation)
    return [f"kp_{i}" for i in range(n_keypoints)]


def keypoint_flip_map(names: list[str]) -> dict[str, str]:
    """Name-level flip map (reference vis.py:29-36 shape, but complete)."""
    out = {}
    for n in names:
        p = _partner(n)
        if p is not None and ("left" in n or "Left" in n):
            out[n] = p
    return out
