"""Mask pasting and keypoint decoding (port of
``maskrcnn_tpu/eval/postprocess.py``).

Each detection's S×S mask probabilities are resized to its integer box
extent and thresholded into a full-resolution boolean canvas. The JAX
package resizes one detection at a time with ``cv2.resize(...,
INTER_LINEAR)``; here every detection of an image is resized at once, on
the device its tensors live on, with cv2's arithmetic written out, so no
cv2 is needed. For a source of ``n`` pixels resized to ``m``, output pixel
``i`` samples ``f = (i + 0.5)·(1 / (m / n)) − 0.5`` (the scale in float64,
``f`` rounded to float32, as cv2 computes it), ``s = floor(f)``,
``a = f − s``; ``s < 0`` reads ``(s, a) = (0, 0)`` and ``s ≥ n − 1``
reads ``(n − 1, 0)``. The value is ``src[s]·(1 − a) + src[s + 1]·a``,
along the columns first and then the rows, as cv2 does.

Only elementwise float32 arithmetic and gathers: a CPU and a CUDA tensor
give the same bits. Against cv2 a pixel may differ where the interpolated
value lies within a rounding of the threshold (``tests/test_torch_eval.py``
counts them). ``decode_keypoints`` is the JAX package's numpy function,
copied: the argmax bin of each heatmap, mapped into the box.
"""

from __future__ import annotations

import numpy as np
import torch


def _taps(lo, ext, size: int, n: int):
    """Per detection, for each of ``size`` canvas pixels along one axis:
    the two source indices, the second's weight, and whether the pixel lies
    inside the box ``[lo, lo + ext)``. ``lo``/``ext`` (D,) int64."""
    pos = torch.arange(size, device=lo.device)
    i = pos[None, :] - lo[:, None]  # (D, size) index inside the box
    inside = (i >= 0) & (i < ext[:, None])
    scale = 1.0 / (ext.double() / n)  # cv2: 1 / (dsize / ssize), in double
    f = ((i.double() + 0.5) * scale[:, None] - 0.5).float()
    s = torch.floor(f)
    a = f - s
    s = s.long()
    a = torch.where((s < 0) | (s >= n - 1), torch.zeros_like(a), a)
    s = s.clamp(0, n - 1)
    return s, (s + 1).clamp(max=n - 1), a, inside


def paste_masks(det_boxes, mask_probs, valid, img_hw, threshold: float = 0.5):
    """(D_valid, H, W) bool masks pasted at full resolution.

    det_boxes (D, 4) yxyx; mask_probs (D, S, S) probabilities; valid (D,)
    bool; img_hw the canvas (H, W). Tensors (or arrays, taken to the CPU);
    the result lies on their device. A box spans ``floor(y0), floor(x0)``
    to ``ceil(y1), ceil(x1)`` clipped to the canvas; one without extent
    pastes an empty canvas.
    """
    probs = torch.as_tensor(mask_probs)
    dev = probs.device
    keep = torch.as_tensor(valid, device=dev).nonzero().squeeze(1)
    boxes = torch.as_tensor(det_boxes, device=dev)[keep].float()
    probs = probs[keep].float()
    h, w = int(img_hw[0]), int(img_hw[1])
    d, n = probs.shape[0], probs.shape[-1]
    if d == 0:
        return torch.zeros((0, h, w), dtype=torch.bool, device=dev)
    y0 = torch.floor(boxes[:, 0]).long().clamp(min=0)
    x0 = torch.floor(boxes[:, 1]).long().clamp(min=0)
    y1 = torch.ceil(boxes[:, 2]).long().clamp(max=h)
    x1 = torch.ceil(boxes[:, 3]).long().clamp(max=w)
    ext_y, ext_x = y1 - y0, x1 - x0
    empty = (ext_y <= 0) | (ext_x <= 0)
    ext_y = torch.where(empty, torch.ones_like(ext_y), ext_y)
    ext_x = torch.where(empty, torch.ones_like(ext_x), ext_x)
    sy0, sy1, ay, in_y = _taps(y0, ext_y, h, n)
    sx0, sx1, ax, in_x = _taps(x0, ext_x, w, n)
    # columns: (D, S, S) → (D, S, W)
    cols = (probs.gather(2, sx0[:, None, :].expand(d, n, w)) * (1 - ax[:, None, :])
            + probs.gather(2, sx1[:, None, :].expand(d, n, w)) * ax[:, None, :])
    # rows: (D, S, W) → (D, H, W)
    full = (cols.gather(1, sy0[:, :, None].expand(d, h, w)) * (1 - ay[:, :, None])
            + cols.gather(1, sy1[:, :, None].expand(d, h, w)) * ay[:, :, None])
    inside = in_y[:, :, None] & in_x[:, None, :] & ~empty[:, None, None]
    return (full >= threshold) & inside


def decode_keypoints(
    det_boxes: np.ndarray,  # (D, 4) yxyx in the coordinates wanted out
    heatmaps: np.ndarray,  # (D, S, S, K) logits
    valid: np.ndarray,  # (D,) bool
) -> np.ndarray:
    """(D_valid, K, 3) — (y, x, score) per keypoint: the argmax bin of each
    S×S heatmap, its centre mapped into the box; the score is the softmax
    probability of that bin."""
    d, s, _, k = heatmaps.shape
    out = []
    for i in np.where(valid)[0]:
        y0, x0, y1, x1 = det_boxes[i]
        bh = max(y1 - y0, 1e-3)
        bw = max(x1 - x0, 1e-3)
        flat = heatmaps[i].reshape(s * s, k)
        e = np.exp(flat - flat.max(axis=0, keepdims=True))
        prob = e / e.sum(axis=0, keepdims=True)
        idx = flat.argmax(axis=0)  # (K,)
        ys = (idx // s + 0.5) / s * bh + y0
        xs = (idx % s + 0.5) / s * bw + x0
        sc = prob[idx, np.arange(k)]
        out.append(np.stack([ys, xs, sc], axis=1))
    return np.stack(out) if out else np.zeros((0, k, 3), np.float32)
