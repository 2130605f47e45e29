"""The least bytes the pools must move at a cell's shapes, fixed by each
operation's own inputs and outputs, never by a kernel's layout: the
denominators' numerators of the pool kernels' roofline shares.

- ROIAlign forward (B2): the pooled output written once, the boxes read
  once, float32.
- Its backward, the region scatter (B1): the pooled cotangent read once,
  the feature gradient (every level of the pyramid, every image) written
  once, float32.
"""

from __future__ import annotations

F32 = 4
BOX = 4 * F32
STRIDES = {"fpn": (4, 8, 16, 32), "darknet": (16,)}


def pyramid(config: dict) -> list[tuple[int, int]]:
    """The levels' (H, W) at the configuration's image size: the FPN's
    P2–P5 and P6 = ceil(P5 / 2), or the one stride-16 level."""
    h, w = config["train"]["image_size"]
    backbone = config["model"]["backbone"]
    shapes = [(h // s, w // s) for s in STRIDES[backbone]]
    if backbone == "fpn":
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    return shapes


def pooled_elements(n_rois: int, out: int, channels: int) -> int:
    return n_rois * out * out * channels


def train_pool_bytes(config: dict) -> int:
    """B2's two calls (box branch on every sampled ROI, mask branch on the
    positive prefix) and B1's one, over a train step."""
    b = config["train"]["batch_size"]
    c = config["model"]["fpn_channels"]
    n = config["sampler"]["n_sample"]
    n_pos = round(n * config["sampler"]["pos_ratio"])
    pooled = (pooled_elements(b * n, 7, c) + pooled_elements(b * n_pos, 14, c))
    roi_align = pooled * F32 + (b * n + b * n_pos) * BOX
    features = b * sum(h * w for h, w in pyramid(config)) * c
    region_scatter = (pooled + features) * F32
    return roi_align + region_scatter


def serve_pool_bytes(config: dict) -> int:
    """B2's two calls of a batch-1 request: the box branch on the proposal
    slots, the mask branch on the detection slots."""
    c = config["model"]["fpn_channels"]
    r = config["proposals"]["n_test_post_nms"]
    d = config["eval"]["max_detections"]
    pooled = pooled_elements(r, 7, c) + pooled_elements(d, 14, c)
    return pooled * F32 + (r + d) * BOX
