"""A small COCO-format directory made from a seed, for rehearsing the COCO
path without a download.

``write_coco(root, split, sizes, seed)`` writes ``<root>/<split>/*.png`` and
``<root>/annotations/instances_<split>.json`` and
``person_keypoints_<split>.json`` in COCO's schema: 1–3 class-coloured
rectangles or ellipses an image, under the sparse category ids of
:data:`CATEGORIES`; their masks as polygons, compressed RLE and
uncompressed RLE in turn; one crowd annotation; a person with 17 keypoints
(some unlabelled or occluded) on every object, and one person without
keypoints. The images are PNG, written with ``zlib`` alone, so no image
library is needed to make them.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from maskrcnn_tpu_torch.eval.export import rle_encode

CATEGORIES = {7: "cat", 21: "dog", 56: "bird"}  # sparse ids, as COCO's
N_KEYPOINTS = 17


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB → an 8-bit truecolour PNG."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(rgb))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def rle_counts(mask: np.ndarray) -> list[int]:
    """Uncompressed COCO RLE counts: column-major runs, zeros first."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    change = np.flatnonzero(flat[1:] != flat[:-1])
    counts = np.diff(np.concatenate([[-1], change, [flat.size - 1]])).tolist()
    return ([0] + counts) if flat[0] == 1 else counts


def _colour(cat: int) -> np.ndarray:
    return np.array([(cat * 97) % 200 + 55, (cat * 57 + 80) % 200 + 55,
                     (cat * 31 + 160) % 200 + 55], np.uint8)


def write_coco(root: str, split: str, sizes, seed: int = 0) -> dict:
    """Write the directory for images of ``sizes`` [(h, w), ...] → the
    instances file's content."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cat_ids = sorted(CATEGORIES)
    images, instances, people = [], [], []
    for i, (h, w) in enumerate(sizes):
        img_id = 1000 + 3 * i  # sparse, as COCO's
        name = f"{img_id:012d}.png"
        img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
        for j in range(rng.randint(1, 4)):
            bh, bw = rng.uniform(0.25, 0.6) * h, rng.uniform(0.25, 0.6) * w
            y0, x0 = rng.uniform(0, h - bh), rng.uniform(0, w - bw)
            cat = cat_ids[rng.randint(len(cat_ids))]
            yy, xx = np.mgrid[:h, :w] + 0.5
            if rng.rand() < 0.5:
                inside = (yy >= y0) & (yy < y0 + bh) & (xx >= x0) & (xx < x0 + bw)
            else:
                inside = (((yy - y0 - bh / 2) / (bh / 2)) ** 2
                          + ((xx - x0 - bw / 2) / (bw / 2)) ** 2 <= 1.0)
            img[inside] = _colour(cat)
            mask = inside.astype(np.uint8)
            ys, xs = np.nonzero(mask)
            box = [float(xs.min()), float(ys.min()),
                   float(xs.max() + 1 - xs.min()), float(ys.max() + 1 - ys.min())]
            form = (i + j) % 3
            if form == 0:  # a polygon: the box's corners
                x, y, bw_, bh_ = box
                seg = [[x, y, x + bw_, y, x + bw_, y + bh_, x, y + bh_]]
            elif form == 1:
                seg = rle_encode(mask)
            else:
                seg = {"size": [h, w], "counts": rle_counts(mask)}
            ann_id = len(instances) + len(people) + 1
            instances.append({"id": ann_id, "image_id": img_id,
                              "category_id": cat, "bbox": box,
                              "area": float(mask.sum()), "iscrowd": 0,
                              "segmentation": seg})
            # a person on the same box: a lattice of keypoints, the last
            # unlabelled and every fifth occluded
            t = (np.arange(N_KEYPOINTS) + 0.5) / N_KEYPOINTS
            kx = box[0] + t * box[2]
            ky = box[1] + (1.0 - t) * box[3]
            v = np.where(np.arange(N_KEYPOINTS) % 5 == 4, 1, 2)
            v[-1] = 0
            kps = np.stack([np.where(v > 0, kx, 0), np.where(v > 0, ky, 0), v], 1)
            people.append({"id": ann_id + 10_000, "image_id": img_id,
                           "category_id": 1, "bbox": box,
                           "area": float(box[2] * box[3]), "iscrowd": 0,
                           "num_keypoints": int((v > 0).sum()),
                           "keypoints": [round(float(a), 2) for a in kps.reshape(-1)]})
        write_png(os.path.join(root, split, name), img)
        images.append({"id": img_id, "file_name": name, "height": h, "width": w})
    # a crowd region and a person without keypoints: both skipped
    h, w = sizes[0]
    crowd = np.zeros((h, w), np.uint8)
    crowd[: h // 4, : w // 4] = 1
    instances.append({"id": 99_999, "image_id": images[0]["id"],
                      "category_id": cat_ids[0],
                      "bbox": [0.0, 0.0, float(w // 4), float(h // 4)],
                      "area": float(crowd.sum()), "iscrowd": 1,
                      "segmentation": {"size": [h, w], "counts": rle_counts(crowd)}})
    people.append({"id": 99_998, "image_id": images[0]["id"], "category_id": 1,
                   "bbox": [0.0, 0.0, 10.0, 10.0], "area": 100.0, "iscrowd": 0,
                   "num_keypoints": 0, "keypoints": [0] * (3 * N_KEYPOINTS)})
    data = {"images": images, "annotations": instances,
            "categories": [{"id": c, "name": CATEGORIES[c]} for c in cat_ids]}
    with open(os.path.join(root, "annotations", f"instances_{split}.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(root, "annotations",
                           f"person_keypoints_{split}.json"), "w") as f:
        json.dump({"images": images, "annotations": people,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return data
