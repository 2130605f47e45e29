"""Host input-pipeline rate of the port's COCO loader (counterpart of the
JAX package's ``tools/bench_loader.py``): can the loader feed the card?

    python -m maskrcnn_tpu_torch.tools.bench_loader [--images 256] \\
        [--size 640x480] [--objects 8] [--batches 20] [--batch-size 8] \\
        [--image-size 800x1024] [--workers 1,2,4,8] [--root DIR]

Writes a real-schema COCO directory (JPEG images of ``--size`` with
``--objects`` polygon instances each, ``instances_train.json``) under
``--root`` (a new temporary directory by default; reused when it holds one
already), then times :class:`COCODetectionLoader`'s step-pure stream (JPEG
decode, polygon rasterisation, resize, padding into ``--image-size``,
batch assembly) for each ``--loader-workers`` count and prints one JSON
line each: images per second on the host and ms per batch, after one
warm-up batch. The train step's images per second on the card
(``bench.py``) is what the loader has to keep up with.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def make_dataset(root: str, n_images: int, hw: tuple[int, int],
                 n_objects: int, n_classes: int = 20, seed: int = 0,
                 quality: int = 90, split: str = "train") -> None:
    """A COCO directory of noise JPEGs, each with ``n_objects`` 12-vertex
    polygons inside random boxes, 20 categories, and ``labels.txt``."""
    import cv2

    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, split), exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    aid = 1
    h0, w0 = hw
    for i in range(n_images):
        img = rng.randint(0, 255, (h0, w0, 3)).astype(np.uint8)
        name = f"{i:08d}.jpg"
        for _ in range(n_objects):
            w = float(rng.uniform(w0 * 0.12, w0 * 0.5))
            hh = float(rng.uniform(h0 * 0.12, h0 * 0.5))
            x = float(rng.uniform(0, w0 - w))
            y = float(rng.uniform(0, h0 - hh))
            cls = int(rng.randint(1, n_classes + 1))
            ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
            px = x + w / 2 + (w / 2) * 0.9 * np.cos(ang)
            py = y + hh / 2 + (hh / 2) * 0.9 * np.sin(ang)
            annotations.append({
                "id": aid, "image_id": i + 1, "category_id": cls,
                "bbox": [x, y, w, hh], "area": w * hh, "iscrowd": 0,
                "segmentation": [np.stack([px, py], 1).reshape(-1).tolist()]})
            aid += 1
        cv2.imwrite(os.path.join(root, split, name), img,
                    [cv2.IMWRITE_JPEG_QUALITY, quality])
        images.append({"id": i + 1, "file_name": name, "height": h0,
                       "width": w0})
    cats = [{"id": c, "name": f"class{c}"} for c in range(1, n_classes + 1)]
    with open(os.path.join(root, "annotations", f"instances_{split}.json"),
              "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    with open(os.path.join(root, "labels.txt"), "w") as f:
        f.write("\n".join(f"class{c}" for c in range(1, n_classes + 1)))


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", type=int, default=256)
    p.add_argument("--size", default="640x480", help="source images HxW")
    p.add_argument("--objects", type=int, default=8)
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", default="800x1024",
                   help="padded bucket HxW")
    p.add_argument("--workers", default="1,2,4,8")
    p.add_argument("--root", default=None,
                   help="dataset directory (generated there unless it holds "
                        "one)")
    args = p.parse_args(argv)

    from maskrcnn_tpu_torch import config as cfg_lib
    from maskrcnn_tpu_torch.data.coco import COCODetectionLoader

    h0, w0 = (int(v) for v in args.size.split("x"))
    bh, bw = (int(v) for v in args.image_size.split("x"))
    root = args.root or tempfile.mkdtemp(prefix="coco_loaderbench_")
    marker = os.path.join(root, ".generated")
    if not os.path.exists(marker):
        t0 = time.perf_counter()
        make_dataset(root, args.images, (h0, w0), args.objects)
        open(marker, "w").close()
        print(f"generated {args.images} images in "
              f"{time.perf_counter() - t0:.1f}s at {root}", file=sys.stderr)

    cfg = cfg_lib._rep(cfg_lib.fpn_mask(), train=dict(
        batch_size=args.batch_size, image_size=(bh, bw)))
    lines = []
    for n_workers in (int(w) for w in args.workers.split(",")):
        loader = COCODetectionLoader(root, "train", cfg, keypoints=False)
        it = loader.iter_from(0, n_workers=n_workers)
        next(it)  # warm-up: the annotation index, cv2's first calls
        t0 = time.perf_counter()
        for _ in range(args.batches):
            next(it)
        dt = time.perf_counter() - t0
        line = {"metric": "host_loader_images_per_sec",
                "value": args.batches * args.batch_size / dt,
                "unit": "images/s", "n_workers": n_workers,
                "batch_ms": dt / args.batches * 1e3,
                "src_size": f"{h0}x{w0}", "bucket": f"{bh}x{bw}",
                "batch_size": args.batch_size,
                "objects_per_image": args.objects, "host_cpus": os.cpu_count()}
        print(json.dumps(line))
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
