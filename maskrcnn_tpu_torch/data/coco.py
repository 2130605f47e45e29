"""COCO-format dataset loader (port of ``maskrcnn_tpu/data/coco.py``): the
host pipeline that feeds fixed-shape batches.

Images are resized so that the short side is at most 600 and the long side
at most 1000 (and the result fits the bucket), boxes become (y0, x0, y1, x1)
float32, sparse COCO category ids map to contiguous labels in id order,
instance masks become fixed-size box crops (``cfg.train.gt_mask_size``) and
person keypoints (y, x, v) rows. Crowd annotations are skipped. Each image
is pasted into a static padded bucket (``cfg.train.image_size``, or the
least-waste one of ``cfg.train.image_buckets``) whose true extent travels
as ``img_hw``; GT slots are padded or cut to ``cfg.train.max_gt``.

Annotations are parsed with ``json``; RLE masks decode with a small numpy
codec and polygons rasterize with ``cv2.fillPoly``, or both through the C++
library ``native/libcoco_fast.so`` when it loads (:mod:`._native`). Images
decode and resize with cv2 inside the loader's functions, as the JAX loader
does, so a batch carries the JAX loader's pixels bit for bit; the rest of
the port imports no cv2. Batches are the port's :class:`Batch` of numpy
arrays on the host (images and mask crops uint8); the caller moves them to
its device. The stream is a pure function of the step (:meth:`iter_from`).
Under ``torch.distributed`` each process reads its own slice of the images,
``ids[rank::world]`` (``split_by_rank=False`` reads them all, as an
evaluation on one rank does), and ``epoch_images`` counts the whole split's.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.data import _native
from maskrcnn_tpu_torch.data.keypoints import flip_permutation, keypoint_names
from maskrcnn_tpu_torch.parallel.data_parallel import rank_world
from maskrcnn_tpu_torch.train.step import Batch


def rle_decode(rle: dict) -> np.ndarray:
    if _native.available():
        return _native.rle_decode(rle)
    return _rle_decode_np(rle)


def _rle_decode_np(rle: dict) -> np.ndarray:
    """Decode COCO RLE (uncompressed counts list or compressed LEB128-style
    string) → (H, W) uint8 mask. Column-major (Fortran) order per COCO spec."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _decode_compressed_counts(counts.encode("ascii"))
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T  # fortran order


def _decode_compressed_counts(s: bytes) -> list[int]:
    """COCO's modified LEB128 with delta encoding (pycocotools rleFrString)."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def polygons_to_mask(polys: list, h: int, w: int) -> np.ndarray:
    if _native.available():
        return _native.polygons_to_mask(polys, h, w)
    return _polygons_to_mask_cv2(polys, h, w)


def _polygons_to_mask_cv2(polys: list, h: int, w: int) -> np.ndarray:
    import cv2

    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polys
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    seg = ann["segmentation"]
    if isinstance(seg, list):
        return polygons_to_mask(seg, h, w)
    if isinstance(seg, dict):
        return rle_decode(seg)
    raise ValueError(f"unknown segmentation format: {type(seg)}")


class COCOIndex:
    """Minimal COCO annotation index (no pycocotools)."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            data = json.load(f)
        self.images = {im["id"]: im for im in data["images"]}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_anns: dict[int, list] = {}
        for ann in data.get("annotations", []):
            self.img_anns.setdefault(ann["image_id"], []).append(ann)
        # contiguous labels in the order of the sorted category ids
        self.cat_ids = sorted(self.cats.keys())
        self.cat_to_contiguous = {c: i for i, c in enumerate(self.cat_ids)}
        self.label_names = [self.cats[c]["name"] for c in self.cat_ids]


class COCODetectionLoader:
    """Yields fixed-shape ``Batch``es for mask or keypoint training."""

    def __init__(self, root: str, split: str, cfg: Config, seed: int = 0,
                 keypoints: bool | None = None, flip: bool = True,
                 min_size: int = 600, max_size: int = 1000,
                 category_filter: list[str] | None = None,
                 split_by_rank: bool = True):
        self.root = root
        self.split = split
        self.cfg = cfg
        self.flip = flip
        self.min_size = min_size
        self.max_size = max_size
        self.keypoints = (
            keypoints if keypoints is not None
            else cfg.model.head == "fpn_keypoint"
        )
        ann_kind = "person_keypoints" if self.keypoints else "instances"
        ann_file = os.path.join(root, "annotations", f"{ann_kind}_{split}.json")
        self.index = COCOIndex(ann_file)
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self._order_cache: tuple[int, np.ndarray] | None = None
        self._waste_sum = 0.0
        self._waste_n = 0
        self._waste_lock = threading.Lock()  # get_example runs on a pool
        if self.keypoints:
            # a flip swaps the left and right joints' rows, then mirrors x
            self.kp_flip_perm = flip_permutation(
                keypoint_names(cfg.model.n_keypoints))

        # keep images holding ANY of the named categories
        self.filter_cat_ids = None
        if category_filter is not None:
            name_to_id = {c["name"]: cid for cid, c in self.index.cats.items()}
            unknown = [n for n in category_filter if n not in name_to_id]
            if unknown:
                raise ValueError(f"unknown COCO categories: {unknown}")
            self.filter_cat_ids = {name_to_id[n] for n in category_filter}

        # images with at least one usable (non-crowd) annotation
        self.ids = []
        for img_id, anns in self.index.img_anns.items():
            usable = [a for a in anns if not a.get("iscrowd", 0)]
            if self.keypoints:
                usable = [a for a in usable if a.get("num_keypoints", 0) > 0]
            if self.filter_cat_ids is not None:
                usable = [a for a in usable
                          if a["category_id"] in self.filter_cat_ids]
            if usable:
                self.ids.append(img_id)
        self.ids.sort()
        self.epoch_images = len(self.ids)  # over every rank
        rank, world = rank_world()
        if world > 1 and split_by_rank:
            self.ids = self.ids[rank::world]

    def __len__(self):
        return len(self.ids)

    def _load_image(self, info) -> np.ndarray:
        import cv2

        path = os.path.join(self.root, self.split, info["file_name"])
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_example(self, i: int, rng: np.random.RandomState | None = None,
                    image_size: tuple[int, int] | None = None):
        """One padded example: the Batch fields of one image.

        ``rng`` drives the flip draw (the loader's own when None);
        ``image_size`` overrides the padded bucket."""
        import cv2

        if rng is None:
            rng = self.rng

        cfg = self.cfg
        bh, bw = image_size or cfg.train.image_size
        g = cfg.train.max_gt
        s = cfg.train.gt_mask_size

        img_id = self.ids[i]
        info = self.index.images[img_id]
        anns = [
            a for a in self.index.img_anns[img_id] if not a.get("iscrowd", 0)
        ]
        if self.keypoints:
            anns = [a for a in anns if a.get("num_keypoints", 0) > 0]
        img = self._load_image(info)
        h0, w0 = img.shape[:2]

        # resize: short side ≤ min_size, long side ≤ max_size, inside the
        # static bucket
        scale = min(self.min_size / min(h0, w0), self.max_size / max(h0, w0))
        scale = min(scale, bh / h0, bw / w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
        with self._waste_lock:
            self._waste_sum += 1.0 - (nh * nw) / float(bh * bw)
            self._waste_n += 1

        do_flip = self.flip and rng.rand() < 0.5
        if do_flip:
            img = img[:, ::-1]

        # uint8 canvas: the model divides by 255 on its device
        canvas = np.zeros((bh, bw, 3), np.uint8)
        canvas[:nh, :nw] = img

        boxes = np.zeros((g, 4), np.float32)
        labels = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        masks = np.zeros((g, s, s), np.float32)
        kps = np.zeros((g, self.cfg.model.n_keypoints, 3), np.float32)

        n = 0
        for ann in anns:
            if n >= g:
                break
            x, y, wb, hb = ann["bbox"]
            y0, x0 = y * scale, x * scale
            y1, x1 = (y + hb) * scale, (x + wb) * scale
            # at least one pixel
            y1 = min(max(y1, y0 + 1), nh)
            x1 = min(max(x1, x0 + 1), nw)
            if do_flip:
                x0, x1 = nw - x1, nw - x0
            boxes[n] = [y0, x0, y1, x1]
            labels[n] = self.index.cat_to_contiguous[ann["category_id"]]
            valid[n] = True

            if self.keypoints:
                kp = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
                if do_flip and len(kp) == len(self.kp_flip_perm):
                    kp = kp[self.kp_flip_perm]
                ky = kp[:, 1] * scale
                kx = kp[:, 0] * scale
                if do_flip:
                    kx = np.where(kp[:, 2] > 0, nw - kx, kx)
                k_count = min(len(kp), kps.shape[1])
                kps[n, :k_count, 0] = ky[:k_count]
                kps[n, :k_count, 1] = kx[:k_count]
                kps[n, :k_count, 2] = kp[:k_count, 2]
            else:
                full = ann_to_mask(ann, h0, w0)
                if do_flip:
                    full = full[:, ::-1]
                    fx0, fx1 = w0 - (x + wb), w0 - x
                else:
                    fx0, fx1 = x, x + wb
                # crop to the original-resolution box, resize to the crop size
                cy0, cy1 = int(np.floor(y)), int(np.ceil(y + hb))
                cx0, cx1 = int(np.floor(fx0)), int(np.ceil(fx1))
                cy0, cx0 = max(cy0, 0), max(cx0, 0)
                cy1, cx1 = min(max(cy1, cy0 + 1), h0), min(max(cx1, cx0 + 1), w0)
                crop = full[cy0:cy1, cx0:cx1].astype(np.float32)
                masks[n] = cv2.resize(crop, (s, s),
                                      interpolation=cv2.INTER_LINEAR)
            n += 1

        return dict(
            image=canvas,
            img_hw=np.array([nh, nw], np.float32),
            scale=np.float32(scale),
            gt_boxes=boxes,
            gt_labels=labels,
            gt_valid=valid,
            # [0, 1] crops as uint8 (at most 1/510 off, under the 0.5
            # threshold of the mask targets)
            gt_masks=(masks * 255.0 + 0.5).astype(np.uint8),
            gt_keypoints=kps,
        )

    def batch(self, indices, rngs=None, image_size=None, pool=None) -> Batch:
        """The examples of ``indices`` (modulo the image count) stacked; with
        ``pool``, decoded on its threads (cv2 releases the interpreter lock)."""
        if rngs is None:
            rngs = [None] * len(indices)
        if pool is not None:
            ex = list(pool.map(
                lambda a: self.get_example(a[0] % len(self.ids), a[1],
                                           image_size),
                zip(indices, rngs),
            ))
        else:
            ex = [self.get_example(i % len(self.ids), rng, image_size)
                  for i, rng in zip(indices, rngs)]
        stack = lambda k: np.stack([e[k] for e in ex])  # noqa: E731
        return Batch(
            images=stack("image"),
            img_hw=stack("img_hw"),
            scale=np.array([e["scale"] for e in ex], np.float32),
            gt_boxes=stack("gt_boxes"),
            gt_labels=stack("gt_labels"),
            gt_valid=stack("gt_valid"),
            gt_masks=None if self.keypoints else stack("gt_masks"),
            gt_keypoints=stack("gt_keypoints") if self.keypoints else None,
        )

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        order = np.arange(len(self.ids))
        np.random.RandomState(
            (self.seed * 100_003 + epoch) % (2**31 - 1)
        ).shuffle(order)
        self._order_cache = (epoch, order)
        return order

    def _example_rng(self, epoch: int, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.seed * 100_003 + epoch * 131_071 + idx) % (2**31 - 1)
        )

    def bucket_of(self, i: int) -> int:
        """The bucket that pads image ``i`` least, from the annotation's
        image size alone (no decode), so a seek can replay the grouping."""
        buckets = self.cfg.train.image_buckets
        info = self.index.images[self.ids[i]]
        h0, w0 = info["height"], info["width"]
        best, best_waste = 0, 2.0
        for k, (bh, bw) in enumerate(buckets):
            scale = min(self.min_size / min(h0, w0),
                        self.max_size / max(h0, w0), bh / h0, bw / w0)
            waste = 1.0 - (h0 * scale) * (w0 * scale) / float(bh * bw)
            if waste < best_waste - 1e-9:
                best, best_waste = k, waste
        return best

    def padding_waste(self) -> float:
        """Mean padded-area fraction over all examples loaded so far."""
        return self._waste_sum / max(1, self._waste_n)

    def iter_from(self, step: int = 0, n_workers: int = 1):
        """Infinite batch stream as a pure function of the global step.

        Each epoch's shuffle and each example's flip draw derive from
        (seed, epoch, image index), not from the iterator's history, so a
        run resumed at step k sees the batches an uninterrupted run would.
        With more than one ``cfg.train.image_buckets``, each image goes to
        its least-waste bucket and a batch is emitted when a bucket fills;
        a seek replays the grouping from the image sizes without decoding.
        ``n_workers > 1`` decodes a batch's examples on that many threads;
        the batches are the same for any worker count.
        """
        pool = None
        if n_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(n_workers)
        try:
            buckets = self.cfg.train.image_buckets
            if buckets and len(buckets) > 1:
                yield from self._iter_bucketed(step, pool)
                return
            # a lone bucket replaces cfg.train.image_size
            image_size = buckets[0] if buckets else None
            b = self.cfg.train.batch_size
            per_epoch = max(1, len(self.ids) // b)
            while True:
                epoch, j = divmod(step, per_epoch)
                order = self._epoch_order(epoch)
                idxs = order.take(np.arange(j * b, (j + 1) * b), mode="wrap")
                rngs = [self._example_rng(epoch, int(i)) for i in idxs]
                yield self.batch(idxs, rngs, image_size=image_size, pool=pool)
                step += 1
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _iter_bucketed(self, step: int, pool=None):
        b = self.cfg.train.batch_size
        buckets = list(self.cfg.train.image_buckets)
        queues: list[list[tuple[int, int]]] = [[] for _ in buckets]
        produced = 0
        epoch = 0
        while True:
            order = self._epoch_order(epoch)
            for i in order:
                bi = self.bucket_of(int(i))
                queues[bi].append((epoch, int(i)))
                if len(queues[bi]) == b:
                    group, queues[bi] = queues[bi], []
                    if produced >= step:
                        idxs = [g[1] for g in group]
                        rngs = [self._example_rng(e, gi) for e, gi in group]
                        yield self.batch(idxs, rngs, image_size=buckets[bi],
                                         pool=pool)
                    produced += 1
            epoch += 1

    def __iter__(self):
        return self.iter_from(0)
