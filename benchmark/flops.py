"""The model's FLOPs of one train step or one request, counted once per
configuration on the reference with shapes alone (the meta device): every
convolution, matrix product and their backward that the step or request
runs. NMS, ROIAlign and its backward are left out: their work depends on
the data, and no dispatch mode sees what a hand-written kernel does. The
counts are written into each configuration's file, so no later change to
the program can change them.

    python -m benchmark.flops --config fpn_mask
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import spec
from benchmark.reference import config as ref_config
from benchmark.reference import maskrcnn as ref_maskrcnn
from benchmark.reference.roi_align import roi_align_gather
from benchmark.reference.maskrcnn import MaskRCNN, pyramid_shapes
from benchmark.reference.proposal_targets import ProposalTargets, mask_targets


@contextlib.contextmanager
def _pools_uncounted():
    """Inside, the reference pools in its pointwise form, which has no
    matrix product forward or backward: the pools' work stays out of the
    count whichever form the configuration states."""
    pool, pair = ref_maskrcnn.multilevel_roi_align, ref_maskrcnn.multilevel_roi_align_train

    def two_pools(features, rois_bn, levels_bn, n_pos, box, mask, scales):
        b, n = rois_bn.shape[:2]
        idx = torch.zeros((b * n,), dtype=torch.int32, device=rois_bn.device)
        flat_rois, flat_levels = rois_bn.reshape(b * n, 4), levels_bn.reshape(b * n)
        return (roi_align_gather(features, flat_rois, idx, flat_levels, box, scales),
                roi_align_gather(features, rois_bn[:, :n_pos].reshape(-1, 4),
                                 idx[:b * n_pos], levels_bn[:, :n_pos].reshape(-1),
                                 mask, scales))

    ref_maskrcnn.multilevel_roi_align = (
        lambda *args, **kw: roi_align_gather(*args, **kw))
    ref_maskrcnn.multilevel_roi_align_train = two_pools
    try:
        yield
    finally:
        ref_maskrcnn.multilevel_roi_align = pool
        ref_maskrcnn.multilevel_roi_align_train = pair


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with _pools_uncounted(), counter:
        fn()
    return counter.get_total_flops()


def train_step_flops(cfg) -> int:
    """One optimizer step at ``cfg.train.batch_size``: the backbone and RPN
    forward and backward, the box branch on ``n_sample`` ROIs an image and
    the mask or keypoint branch on the positive prefix, forward and
    backward, and the mask head's targets: each positive's GT crop
    resampled to the mask grid by two matrix products. The image gets no
    gradient, as in a step."""
    model = MaskRCNN(cfg, device="meta")
    b = cfg.train.batch_size
    h, w = cfg.train.image_size
    n = cfg.sampler.n_sample
    n_pos = int(round(n * cfg.sampler.pos_ratio))
    keypoint = cfg.model.head == "fpn_keypoint"

    def step():
        images = torch.empty((b, h, w, 3), device="meta")
        features, locs, scores = model(images, train=True)
        rois = torch.empty((b, n, 4), device="meta")
        levels = torch.empty((b, n), dtype=torch.int32, device="meta")
        class_idx = (None if keypoint else
                     torch.empty((b * n_pos,), dtype=torch.long, device="meta"))
        roi_locs, roi_scores, masks = model.head_train(
            features, rois, levels, n_pos, class_idx)
        total = (locs.sum() + scores.sum() + roi_locs.sum() + roi_scores.sum()
                 + masks.sum())
        total.backward()
        if not keypoint:
            g, s = cfg.train.max_gt, cfg.train.gt_mask_size
            meta = dict(device="meta")
            sample = ProposalTargets(
                torch.empty((b, n_pos, 4), **meta),
                torch.empty((b, n_pos), dtype=torch.int32, **meta),
                torch.empty((b, n_pos), dtype=torch.int32, **meta),
                torch.empty((b, n_pos, 4), **meta),
                torch.empty((b, n_pos), dtype=torch.long, **meta),
                torch.empty((b, n_pos), dtype=torch.bool, **meta),
                torch.empty((b, n_pos), dtype=torch.bool, **meta))
            mask_targets(sample, torch.empty((b, g, s, s), dtype=torch.uint8, **meta),
                         torch.empty((b, g, 4), **meta), cfg.model.mask_size)

    return _count(step)


def head_rows(cfg) -> int:
    """The detection slots of a batch-1 request that pass 2 runs its head
    on: all ``max_detections`` = d, or, where per-class NMS keeps only
    ``n_kept`` = n_fg · min(n_test_post_nms, d) < d (class, box) pairs,
    the first ``n_kept + 1``: the rest are copies of one padding slot."""
    d = cfg.eval.max_detections
    n_kept = cfg.model.n_fg_class * min(cfg.proposals.n_test_post_nms, d)
    return d if n_kept >= d else n_kept + 1


def request_flops(cfg) -> int:
    """One batch-1 request: backbone and RPN, the box branch on the
    ``n_test_post_nms`` proposal slots, the mask or keypoint branch on the
    :func:`head_rows` rows of the ``max_detections`` slots."""
    model = MaskRCNN(cfg, device="meta")
    h, w = cfg.train.image_size
    r = cfg.proposals.n_test_post_nms
    d = head_rows(cfg)
    keypoint = cfg.model.head == "fpn_keypoint"

    def request():
        with torch.no_grad():
            features, _, _ = model(torch.empty((1, h, w, 3), device="meta"))
            model.head_box(features, torch.empty((r, 4), device="meta"),
                           torch.empty((r,), dtype=torch.int32, device="meta"),
                           torch.empty((r,), dtype=torch.int32, device="meta"))
            idx = torch.empty((d,), dtype=torch.int32, device="meta")
            model.head_mask(features, torch.empty((d, 4), device="meta"), idx,
                            idx, None if keypoint else idx.long())

    return _count(request)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    args = p.parse_args(argv)
    cfg = spec.build_config(ref_config, spec.config_file(args.config))
    print(json.dumps({"config": args.config,
                      "train_step": train_step_flops(cfg),
                      "request": request_flops(cfg),
                      "pyramid": pyramid_shapes(cfg, cfg.train.image_size)}))


if __name__ == "__main__":
    main()
