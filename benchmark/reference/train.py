"""One optimizer step of Mask R-CNN in plain torch, eagerly:

    backbone → RPN → proposals (NMS, no gradient) → proposal and anchor
    targets → ROI heads (two pools) → 5-term loss → backward → SGD.

The samplers' uniform draws come from a ``torch.Generator`` on the
parameters' device, two ``torch.rand`` calls a step in the order a
one-process run makes them. The update is optax's
``chain(add_decayed_weights(wd), sgd(lr, momentum))`` with a float32
momentum buffer: ``d = g + wd·p``, ``m ← d + momentum·m``, ``p ← p − lr·m``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import losses as L
from benchmark.reference.anchor_targets import anchor_targets
from benchmark.reference.config import Config
from benchmark.reference.maskrcnn import MaskRCNN, backbone_geometry, pyramid_shapes
from benchmark.reference.proposal_targets import (
    ProposalTargets,
    keypoint_targets,
    mask_targets,
    proposal_targets,
)
from benchmark.reference.rpn import anchors_for, generate_proposals


class Chosen(NamedTuple):
    """What a step's forward picked: the kept proposals and the sampled
    ROIs, each with its valid slots."""

    proposals: torch.Tensor  # (B, n_train_post_nms, 4)
    proposals_valid: torch.Tensor  # (B, n_train_post_nms)
    rois: torch.Tensor  # (B, n_sample, 4)
    rois_valid: torch.Tensor  # (B, n_sample)


class Draws(NamedTuple):
    proposal: torch.Tensor  # (B, 2, n_train_post_nms + G)
    anchor: torch.Tensor  # (B, 2, A)


def draw(cfg: Config, generator: torch.Generator, b: int, n_gt: int,
         n_anchor: int, device) -> Draws:
    n_cand = cfg.proposals.n_train_post_nms + n_gt
    return Draws(torch.rand((b, 2, n_cand), generator=generator, device=device),
                 torch.rand((b, 2, n_anchor), generator=generator, device=device))


def train_anchors(cfg: Config, device) -> torch.Tensor:
    shapes = pyramid_shapes(cfg, cfg.train.image_size)
    return torch.as_tensor(anchors_for(cfg, shapes, backbone_geometry(cfg)[0]),
                           device=device)


def losses(cfg: Config, model: MaskRCNN, batch, draws: Draws, anchors,
           counted: bool = False):
    """→ (total, (rpn_loc, rpn_cls, roi_loc, roi_cls, mask), Chosen) for
    one batch of device tensors (``batch`` has the fields of a train
    batch); with ``counted``, also each term's valid count, the
    denominator it divided by (before its floor of 1), as a (5,) float
    tensor."""
    n_levels = len(pyramid_shapes(cfg, cfg.train.image_size))
    n_pos_cap = int(round(cfg.sampler.n_sample * cfg.sampler.pos_ratio))
    is_keypoint = cfg.model.head == "fpn_keypoint"
    features, rpn_locs, rpn_scores = model(batch.images, train=True)
    with torch.no_grad():
        props = generate_proposals(
            rpn_locs.detach(), rpn_scores.detach(), anchors, batch.scale,
            batch.img_hw, n_pre=cfg.proposals.n_train_pre_nms,
            n_post=cfg.proposals.n_train_post_nms,
            nms_thresh=cfg.proposals.nms_thresh,
            min_size=cfg.proposals.min_size, n_levels=n_levels)
        s = cfg.sampler
        sample = proposal_targets(
            draws.proposal[:, 0], draws.proposal[:, 1], props.rois,
            props.valid, props.levels, batch.gt_boxes, batch.gt_labels,
            batch.gt_valid, n_sample=s.n_sample, pos_ratio=s.pos_ratio,
            pos_iou_thresh=s.pos_iou_thresh,
            neg_iou_thresh_hi=s.neg_iou_thresh_hi,
            neg_iou_thresh_lo=s.neg_iou_thresh_lo,
            loc_normalize_mean=s.loc_normalize_mean,
            loc_normalize_std=s.loc_normalize_std, n_levels=n_levels)
        a = cfg.anchor_targets
        at = anchor_targets(
            draws.anchor[:, 0], draws.anchor[:, 1], anchors, batch.gt_boxes,
            batch.gt_valid, batch.img_hw, n_sample=a.n_sample,
            pos_iou_thresh=a.pos_iou_thresh, neg_iou_thresh=a.neg_iou_thresh,
            pos_ratio=a.pos_ratio)
        sample_pos = ProposalTargets(*(x[:, :n_pos_cap] for x in sample))
        if is_keypoint:
            targets = keypoint_targets(sample_pos, batch.gt_keypoints,
                                       mask_size=cfg.model.mask_size)
        else:
            targets = mask_targets(sample_pos, batch.gt_masks, batch.gt_boxes,
                                   mask_size=cfg.model.mask_size)
        cls_labels = torch.where(sample.valid, sample.labels, -1).reshape(-1)
        pos_flat = (sample_pos.is_pos & sample_pos.valid).reshape(-1)
    class_idx = None if is_keypoint else (sample_pos.labels - 1).reshape(-1)
    roi_cls_locs, roi_scores, roi_masks = model.head_train(
        model.roi_features(features), sample.rois, sample.levels, n_pos_cap,
        class_idx)
    n_a = anchors.shape[0]
    b = rpn_locs.shape[0]
    rpn_loc = L.fast_rcnn_loc_loss(
        rpn_locs.reshape(b * n_a, 4), at.locs.reshape(b * n_a, 4),
        at.labels.reshape(b * n_a), sigma=3.0)
    rpn_cls = L.softmax_ce_ignore(rpn_scores.reshape(b * n_a, 2),
                                  at.labels.reshape(b * n_a))
    roi_loc = L.fast_rcnn_loc_loss(
        L.select_roi_locs(roi_cls_locs, cls_labels), sample.locs.reshape(-1, 4),
        cls_labels, sigma=1.0)
    roi_cls = L.softmax_ce_ignore(roi_scores, cls_labels)
    m = cfg.model.mask_size
    if is_keypoint:
        mask = L.keypoint_ce_loss(roi_masks, targets.reshape(-1, targets.shape[-1]),
                                  pos_flat)
    else:
        mask = L.sigmoid_mask_loss(roi_masks, targets.reshape(-1, m, m),
                                   sample_pos.labels.reshape(-1), pos_flat)
    parts = (rpn_loc, rpn_cls, roi_loc, roi_cls, mask)
    chosen = Chosen(props.rois, props.valid, sample.rois, sample.valid)
    if not counted:
        return sum(parts), parts, chosen
    n_anchors = (at.labels >= 0).sum()
    n_rois = (cls_labels >= 0).sum()
    if is_keypoint:
        labelled = torch.where(pos_flat[:, None], targets.reshape(-1, targets.shape[-1]), -1)
        n_mask = (labelled >= 0).sum()
    else:
        n_mask = pos_flat.sum()
    counts = torch.stack([n_anchors, n_anchors, n_rois, n_rois, n_mask]).float()
    return sum(parts), parts, chosen, counts


def global_losses(cfg: Config, model: MaskRCNN, batch, draws: Draws, anchors,
                  blocks: int):
    """The batch's loss in ``blocks`` blocks of its rows, as data-parallel
    ranks take it: each block's terms from its own forward, each term over
    the valid count summed over the blocks (so the sum is the whole batch's
    loss and its gradient the whole batch's) → (total, Chosen of every
    row). A block's term is its own count's mean, so its weight is its
    count over the sum of the counts."""
    rows = batch.images.shape[0] // blocks
    parts, counts, chosen = [], [], []
    for i in range(blocks):
        sl = slice(i * rows, (i + 1) * rows)
        _, p, c, n = losses(cfg, model, type(batch)(*(None if x is None else x[sl]
                                                      for x in batch)),
                            Draws(draws.proposal[sl], draws.anchor[sl]), anchors,
                            counted=True)
        parts.append(torch.stack(p))
        chosen.append(c)
        counts.append(n)
    counts = torch.stack(counts)
    weights = counts.clamp(min=1.0) / counts.sum(dim=0).clamp(min=1.0)
    total = (torch.stack(parts) * weights).sum()
    return total, Chosen(*(torch.cat(x) for x in zip(*chosen)))


class Trainer:
    """The reference's training state: the model, a float32 momentum
    buffer a parameter, the step count and the samplers' generator.
    ``chosen`` holds what the last step's forward picked."""

    def __init__(self, cfg: Config, model: MaskRCNN, generator_seed: int):
        self.cfg, self.model = cfg, model
        self.params = list(model.parameters())
        self.momentum = [torch.zeros_like(p) for p in self.params]
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(generator_seed)
        self.anchors = train_anchors(cfg, model.device)
        self.step_count = 0
        self.chosen = None

    def resume(self, params: dict, momentum: dict, step_count: int, b: int,
               n_gt: int):
        """Take the state before step ``step_count + 1`` from elsewhere:
        parameter name → value, and name → momentum buffer (a name left out
        reads 0). The samplers' generator, fresh from its seed, is moved
        past ``step_count`` steps' draws of batch ``b`` with ``n_gt`` GT slots."""
        names = [n for n, _ in self.model.named_parameters()]
        with torch.no_grad():
            for n, p, m in zip(names, self.params, self.momentum):
                p.copy_(params[n])
                if n in momentum:
                    m.copy_(momentum[n])
                else:
                    m.zero_()
        for _ in range(step_count):
            draw(self.cfg, self.generator, b, n_gt, self.anchors.shape[0],
                 self.model.device)
        self.step_count = step_count

    def lr(self) -> float:
        t = self.cfg.train
        return t.lr * t.lr_decay_factor ** (self.step_count // t.lr_decay_period)

    def step(self, batch, blocks: int = 1) -> float:
        """One step on ``batch`` (device tensors) → the total loss; with
        ``blocks`` > 1 the loss is taken in blocks of rows
        (:func:`global_losses`), as that many data-parallel ranks take it."""
        b, n_gt = batch.gt_boxes.shape[:2]
        draws = draw(self.cfg, self.generator, b, n_gt, self.anchors.shape[0],
                     self.model.device)
        for p in self.params:
            p.grad = None
        with torch.enable_grad():
            if blocks == 1:
                total, _, self.chosen = losses(self.cfg, self.model, batch, draws,
                                               self.anchors)
            else:
                total, self.chosen = global_losses(self.cfg, self.model, batch,
                                                   draws, self.anchors, blocks)
            total.backward()
        t = self.cfg.train
        lr = torch.tensor(self.lr(), dtype=torch.float32, device=self.model.device)
        with torch.no_grad():
            for p, m in zip(self.params, self.momentum):
                if p.grad is None:  # a parameter no loss reaches stays
                    continue
                m.copy_(p.grad + t.weight_decay * p + t.momentum * m)
                p.sub_(lr * m)
        self.step_count += 1
        return float(total.detach())
