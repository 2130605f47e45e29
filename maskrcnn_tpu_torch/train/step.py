"""The train step (port of ``maskrcnn_tpu/train/step.py``):

    backbone → RPN → proposals (NMS on device, no gradient) → proposal and
    anchor targets → shared-pool ROI head → 5-term loss → backward → SGD.

Batch size is free. ``grad_accum_steps`` splits the batch into micro-batches
in a Python loop; the samplers' per-image draws are made for the whole batch
first and sliced the same way, so accumulation samples exactly what the full
batch samples and differs only in that each micro-batch's losses divide by
its own valid counts. The backbone runs in training mode: with
``model.freeze_bn=False`` its BatchNorms normalise by batch statistics and
move their running statistics in place, once per micro-batch, so the
statistics chain from one micro-batch to the next as JAX's scan carries
them. Losses are float32 whatever ``model.dtype``. Data parallelism and
chained dispatch are not here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.models.maskrcnn import (
    MaskRCNN,
    backbone_geometry,
    pyramid_shapes,
)
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals
from maskrcnn_tpu_torch.targets.anchor_targets import anchor_targets
from maskrcnn_tpu_torch.targets.proposal_targets import (
    ProposalTargets,
    mask_targets,
    proposal_targets,
)
from maskrcnn_tpu_torch.train import losses as L
from maskrcnn_tpu_torch.train.state import TrainState, lr_schedule


class Batch(NamedTuple):
    """One fixed-shape batch, arrays or tensors. Padded everywhere; the
    validity masks carry the truth."""

    images: torch.Tensor  # (B, H, W, 3) uint8 in [0, 255] or float in [0, 1]
    img_hw: torch.Tensor  # (B, 2) float32 true content extent
    scale: torch.Tensor  # (B,) resize scale (for the min-size filter)
    gt_boxes: torch.Tensor  # (B, G, 4)
    gt_labels: torch.Tensor  # (B, G) int32 0-based fg class
    gt_valid: torch.Tensor  # (B, G) bool
    gt_masks: torch.Tensor  # (B, G, S, S) box-crops, uint8 or float


class SamplerDraws(NamedTuple):
    """Uniform [0, 1) priorities of one step; index 0 of dim 1 ranks the
    positives, index 1 the negatives."""

    proposal: torch.Tensor  # (B, 2, n_train_post_nms + G)
    anchor: torch.Tensor  # (B, 2, A)


def make_train_step(cfg: Config, image_size: tuple[int, int] | None = None):
    """``train_step(state, batch, draws=None) -> metrics`` for one static
    image size (with ``cfg.train.image_buckets``, build one per bucket).

    The step updates ``state`` IN PLACE (parameters, momentum buffers, step,
    generator) and returns the ``LossBreakdown`` fields as a dict of 0-d
    tensors, plus ``n_valid_rois`` and ``n_pos_rois``, the sampled ROI slots
    that carry loss. Nothing in it waits for the device. ``draws`` replaces
    the generator's (tests feed another framework's); it runs with
    gradients and the backbone's ``train`` flag set, whatever the model's
    ``train()``/``eval()`` mode, which the port's modules do not read.
    """
    feat_strides, _ = backbone_geometry(cfg)
    feat_shapes = pyramid_shapes(cfg, image_size or cfg.train.image_size)
    anchors_np = anchors_for(cfg, feat_shapes, feat_strides)
    n_levels = len(feat_shapes)
    n_pos_cap = int(round(cfg.sampler.n_sample * cfg.sampler.pos_ratio))
    accum = max(cfg.train.grad_accum_steps, 1)
    if cfg.train.batch_size % accum != 0:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by "
                         f"grad_accum_steps {accum}")
    schedule = lr_schedule(cfg)
    anchors_on = {}

    def loss_fn(model: MaskRCNN, batch: Batch, draws: SamplerDraws, anchors):
        features, rpn_locs, rpn_scores = model(batch.images, train=True)
        with torch.no_grad():
            props = generate_proposals(
                rpn_locs.detach(), rpn_scores.detach(), anchors, batch.scale,
                batch.img_hw,
                n_pre=cfg.proposals.n_train_pre_nms,
                n_post=cfg.proposals.n_train_post_nms,
                nms_thresh=cfg.proposals.nms_thresh,
                min_size=cfg.proposals.min_size, n_levels=n_levels)
            sample = proposal_targets(
                draws.proposal[:, 0], draws.proposal[:, 1], props.rois,
                props.valid, props.levels, batch.gt_boxes, batch.gt_labels,
                batch.gt_valid,
                n_sample=cfg.sampler.n_sample,
                pos_ratio=cfg.sampler.pos_ratio,
                pos_iou_thresh=cfg.sampler.pos_iou_thresh,
                neg_iou_thresh_hi=cfg.sampler.neg_iou_thresh_hi,
                neg_iou_thresh_lo=cfg.sampler.neg_iou_thresh_lo,
                loc_normalize_mean=cfg.sampler.loc_normalize_mean,
                loc_normalize_std=cfg.sampler.loc_normalize_std,
                n_levels=n_levels)
            at = anchor_targets(
                draws.anchor[:, 0], draws.anchor[:, 1], anchors,
                batch.gt_boxes, batch.gt_valid, batch.img_hw,
                n_sample=cfg.anchor_targets.n_sample,
                pos_iou_thresh=cfg.anchor_targets.pos_iou_thresh,
                neg_iou_thresh=cfg.anchor_targets.neg_iou_thresh,
                pos_ratio=cfg.anchor_targets.pos_ratio)
            # only positives carry mask loss, and the sampler puts them
            # first: the mask branch runs on the (B, :n_pos_cap) prefix
            sample_pos = ProposalTargets(*(x[:, :n_pos_cap] for x in sample))
            m_t = mask_targets(sample_pos, batch.gt_masks, batch.gt_boxes,
                               mask_size=cfg.model.mask_size)
            cls_labels = torch.where(
                sample.valid, sample.labels, -1).reshape(-1)
            pos_flat = (sample_pos.is_pos & sample_pos.valid).reshape(-1)

        # class-gathered final conv: each positive's GT-class channel only
        class_idx = (sample_pos.labels - 1).reshape(-1)
        roi_cls_locs, roi_scores, roi_masks = model.head_train(
            features, sample.rois, sample.levels, n_pos_cap, class_idx)

        a = anchors.shape[0]
        b = rpn_locs.shape[0]
        rpn_loc_loss = L.fast_rcnn_loc_loss(
            rpn_locs.reshape(b * a, 4), at.locs.reshape(b * a, 4),
            at.labels.reshape(b * a), sigma=3.0)
        rpn_cls_loss = L.softmax_ce_ignore(
            rpn_scores.reshape(b * a, 2), at.labels.reshape(b * a))
        roi_loc_loss = L.fast_rcnn_loc_loss(
            L.select_roi_locs(roi_cls_locs, cls_labels),
            sample.locs.reshape(-1, 4), cls_labels, sigma=1.0)
        roi_cls_loss = L.softmax_ce_ignore(roi_scores, cls_labels)
        s = cfg.model.mask_size
        mask_loss = L.sigmoid_mask_loss(
            roi_masks, m_t.reshape(-1, s, s), sample_pos.labels.reshape(-1),
            pos_flat)
        total = (rpn_loc_loss + rpn_cls_loss + roi_loc_loss + roi_cls_loss
                 + mask_loss)
        counts = torch.stack([sample.valid.sum(),
                              (sample.is_pos & sample.valid).sum()])
        return L.LossBreakdown(total, rpn_loc_loss, rpn_cls_loss,
                               roi_loc_loss, roi_cls_loss, mask_loss), counts

    def train_step(state: TrainState, batch: Batch,
                   draws: SamplerDraws | None = None) -> dict:
        model = state.model
        dev = model.device
        if dev not in anchors_on:
            anchors_on[dev] = torch.as_tensor(anchors_np, device=dev)
        anchors = anchors_on[dev]
        batch = Batch(*(torch.as_tensor(x, device=dev) for x in batch))
        b = batch.images.shape[0]
        if b % accum != 0:
            raise ValueError(f"batch {b} not divisible by grad_accum_steps "
                             f"{accum}")
        if draws is None:
            n_cand = cfg.proposals.n_train_post_nms + batch.gt_boxes.shape[1]
            draws = SamplerDraws(
                torch.rand((b, 2, n_cand), generator=state.generator, device=dev),
                torch.rand((b, 2, anchors.shape[0]), generator=state.generator,
                           device=dev))
        else:
            draws = SamplerDraws(*(torch.as_tensor(x, device=dev) for x in draws))

        state.optimizer.zero_grad(set_to_none=True)
        micro = b // accum
        bds, counts = [], []
        with torch.enable_grad():
            for i in range(accum):
                rows = slice(i * micro, (i + 1) * micro)
                bd, cnt = loss_fn(model, Batch(*(x[rows] for x in batch)),
                                  SamplerDraws(*(x[rows] for x in draws)),
                                  anchors)
                bd.loss.backward()
                bds.append(torch.stack(bd).detach())
                counts.append(cnt)
        if accum > 1:
            torch._foreach_div_(
                [p.grad for p in model.parameters() if p.grad is not None],
                float(accum))
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.step += 1
        bd = L.LossBreakdown(*torch.stack(bds).mean(dim=0))
        n_valid, n_pos = torch.stack(counts).sum(dim=0)
        return {**bd._asdict(), "n_valid_rois": n_valid, "n_pos_rois": n_pos}

    return train_step
