"""The train step (port of ``maskrcnn_tpu/train/step.py``):

    backbone → RPN → proposals (NMS on device, no gradient) → proposal and
    anchor targets → shared-pool ROI head → 5-term loss → backward → SGD.

The fifth term is the mask loss of the mask head, or the keypoint heatmap
loss of the keypoint head (``cfg.model.head == "fpn_keypoint"``), which
reads ``gt_keypoints`` where the mask head reads ``gt_masks``.

Batch size is free. ``grad_accum_steps`` splits the batch into micro-batches
in a Python loop; the samplers' per-image draws are made for the whole batch
first and sliced the same way, so accumulation samples exactly what the full
batch samples and differs only in that each micro-batch's losses divide by
its own valid counts. The backbone runs in training mode: with
``model.freeze_bn=False`` its BatchNorms normalise by batch statistics and
move their running statistics in place, once per micro-batch, so the
statistics chain from one micro-batch to the next as JAX's scan carries
them. Losses are float32 whatever ``model.dtype``.

Under data parallelism (a process group of W ranks when the step is built,
:mod:`maskrcnn_tpu_torch.parallel.data_parallel`) ``cfg.train.batch_size``
is the global batch and each rank is handed its b = B/W rows. Each rank
draws the global (B, 2, n) sampler tables from ``state.generator`` and
takes rows ``[rank·b, (rank+1)·b)``, as JAX slices its global key table, so
the generator advances alike on every rank. The losses divide by counts
summed over the ranks, trainable BatchNorms take global batch statistics
(sync-BN), and after the backward the gradients, the loss terms and the ROI
counts are summed over the ranks (JAX's ``psum``, not ``pmean``); with
``grad_accum_steps`` the micro-gradients are averaged first, each
micro-batch dividing by its own global counts. Then the optimizer steps,
and the running statistics are averaged over the ranks.

Nothing in a step waits for the device: the batch goes up by copies that
do not wait, NMS is a kernel, the learning rate is computed on the device
from a step counter (:func:`maskrcnn_tpu_torch.train.state.lr_on_device`)
and the kernels' shapes are static. So on the card the step can be
captured into a CUDA graph, which is what chained dispatch does
(``make_train_step(cfg, chain=K)``, JAX's ``lax.scan`` over K batches):
one call runs K optimizer steps, exactly K sequential steps. On the CPU
the chained step is a Python loop of the step; on the card the first call
takes its first step eagerly (a step of the run, which warms up cuBLAS,
cuDNN, the momentum buffers and the gradients' memory; as in every eager
step, cuDNN times each convolution problem there,
:func:`maskrcnn_tpu_torch.models.layers.tuned_convolutions`), captures one
step into a ``torch.cuda.CUDAGraph`` that reads its batch and its sampler
draws from static device buffers, and replays it for the rest; later calls
replay it K times. The draws are made eagerly before the replays, in the
eager step's order, from ``state.generator``, so replayed steps sample
what eager steps sample and the generator resumes alike. Not under data
parallelism (as in JAX).

With :mod:`maskrcnn_tpu_torch.utils.tracing` on, a call records the spans
``train_call`` (its id ``state.step``) around ``train.stage`` (the batch
up), ``train.draws``, ``train.step`` (an eager step), ``capture``,
``train.replay`` (one a replayed step, its id the step's) and
``train.collect``; the step marks the device stages ``forward``,
``proposals``, ``targets``, ``heads``, ``backward`` and ``optimizer``
(repeated stages of micro-batches summed) and counts kept proposals and
positive mask ROIs against their slots, and the convolution problems first
seen with cuDNN's timing on and off (``conv_problems_tuned``/``_untuned``).
A chained call recaptures its graph when the tracing flag differs from its
capture's.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.kernels import (  # noqa: F401 (KERNELS: step.KERNELS)
    KERNELS,
    add_launches,
    launch_counts,
    take_back_launches,
)
from maskrcnn_tpu_torch.models.maskrcnn import (
    MaskRCNN,
    backbone_geometry,
    pyramid_shapes,
)
from maskrcnn_tpu_torch.models.backbones.resnet import batch_statistics_synced
from maskrcnn_tpu_torch.models.layers import tuned_convolutions
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals
from maskrcnn_tpu_torch.parallel import data_parallel as dp
from maskrcnn_tpu_torch.targets.anchor_targets import anchor_targets
from maskrcnn_tpu_torch.targets.proposal_targets import (
    ProposalTargets,
    keypoint_targets,
    mask_targets,
    proposal_targets,
)
from maskrcnn_tpu_torch.train import losses as L
from maskrcnn_tpu_torch.train.state import TrainState, lr_on_device, lr_schedule
from maskrcnn_tpu_torch.utils import tracing

class Batch(NamedTuple):
    """One fixed-shape batch, arrays or tensors. Padded everywhere; the
    validity masks carry the truth."""

    images: torch.Tensor  # (B, H, W, 3) uint8 in [0, 255] or float in [0, 1]
    img_hw: torch.Tensor  # (B, 2) float32 true content extent
    scale: torch.Tensor  # (B,) resize scale (for the min-size filter)
    gt_boxes: torch.Tensor  # (B, G, 4)
    gt_labels: torch.Tensor  # (B, G) int32 0-based fg class
    gt_valid: torch.Tensor  # (B, G) bool
    gt_masks: torch.Tensor | None = None  # (B, G, S, S) box-crops, uint8 or
    #   float (the mask head's)
    gt_keypoints: torch.Tensor | None = None  # (B, G, K, 3) (y, x, v) in
    #   image coordinates (the keypoint head's)


def _map(fn, batch: Batch) -> Batch:
    """``fn`` applied to every field a batch carries; absent ones stay None."""
    return Batch(*(None if x is None else fn(x) for x in batch))


def stack_batches(raw: list) -> Batch:
    """K numpy batches → one whose every field has a leading (K, ...) axis,
    the input of a chained step."""
    return type(raw[0])(*(None if x[0] is None else np.stack(x)
                          for x in zip(*raw)))


class SamplerDraws(NamedTuple):
    """Uniform [0, 1) priorities of one step; index 0 of dim 1 ranks the
    positives, index 1 the negatives."""

    proposal: torch.Tensor  # (B, 2, n_train_post_nms + G)
    anchor: torch.Tensor  # (B, 2, A)


def to_device(fields, dev):
    """Every field of a ``Batch`` or ``SamplerDraws`` (numpy or tensors) on
    ``dev``. Copies from the host do not wait for the device: a pageable
    source is staged before the call returns."""
    return type(fields)(*(None if x is None else
                          torch.as_tensor(x).to(dev, non_blocking=True)
                          for x in fields))


def make_train_step(cfg: Config, image_size: tuple[int, int] | None = None,
                    chain: int = 1):
    """``train_step(state, batch, draws=None) -> metrics`` for one static
    image size (with ``cfg.train.image_buckets``, build one per bucket).

    The step updates ``state`` IN PLACE (parameters, momentum buffers, step,
    generator) and returns the ``LossBreakdown`` fields as a dict of 0-d
    tensors, plus ``n_valid_rois`` and ``n_pos_rois``, the sampled ROI slots
    that carry loss. Nothing in it waits for the device. ``draws`` replaces
    the generator's (tests feed another framework's); it runs with
    gradients and the backbone's ``train`` flag set, whatever the model's
    ``train()``/``eval()`` mode, which the port's modules do not read.

    ``chain=K > 1`` returns ``chained(state, batches, draws=None) ->
    metrics`` instead: every field of ``batches`` (and of ``draws``) carries
    a leading ``(K, ...)`` axis, the call runs exactly K sequential steps,
    each metric comes back stacked ``(K,)`` and ``state.step`` advances by
    K. On the card the steps after the first call's first are replays of a
    CUDA graph of the step (the module's docstring).
    """
    feat_strides, _ = backbone_geometry(cfg)
    feat_shapes = pyramid_shapes(cfg, image_size or cfg.train.image_size)
    anchors_np = anchors_for(cfg, feat_shapes, feat_strides)
    n_levels = len(feat_shapes)
    n_pos_cap = int(round(cfg.sampler.n_sample * cfg.sampler.pos_ratio))
    is_keypoint = cfg.model.head == "fpn_keypoint"
    accum = max(cfg.train.grad_accum_steps, 1)
    if cfg.train.batch_size % accum != 0:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by "
                         f"grad_accum_steps {accum}")
    if chain < 1:
        raise ValueError(f"chain must be at least 1, got {chain}")
    rank, world = dp.rank_world()
    parallel = world > 1
    if cfg.train.batch_size % world != 0:
        raise ValueError(f"batch_size {cfg.train.batch_size} not divisible by "
                         f"the world size {world}")
    if parallel and chain > 1:
        raise ValueError("chain > 1 under data parallelism: the JAX package "
                         "chains only the one-device step too")
    schedule = lr_schedule(cfg)
    on_device = {}  # device → (anchors, step counter)

    def device_state(dev):
        if dev not in on_device:
            on_device[dev] = (torch.as_tensor(anchors_np, device=dev),
                              torch.zeros((), dtype=torch.int64, device=dev))
        return on_device[dev]

    def loss_fn(model: MaskRCNN, batch: Batch, draws: SamplerDraws, anchors):
        tracing.stage("forward")
        features, rpn_locs, rpn_scores = model(batch.images, train=True)
        with torch.no_grad():
            tracing.stage("proposals")
            props = generate_proposals(
                rpn_locs.detach(), rpn_scores.detach(), anchors, batch.scale,
                batch.img_hw,
                n_pre=cfg.proposals.n_train_pre_nms,
                n_post=cfg.proposals.n_train_post_nms,
                nms_thresh=cfg.proposals.nms_thresh,
                min_size=cfg.proposals.min_size, n_levels=n_levels)
            tracing.count("proposals_kept", props.valid)
            tracing.count("proposal_slots", props.valid.numel(), props.valid.device)
            tracing.stage("targets")
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
            # only positives carry mask or keypoint loss, and the sampler
            # puts them first: that branch runs on the (B, :n_pos_cap) prefix
            sample_pos = ProposalTargets(*(x[:, :n_pos_cap] for x in sample))
            if is_keypoint:
                targets = keypoint_targets(sample_pos, batch.gt_keypoints,
                                           mask_size=cfg.model.mask_size)
            else:
                targets = mask_targets(sample_pos, batch.gt_masks,
                                       batch.gt_boxes,
                                       mask_size=cfg.model.mask_size)
            cls_labels = torch.where(
                sample.valid, sample.labels, -1).reshape(-1)
            pos_flat = (sample_pos.is_pos & sample_pos.valid).reshape(-1)

        tracing.stage("heads")
        # the mask head's class-gathered final conv: each positive's
        # GT-class channel only
        class_idx = None if is_keypoint else (sample_pos.labels - 1).reshape(-1)
        roi_cls_locs, roi_scores, roi_masks = model.head_train(
            model.roi_features(features), sample.rois, sample.levels,
            n_pos_cap, class_idx)

        a = anchors.shape[0]
        b = rpn_locs.shape[0]
        rpn_loc_loss = L.fast_rcnn_loc_loss(
            rpn_locs.reshape(b * a, 4), at.locs.reshape(b * a, 4),
            at.labels.reshape(b * a), sigma=3.0, global_count=parallel)
        rpn_cls_loss = L.softmax_ce_ignore(
            rpn_scores.reshape(b * a, 2), at.labels.reshape(b * a), parallel)
        roi_loc_loss = L.fast_rcnn_loc_loss(
            L.select_roi_locs(roi_cls_locs, cls_labels),
            sample.locs.reshape(-1, 4), cls_labels, sigma=1.0,
            global_count=parallel)
        roi_cls_loss = L.softmax_ce_ignore(roi_scores, cls_labels, parallel)
        s = cfg.model.mask_size
        if is_keypoint:
            mask_loss = L.keypoint_ce_loss(
                roi_masks, targets.reshape(-1, targets.shape[-1]), pos_flat,
                parallel)
        else:
            mask_loss = L.sigmoid_mask_loss(
                roi_masks, targets.reshape(-1, s, s),
                sample_pos.labels.reshape(-1), pos_flat, parallel)
        total = (rpn_loc_loss + rpn_cls_loss + roi_loc_loss + roi_cls_loss
                 + mask_loss)
        counts = torch.stack([sample.valid.sum(),
                              (sample.is_pos & sample.valid).sum()])
        # the positives carry the mask or keypoint loss, on n_pos_cap slots
        tracing.count("mask_rois_pos", counts[1])
        tracing.count("mask_roi_slots", n_pos_cap * b, counts.device)
        return L.LossBreakdown(total, rpn_loc_loss, rpn_cls_loss,
                               roi_loc_loss, roi_cls_loss, mask_loss), counts

    def draw(state: TrainState, batch: Batch, n_anchor: int) -> SamplerDraws:
        """This rank's rows of the global sampler table, from the
        generator; ``batch`` gives the local batch and the GT slots."""
        b, n_gt = batch.gt_boxes.shape[-3:-1]
        dev = state.model.device
        n_cand = cfg.proposals.n_train_post_nms + n_gt
        rows = slice(rank * b, (rank + 1) * b)
        return SamplerDraws(
            torch.rand((b * world, 2, n_cand), generator=state.generator,
                       device=dev)[rows],
            torch.rand((b * world, 2, n_anchor), generator=state.generator,
                       device=dev)[rows])

    def body(state: TrainState, batch: Batch, draws: SamplerDraws, anchors,
             step_count) -> dict:
        """One step on device tensors: the part a CUDA graph captures. It
        reads the learning rate from ``step_count`` and advances it."""
        model = state.model
        b = batch.images.shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        micro = b // accum
        bds, counts = [], []
        synced = (batch_statistics_synced(model) if parallel
                  else contextlib.nullcontext())
        with torch.enable_grad(), synced:
            for i in range(accum):
                rows = slice(i * micro, (i + 1) * micro)
                bd, cnt = loss_fn(model, _map(lambda x: x[rows], batch),
                                  SamplerDraws(*(x[rows] for x in draws)),
                                  anchors)
                tracing.stage("backward")
                bd.loss.backward()
                bds.append(torch.stack(bd).detach())
                counts.append(cnt)
        tracing.stage("optimizer")
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
        bd = torch.stack(bds).mean(dim=0)
        count = torch.stack(counts).sum(dim=0)
        if parallel:
            totals = torch.cat([bd.double(), count.double()])
            dp.all_reduce_sum_(grads + [totals])
            bd, count = totals[:len(bds[0])].float(), totals[len(bds[0]):].long()
        state.optimizer.step(lr_on_device(cfg, step_count))
        step_count.add_(1)
        if parallel:
            dp.average_running_statistics(model)
        n_valid, n_pos = count
        return {**L.LossBreakdown(*bd)._asdict(), "n_valid_rois": n_valid,
                "n_pos_rois": n_pos}

    def advance(state: TrainState, n: int):
        """The host's side of ``n`` steps: the step count, and each group's
        ``lr`` as the record of the last rate used."""
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step + n - 1)
        state.step += n

    def train_step(state: TrainState, batch: Batch,
                   draws: SamplerDraws | None = None) -> dict:
        with tracing.span("train_call", state.step):
            dev = state.model.device
            anchors, step_count = device_state(dev)
            with tracing.span("train.stage"):
                batch = to_device(batch, dev)
            b = batch.images.shape[0]
            if b % accum != 0:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum_steps {accum}"
                    + (f" (global batch {cfg.train.batch_size} over {world} "
                       "ranks: the local batch must split evenly into "
                       "micro-batches)" if parallel else ""))
            with tracing.span("train.draws"):
                draws = (draw(state, batch, anchors.shape[0]) if draws is None
                         else to_device(SamplerDraws(*draws), dev))
            step_count.fill_(state.step)
            with (tracing.span("train.step"), tracing.stages(dev),
                  tuned_convolutions()):
                metrics = body(state, batch, draws, anchors, step_count)
            advance(state, 1)
            return metrics

    if chain == 1:
        return train_step

    graphs = {}  # device → the captured step of that device's state

    def chained(state: TrainState, batches: Batch,
                draws: SamplerDraws | None = None) -> dict:
        k = batches.images.shape[0]
        if k != chain:
            raise ValueError(f"batches hold {k} steps, the chain {chain}")
        dev = state.model.device
        pick = (lambda i: None) if draws is None else (
            lambda i: SamplerDraws(*(x[i] for x in draws)))
        if dev.type != "cuda":
            rows = [train_step(state, _map(lambda x: x[i], batches), pick(i))
                    for i in range(chain)]
            return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
        with tracing.span("train_call", state.step):
            anchors, step_count = device_state(dev)
            with tracing.span("train.stage"):
                batches = to_device(batches, dev)
            with tracing.span("train.draws"):
                if draws is None:  # eagerly, in the eager steps' order
                    per_step = [draw(state, batches, anchors.shape[0])
                                for _ in range(chain)]
                else:
                    draws = to_device(SamplerDraws(*draws), dev)
                    per_step = [SamplerDraws(*(x[i] for x in draws))
                                for i in range(chain)]
            graph = graphs.get(dev)
            step_count.fill_(state.step)
            rows = []
            if (graph is None or not graph.captured_for(state)
                    or graph.traced != tracing.is_on()):
                graphs.pop(dev, None)  # the last graph's pool goes first
                # the chain's first step runs eagerly and warms up the capture
                graph = graphs[dev] = GraphedStep(
                    body, state, _map(lambda x: x[0], batches), per_step[0],
                    anchors, step_count)
                rows.append(graph.first_metrics)
            for i in range(len(rows), chain):
                with tracing.span("train.replay", state.step + i):
                    graph.replay(_map(lambda x: x[i], batches), per_step[i])
                    # the graph's outputs hold until the next replay: copy
                    # them out
                    rows.append({key: v.clone() for key, v in graph.metrics.items()})
            with tracing.span("train.collect"):
                advance(state, chain)
                return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}

    return chained


class GraphedStep:
    """One train step captured into a ``torch.cuda.CUDAGraph``.

    Made by taking one real step eagerly (``first_metrics``) on a side
    stream, then capturing ``body`` on that stream against static copies
    of the batch and draws (``capture_s``, the ``capture`` span's seconds;
    ``traced``, whether tracing was on, when the capture also recorded the
    stage events, ``stages``, read for each replay). ``replay(batch, draws)`` copies its inputs into
    those buffers and replays, all queued on the current stream behind the
    work before it; ``metrics`` holds the last replay's results until the
    next replay. The launch counters of :data:`KERNELS` rise at capture,
    when nothing runs; the capture's counts are taken back and added again
    at every replay. The graph is bound to the tensors of the state it was
    captured with (parameters, buffers, gradients, momentum buffers):
    :meth:`captured_for` tells whether a state still has them.
    """

    def __init__(self, body, state: TrainState, batch: Batch,
                 draws: SamplerDraws, anchors, step_count):
        dev = anchors.device
        self.stream = torch.cuda.Stream(device=dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            with (tracing.span("train.step"), tracing.stages(dev),
                  tuned_convolutions()):
                self.first_metrics = body(state, batch, draws, anchors, step_count)
        self.batch = _map(torch.clone, batch)
        self.draws = SamplerDraws(*(x.clone() for x in draws))
        self.traced = tracing.is_on()
        with tracing.timed("capture", dev) as timed:
            self.graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            with torch.cuda.graph(self.graph, stream=self.stream):
                with tracing.stages(dev) as self.stages:
                    self.metrics = body(state, self.batch, self.draws, anchors,
                                        step_count)
            self.launches = take_back_launches(before)
            torch.cuda.current_stream(dev).wait_stream(self.stream)
        self.capture_s, self.captures, self.replays = timed.seconds, 1, 0
        self.state_id, self.tensors = id(state), self.fingerprint(state)

    @staticmethod
    def fingerprint(state: TrainState) -> tuple:
        model, opt = state.model, state.optimizer
        return tuple(
            [t.data_ptr() for t in model.parameters()]
            + [t.data_ptr() for t in model.buffers()]
            + [opt.state[p]["momentum_buffer"].data_ptr()
               for p in model.parameters() if p in opt.state])

    def captured_for(self, state: TrainState) -> bool:
        return id(state) == self.state_id and self.fingerprint(state) == self.tensors

    def replay(self, batch: Batch, draws: SamplerDraws):
        for static, x in zip(self.batch, batch):
            if static is not None:
                static.copy_(x, non_blocking=True)
        for static, x in zip(self.draws, draws):
            static.copy_(x, non_blocking=True)
        tracing.replaying(self.stages)
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
