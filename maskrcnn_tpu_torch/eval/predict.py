"""Two-pass inference: boxes first, then masks on the refined boxes (port of
``maskrcnn_tpu/eval/predict.py``, its native-gather path).

Pass 1 runs backbone, RPN, proposals and the box branch, decodes boxes
per class (loc · std + mean → loc2bbox → clip; one class-agnostic loc, or
each class's own for the Res5 head), and
keeps every (ROI, class) pair above ``score_thresh`` for an exact per-class
greedy NMS (every class of every image of the batch in one call). A global
top-``max_detections`` by score merges the classes. Pass 2 pools the
refined boxes — at the pass-1 ROI's level under ``mask_levels="pass1"`` —
and runs the class-gathered mask branch, or the keypoint branch, whose
56×56 heatmap logits come back as they are. Fixed shapes throughout:
detections live in ``max_detections`` padded slots with a validity mask.
Where fewer (class, box) pairs survive per-class NMS, by shape, than
there are slots (the viewer's one class keeps 10 of 100), pass 2 runs the
head only up to the first slot past them, which stands for every padding
slot after it (:func:`head_rows`).
With ``model.dtype="bfloat16"`` the convolutions and dense layers compute
in bf16 and the pools read bf16 features; the RPN outputs, proposals, NMS,
box decoding, scores and mask logits stay float32, as in the JAX package.

JAX jits the whole request into one program per input shape. On the card
the port serves a request as one CUDA graph per input signature (batch
size and image dtype at the function's image size), JAX's compile once per
shape: the signature's first request runs eagerly (the warm-up), its
second captures the request into a graph, and every request after that
replays the graph (:class:`GraphedPredict`). A replay runs only device
work, so a forward hook or a function patched into a module never runs in
it: code that hooks or patches the path calls ``predict.eager``, the same
request without the graph. On the CPU ``predict`` is ``predict.eager``.

With :mod:`maskrcnn_tpu_torch.utils.tracing` on, a request records the
spans ``predict`` (its id the function's call count) around
``predict.stage``, ``predict.check``, ``predict.replay`` and
``predict.clone``; the body marks the device stages ``backbone``,
``proposals``, ``box_head``, ``detections`` and ``mask_head`` and counts
its kept proposals, (class, ROI) pairs entering per-class NMS, valid
detections against their slots, and the rows pass 2's head runs on
(``head_rows``). A request served with tracing on replays
a graph captured with it on, kept apart from the untraced one.
"""

from __future__ import annotations

import itertools
import os
import traceback
from typing import NamedTuple

import torch

from maskrcnn_tpu_torch.config import Config
from maskrcnn_tpu_torch.kernels import add_launches, launch_counts, take_back_launches
from maskrcnn_tpu_torch.models.maskrcnn import (
    MaskRCNN,
    backbone_geometry,
    pyramid_shapes,
)
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals, top_k_stable
from maskrcnn_tpu_torch.ops.boxes import clip_boxes, loc2bbox
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels
from maskrcnn_tpu_torch.ops.nms import nms_padded
from maskrcnn_tpu_torch.utils import tracing
from maskrcnn_tpu_torch.utils.device import device_constant


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, D, 4) yxyx in network-input coords
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 0-based fg class
    valid: torch.Tensor  # (B, D) bool
    masks: torch.Tensor | None  # (B, D, S, S) sigmoid probs (the mask head)
    heatmaps: torch.Tensor | None  # (B, D, 56, 56, K) float32 logits (the
    #   keypoint head)


def decode_boxes(cfg: Config, rois, locs, probs, rvalid, img_hw):
    """One image: rois (R, 4), locs (R, 4) class-agnostic or (R, (C+1)·4)
    per class (the Res5 head), probs (R, C+1), rvalid (R,) → (cls_boxes
    (n_fg, R, 4), cls_scores (n_fg, R), cls_valid (n_fg, R))."""
    n_fg = cfg.model.n_fg_class
    mean = device_constant(cfg.sampler.loc_normalize_mean, torch.float32,
                           locs.device)
    std = device_constant(cfg.sampler.loc_normalize_std, torch.float32,
                          locs.device)
    hw = (img_hw[0], img_hw[1])
    if locs.shape[-1] == 4:
        boxes = clip_boxes(loc2bbox(rois, locs * std + mean), hw)
        cls_boxes = boxes[None].expand(n_fg, -1, -1)
    else:  # each foreground class's own loc, background's column dropped
        r = rois.shape[0]
        locs_fg = (locs.reshape(r, -1, 4)[:, 1:] * std + mean).transpose(0, 1)
        cls_boxes = clip_boxes(loc2bbox(
            rois[None].expand(n_fg, -1, -1).reshape(-1, 4),
            locs_fg.reshape(-1, 4)), hw).reshape(n_fg, r, 4)
    cls_scores = probs[:, 1:].T
    cls_valid = rvalid[None, :] & (cls_scores > cfg.eval.score_thresh)
    return cls_boxes, cls_scores, cls_valid


def merge_top(cls_boxes, cls_scores, roi_levels, keep_idx, keep_valid, d: int):
    """One image: the global top-``d`` kept (class, ROI) pairs by score →
    (boxes (d, 4), scores, labels int32, valid, pass-1 levels int32)."""
    n_fg, n_keep = keep_idx.shape
    keep_idx = keep_idx.long()
    kept = torch.gather(cls_scores, 1, keep_idx)
    kept = torch.where(keep_valid, kept, torch.full_like(kept, -float("inf")))
    kept = kept.reshape(n_fg * n_keep)
    if n_fg * n_keep < d:
        kept = torch.nn.functional.pad(kept, (0, d - n_fg * n_keep),
                                       value=-float("inf"))
    top_scores, top_i = top_k_stable(kept, d)
    det_valid = torch.isfinite(top_scores)
    safe_i = torch.where(det_valid, top_i, torch.zeros_like(top_i))
    label = torch.div(safe_i, n_keep, rounding_mode="floor")
    roi_idx = keep_idx.reshape(-1)[safe_i]
    det_boxes = cls_boxes[label, roi_idx]
    det_levels = roi_levels[roi_idx].to(torch.int32)
    det_scores = torch.where(det_valid, top_scores, torch.zeros_like(top_scores))
    det_labels = torch.where(det_valid, label, torch.zeros_like(label))
    return det_boxes, det_scores, det_labels.to(torch.int32), det_valid, det_levels


def image_index(b: int, n: int, device) -> torch.Tensor:
    """(b·n,) int32: each of b images' index n times, as
    ``repeat_interleave`` gives it, by a broadcast that no PyTorch version
    turns into a host sync."""
    return torch.arange(b, dtype=torch.int32, device=device)[:, None].expand(
        b, n).reshape(b * n)


def head_rows(d: int, n_kept: int) -> int:
    """The detection slots of an image that pass 2 computes: all ``d``, or,
    where only ``n_kept < d`` (class, box) pairs survive per-class NMS, the
    first ``n_kept + 1``. Slot ``n_kept`` is then padding in every request
    (at most ``n_kept`` scores are finite), and so is every slot after it,
    each the same detection: ``merge_top``'s first kept pair of class 0."""
    return d if n_kept >= d else n_kept + 1


def predict_masks(cfg: Config, model: MaskRCNN, roi_feats, det_boxes,
                  det_labels, det_levels, rows: int):
    """Pass 2: (B, D) detections → (masks, heatmaps): (B, D, S, S) sigmoid
    mask probs of each detection's class (S = 28 for the FPN mask head, 14
    for the light and Res5 heads) and None, or None and (B, D, 56, 56, K)
    heatmap logits for the keypoint head. ``roi_feats`` is
    ``model.roi_features(features)``. The head runs on each image's first
    ``rows`` slots (:func:`head_rows`); with ``rows < D`` the last of them
    fills the slots after it."""
    b, d = det_boxes.shape[:2]
    if rows < d:
        det_boxes, det_labels, det_levels = (
            t[:, :rows] for t in (det_boxes, det_labels, det_levels))
    flat_boxes = det_boxes.reshape(b * rows, 4)
    if cfg.eval.mask_levels == "pass1":
        flat_levels = det_levels.reshape(b * rows)
    else:
        flat_levels = map_rois_to_fpn_levels(flat_boxes, 0, len(roi_feats) - 1)
    flat_bi = image_index(b, rows, det_boxes.device)
    if cfg.model.head == "fpn_keypoint":
        heat = model.head_mask(roi_feats, flat_boxes, flat_bi, flat_levels)
        return None, _fill_slots(heat.reshape(b, rows, *heat.shape[1:]), d)
    logits = model.head_mask(roi_feats, flat_boxes, flat_bi, flat_levels,
                             det_labels.reshape(b * rows))
    masks = torch.sigmoid(logits).reshape(b, rows, *logits.shape[1:])
    return _fill_slots(masks, d), None


def _fill_slots(out: torch.Tensor, d: int) -> torch.Tensor:
    """(B, rows, ...) → (B, d, ...), the last row repeated into the rest."""
    b, rows = out.shape[:2]
    if rows == d:
        return out
    return torch.cat([out, out[:, -1:].expand(b, d - rows, *out.shape[2:])], 1)


def make_predict_fn(cfg: Config, model: MaskRCNN, image_size=None):
    """``predict(images, img_hw, scale) -> Detections`` on the model's device.

    images (B, H, W, 3) uint8 or float; img_hw (B, 2) true content size;
    scale (B,) resize scale. Arrays or tensors; moved to the model's device.
    Every call returns tensors of its own. On the card the second call of
    a signature captures a CUDA graph and later calls replay it (the
    module's docstring); ``predict.eager`` serves a request without the
    graph, ``predict.body`` is the captured part (device tensors in, no
    host work) and ``predict.graphs`` maps each signature and tracing
    flag to its :class:`GraphedPredict`.
    """
    h, w = image_size or cfg.train.image_size
    feat_strides, _ = backbone_geometry(cfg)
    feat_shapes = pyramid_shapes(cfg, (h, w))
    dev = model.device
    anchors = torch.as_tensor(anchors_for(cfg, feat_shapes, feat_strides),
                              device=dev)
    n_levels = len(feat_shapes)
    d = cfg.eval.max_detections
    # only the top-d kept boxes of a class can reach the global top-d
    n_keep_pc = min(cfg.proposals.n_test_post_nms, d)

    def body(images, img_hw, scale) -> Detections:
        """One request on the model's device: images (B, H, W, 3), img_hw
        (B, 2) and scale (B,) float32. It reads its inputs only through
        these tensors and never waits for the device."""
        b = images.shape[0]
        tracing.stage("backbone")
        features, rpn_locs, rpn_scores = model(images)
        tracing.stage("proposals")
        props = generate_proposals(
            rpn_locs, rpn_scores, anchors, scale, img_hw,
            n_pre=cfg.proposals.n_test_pre_nms,
            n_post=cfg.proposals.n_test_post_nms,
            nms_thresh=cfg.proposals.nms_thresh,
            min_size=cfg.proposals.min_size, n_levels=n_levels,
        )
        tracing.count("proposals_kept", props.valid)
        tracing.count("proposal_slots", props.valid.numel(), dev)
        tracing.stage("box_head")
        roi_feats = model.roi_features(features)
        r = props.rois.shape[1]
        batch_idx = image_index(b, r, dev)
        locs, roi_scores = model.head_box(
            roi_feats, props.rois.reshape(b * r, 4), batch_idx,
            props.levels.reshape(b * r))
        probs = torch.softmax(roi_scores, dim=-1).reshape(b, r, -1)
        locs = locs.reshape(b, r, -1)
        tracing.stage("detections")
        cls_boxes, cls_scores, cls_valid = (torch.stack(t) for t in zip(*(
            decode_boxes(cfg, props.rois[i], locs[i], probs[i],
                         props.valid[i], img_hw[i]) for i in range(b))))
        # every image's per-class NMS in one call: (B, n_fg) problems
        keep_idx, keep_valid = nms_padded(
            cls_boxes, cls_scores, cfg.eval.nms_thresh, n_keep_pc, cls_valid)
        det_boxes, det_scores, det_labels, det_valid, det_levels = (
            torch.stack(t) for t in zip(*(
                merge_top(cls_boxes[i], cls_scores[i], props.levels[i],
                          keep_idx[i], keep_valid[i], d) for i in range(b))))
        tracing.count("nms_candidates", cls_valid)
        tracing.count("detections_valid", det_valid)
        tracing.count("detection_slots", det_valid.numel(), dev)
        rows = head_rows(d, keep_idx.shape[1] * keep_idx.shape[2])
        tracing.count("head_rows", b * rows, dev)
        tracing.stage("mask_head")
        masks, heatmaps = predict_masks(cfg, model, roi_feats, det_boxes,
                                        det_labels, det_levels, rows)
        return Detections(det_boxes, det_scores, det_labels, det_valid, masks,
                          heatmaps)

    calls = itertools.count()  # the requests' ids

    def serve_eager(images, img_hw, scale) -> Detections:
        with tracing.stages(dev):
            return body(*request_tensors(images, img_hw, scale, dev))

    @torch.inference_mode()
    def eager(images, img_hw, scale) -> Detections:
        with tracing.span("predict.eager", next(calls)):
            return serve_eager(images, img_hw, scale)

    graphs: dict[tuple, GraphedPredict] = {}

    @torch.inference_mode()
    def predict(images, img_hw, scale) -> Detections:
        with tracing.span("predict", next(calls)):
            if dev.type != "cuda":
                return serve_eager(images, img_hw, scale)
            inputs = request_tensors(images, img_hw, scale)
            key = (tuple(inputs[0].shape), inputs[0].dtype, tracing.is_on())
            graph = graphs.get(key)
            if graph is None:
                graph = graphs[key] = GraphedPredict(body, dev, inputs)
                return graph.warm_up(inputs)
            return graph.replay(inputs, model)

    predict.eager, predict.body, predict.graphs = eager, body, graphs
    return predict


def request_tensors(images, img_hw, scale, device=None):
    """A request's arrays or tensors as tensors (img_hw and scale float32),
    on ``device`` when given, else where they are."""
    return (torch.as_tensor(images, device=device),
            torch.as_tensor(img_hw, dtype=torch.float32, device=device),
            torch.as_tensor(scale, dtype=torch.float32, device=device))


class ModelTensors:
    """Where a model's parameters and buffers live, as a graph captured
    from it reads them. :meth:`moved` tells whether any of them has moved
    since: a parameter or buffer replaced by another tensor (or given
    other storage through ``.data``), or a submodule replaced. It looks up
    the slots found at construction: walking the module tree again at
    every request is most of the cost of such a check for a model of a few
    hundred modules, and the device waits for it."""

    def __init__(self, model):
        modules = list(model.modules())
        self.children = [(m._modules, name, child) for m in modules
                         for name, child in m._modules.items()]
        self.slots = [(d, name) for m in modules for d in (m._parameters, m._buffers)
                      for name, t in d.items() if t is not None]
        self.pointers = self._pointers()

    def _pointers(self) -> tuple:
        return tuple(d[name].data_ptr() for d, name in self.slots)

    def moved(self) -> bool:
        try:
            return (any(d.get(name) is not child for d, name, child in self.children)
                    or self._pointers() != self.pointers)
        except (KeyError, AttributeError):  # a tensor deleted or set to None
            return True


class GraphedPredict:
    """One request signature's predict as a ``torch.cuda.CUDAGraph``.

    ``warm_up(inputs)`` serves the signature's first request eagerly on a
    side stream: cuBLAS, cuDNN, the kernels' libraries, the allocator and
    the device constants are set up there before anything is captured.
    ``capture(model)`` records ``body`` on that stream against static
    input buffers, in a memory pool of the graph's own (``reserved_bytes``,
    ``capture_s``, the ``capture`` span's seconds). With tracing on, the
    capture records the body's stage events into the graph (``stages``),
    read for each replay. ``replay(inputs, model)`` copies a request into the
    buffers (a host array through a pinned buffer of the graph's own, so
    that the copy does not wait for the device), captures first if the
    model's tensors have moved, replays and returns clones of the outputs,
    so that no two requests' results share memory; all of it queued on the
    current stream behind the work before it.

    The launch counters of :data:`maskrcnn_tpu_torch.kernels.KERNELS` rise
    at capture, when nothing runs; the capture's counts are taken back and
    added again at every replay. The graph is bound to the tensors of the
    model it was captured with: an optimizer step or ``load_state_dict``
    writes into them in place and a replay reads the new values, while a
    parameter replaced by another tensor needs a new capture
    (:class:`ModelTensors`). A capture that fails raises naming the
    operation; nothing falls back to eager.
    """

    def __init__(self, body, device, inputs):
        self.body, self.device = body, device
        self.stream = torch.cuda.Stream(device=device)
        self.static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                            for x in inputs)
        self.pinned = tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                            for x in inputs)
        self.staged = torch.cuda.Event()  # the last copy out of ``pinned``
        self.graph = self.outputs = self.tensors = self.stages = None
        self.launches = [0] * len(launch_counts())
        self.captures = self.replays = 0
        self.capture_s = self.reserved_bytes = None

    def _stage(self, inputs):
        """Each input into its static buffer on the current stream; a host
        array goes through ``pinned`` once the last copy out of it ran."""
        with tracing.span("predict.stage"):
            self.staged.synchronize()
            for static, pinned, x in zip(self.static, self.pinned, inputs):
                if x.device.type == "cpu":
                    x = pinned.copy_(x)
                static.copy_(x, non_blocking=True)
            self.staged.record()

    def warm_up(self, inputs) -> Detections:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self._stage(inputs)
            with tracing.stages(self.device):
                det = self.body(*self.static)
        current.wait_stream(self.stream)
        for t in det:
            if t is not None:  # made on the side stream, read on this one
                t.record_stream(current)
        return det

    def capture(self, model):
        self.graph = self.outputs = self.stages = None  # the last graph's
        #   pool goes first
        with tracing.timed("capture", self.device) as timed:
            graph = torch.cuda.CUDAGraph()
            before = launch_counts()
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            try:
                with torch.cuda.graph(graph, stream=self.stream):
                    reserved = torch.cuda.memory_reserved(self.device)
                    with tracing.stages(self.device) as stages:
                        outputs = self.body(*self.static)
            except RuntimeError as err:
                take_back_launches(before)
                raise RuntimeError(
                    "predict: capturing the request into a CUDA graph failed at "
                    f"{_where(err)}: a replay cannot wait for the host or copy "
                    "host data (no .item(), no tensor built from host values; "
                    "constants through utils/device.py:device_constant)") from err
            self.launches = take_back_launches(before)
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
            self.reserved_bytes = torch.cuda.memory_reserved(self.device) - reserved
            self.graph, self.outputs, self.tensors = graph, outputs, ModelTensors(model)
            self.stages = stages
            self.captures += 1
        self.capture_s = timed.seconds

    def replay(self, inputs, model) -> Detections:
        self._stage(inputs)  # the copies run while the host checks the model
        with tracing.span("predict.check"):
            stale = self.graph is None or self.tensors.moved()
        if stale:
            self.capture(model)
        with tracing.span("predict.replay"):
            tracing.replaying(self.stages)
            self.graph.replay()
        add_launches(self.launches)
        self.replays += 1
        with tracing.span("predict.clone"):
            return Detections(*(None if t is None else t.clone()
                                for t in self.outputs))


def _where(err: BaseException) -> str:
    """The first error of ``err``'s chain at its innermost frame outside
    torch: the operation a capture could not take."""
    while err.__context__ is not None:
        err = err.__context__
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(torch_dir)]
    f = frames[-1] if frames else None
    site = f"{f.filename}:{f.lineno} ({f.line})" if f else "?"
    return f"{site}: {type(err).__name__}: {err}"
