#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``maskrcnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--against OTHER/roi_align_fwd.cu]

Phases, in order; any failure exits non-zero before the result is printed:

1. device: require CUDA, print the torch build and the card; TF32 off for
   matmul and cuDNN, so the card computes in float32 like the CPU;
2. build: compile every hand-written kernel from the sources in this
   checkout with ``nvcc`` (sm_90a), one compiler per source, all at once;
3. kernels against their plain versions on the card, at the shapes of the
   main paths: the ROIAlign forward on an 800×1024 pyramid (C=256) at batch
   1 and 2, 300 ROIs at 7×7 and 100 at 14×14, in the region and the
   pallas window geometry, f32 and bf16 features, also against the banded
   step-by-step version of the kernel's arithmetic; the region scatter on
   the cotangent windows of 512 and 2048 train ROIs (20×32 windows, C=256)
   over the pyramids of batch 2 and 8, in each (input, accumulator) dtype
   pair the config can produce, and with its plain version against the
   float64 exact sum, element by element within the rounding bound of that
   pair (``region_scatter_exact``), equal bit for bit to
   ``region_scatter_ordered`` (its adds in the kernel's order) and to
   itself on a second call. ROIs lie on all five levels, many on one
   object, some with windows that run past the end of the buffer; the
   ROIs per level and the most terms on one output row are printed. At
   the C4 family's shapes too: one 50×64 level at C=1024 and at C=490
   padded to 512, 300 request ROIs and 512 train ROIs in the pallas window
   geometry, with how far the pallas pool lies from the gather form on
   ROIs wider than its window;
4. the serving path: ``fpn_mask`` at full width (ResNet-50-FPN, 80 classes,
   800×1024, batch 1, seeded random weights, class scores spread to a
   chosen load that fills every detection slot) serves synthetic requests
   through ``make_predict_fn``; every kernel's launch count is read around
   that run; one request is served again on the CPU (plain versions) and
   must agree. Then ``predict-graph``, here and in phases 7, 12, 16 and 17
   (every preset served with 8 requests): one eager request under
   ``torch.cuda.set_sync_debug_mode("error")``; a fresh predict function's
   first call (eager), second (the capture of a CUDA graph of the request)
   and replays; the launches of a replay equal an eager request's (B2 2 on
   the FPN presets, none under the single-level gather form; NMS 2); the
   same requests served by ``predict.eager`` and by replays in turns, equal
   in every bit (``valid``, ``labels``, boxes, scores, masks or heatmaps),
   with p50/p90 of both, the capture's seconds and its pool's reserved
   GiB; two replayed results held at once, each its own request's; the
   class-score weight replaced by another tensor (a new capture, equal to
   eager) and then scaled in place (no capture, the replay follows it).
   Phases that hook or patch the path (the kernel inputs kept from request
   0, ``passing_pairs``, ``Proposals``) call ``predict.eager``: a replay
   runs no Python;
5. the train path: the same model at batch 2 takes one warm-up step and
   three counted steps on synthetic batches through ``make_train_step``
   (12000/2000 proposals, 256 sampled ROIs per image); the launch counts
   are read around the three steps (forward kernel 2 per step, region
   scatter 1 per step, NMS 1 per step: both images' proposals in one
   call), every loss term must be finite and every parameter,
   frozen-BN scales included, must have moved;
6. one train step from the same weights, batch and sampler draws on the card
   and on the CPU (plain versions), at full width on a 256×320 canvas with
   1000/256 proposals: losses and parameter updates must agree;
7. the serving path in bfloat16 (``model.dtype="bfloat16"``): requests as in
   phase 4, launch counts read around them;
8. the train path in bfloat16 with trainable BatchNorm
   (``model.freeze_bn=False``), as in phase 5: launch counts, finite
   losses, every parameter and every BatchNorm running statistic moved;
9. bfloat16 on the card against the CPU, at 256×320: one request and one
   train step (trainable BN, the RPN's shared conv zeroed so that every run
   samples the same ROIs) in bf16 on the card, in bf16 on the CPU and in
   float32 on the CPU; the card's distance from the CPU's float32 must stay
   within twice the CPU bf16's own distance from it, plus a floor;
10. the evaluation path: request 0's masks pasted (``paste_masks``) on the
   card and on the CPU at 800×1024, pixel for pixel; then
   ``evaluate_dataset`` (VOC and COCO mask AP) over 4 synthetic 800×1024
   batches with the serving model, launch counts read around it (2 forward
   launches a batch), seconds per image with the scorers' share;
11. the CLIs, in this process and a temporary directory: ``cli.train`` at
   256×320 b2 (80 classes), 4 steps, snapshots at 2 and 4, an evaluation at
   4; the same run resumed from step 2 (losses of steps 3 and 4 within 1e-3
   relative); ``cli.evaluate`` on the step-4 checkpoint (the in-run report
   and detections within 1e-6); launch counts around each;
12. the keypoint serving path: ``fpn_keypoint`` at full width (8 head convs
   of 256, 17 keypoints, 56² heatmaps) at 800×1024 b1 serves requests as in
   phase 4 (2 forward launches a request), one request again on the CPU:
   equal ``valid``/``labels``, boxes, scores and heatmaps within the same
   tolerance, decoded keypoints within it of the box size but at heatmap
   ties;
13. the keypoint train path: 1 + 3 full-width b2 steps at 800×1024 as in
   phase 5 (2 and 1 launches a step), and one 256×320 step on the card
   against the CPU as in phase 6;
14. keypoint evaluation: ``evaluate_keypoint_dataset`` (OKS AP) over 4
   synthetic 800×1024 images, 2 forward launches a batch, seconds an image;
15. COCO-format data through the CLIs, in a temporary directory written
   from the seed (PNG images, landscape and portrait; polygon, compressed
   and uncompressed RLE masks; a crowd annotation; sparse category ids;
   people with keypoints): ``cli.train --dataset coco --buckets
   256x320,320x256`` for ``fpn_mask`` (4 steps, resumed from step 2) and
   ``fpn_keypoint`` (2 steps), each with an in-run evaluation, then
   ``cli.evaluate --dump-results``: the report equals the in-run one, every
   ``segm`` decodes to the mask the export pasted, boxes lie in the
   original images, category ids are the file's, keypoint entries hold
   17 × 3 numbers; launches counted by path and bucket shape, and both
   kernels must run at both shapes; the first portrait step's kernel inputs
   are kept for phase 17;
16. the C4 family, ``light_head`` (``lh``) and ``c4_res5`` (``c4``) at
   full width (ResNet-50 to res4, 80 classes, 14×14 masks): 8 requests at
   800×1024 b1 (6000/300 proposals, class scores spread) and one again on
   the CPU, held as in phase 4 from the same proposals (``Proposals``: the
   one level's tied RPN scores; the slots the card's own proposals share
   with the CPU's are printed); 1 + 3 train steps at 800×1024 b2
   (12000/2000 proposals, 256 ROIs an image) as in phase 5, every parameter
   moving; one 256×320 step on the card against the CPU as in phase 6, from
   the same proposals (``c4_res5`` with fewer sampled ROIs, printed); their
   default pool on one level is
   the gather form, which launches no kernel. Then ``roi_align="pallas"``:
   one request and one step each, B2 2 a request and 2 a step, B1 2 a
   step (the box pool and the mask pool, each its own backward); and the
   CLIs as in phase 11 with ``--preset``;
17. the Darknet family, ``tiny_test`` (``tt``, the mask head, 128×160) and
   ``darknet_keypoint`` (``dk``, the 20-keypoint head, 256×320, the
   viewer's model): both kernels at their shapes first (one 16×20 level of
   256 channels, a 24-cell pallas window; B2 on 10 and 2048 ROIs, B1 on
   2048 train windows, bit for bit against ``region_scatter_ordered``);
   then for each preset 8 requests b1 (``dk`` under ``visualize``, score
   0.7, its class-score layer given a chosen load that clears it), 1 + 3
   train steps at its own batch (b2, b8), one step card vs CPU, each from
   the same proposals, the Darknet BatchNorms' statistics moving under
   ``freeze_bn=True``, and one ``roi_align="pallas"`` request (B2 2) and
   step (B2 2, B1 2); OKS evaluation of 2 ``dk`` batches; ``cli.train
   --dataset depth`` on a generated manifest (train 4, resume from 2, the
   in-run report against a direct evaluation) and ``cli.viewer --image``
   on one of its frames with that checkpoint (``--benchmark 30``: the
   card's frames per second); ``tt``'s CLIs as in phase 11 at 128×160 and
   ``cli.demo`` writing 4 overlays from the step-4 checkpoint;
18. data parallelism over gloo on the one card (``dp-gloo``): two
   processes (``parallel.data_parallel.spawn_ranks``) take one step of
   ``fpn_mask`` at 800×1024 (global b2, one image a rank) and of
   ``darknet_keypoint`` at 256×320 (global b8, four a rank, its BatchNorms
   training through sync-BN), rank 0's weights broadcast, the RPN's shared
   conv zeroed; losses and updates held to the 1-process step on the card
   from the same weights and sampler seed as phase 6 holds the card to the
   CPU, BatchNorm statistics within ``DP_STATS_TOL``, parameters equal in
   bits on both ranks; each rank's B2 and B1 counts (2 and 1 for the FPN
   pair); then two more steps each for the per-rank step time (two ranks
   share the card: no scaling number);
19. ``dp-nccl``: ``cli.train --data-parallel`` under ``torchrun
   --nproc_per_node 1`` (one NCCL rank) on ``tiny_test`` for 4 steps,
   resumed from step 2, against the same run without ``--data-parallel``;
20. ``pretrained``: an npz emitted in chainer's layout for each backbone
   (``fpn_mask``, ``c4_res5``, ``tiny_test``) loaded loosely on the card
   and on the CPU, equal bit for bit, then one request with it on the card;
21. ``diag``: ``tools/diag_checkpoint.py`` on phase 11's step-4 checkpoint
   (B2 5, B1 1), and ``cli.train --profile-dir`` on ``tiny_test`` for 21
   steps under ``roi_align="pallas"`` and ``--steps-per-dispatch 1``: the
   trace of steps 11-20 holds 20 launches of each kernel;
22. chained dispatch (``chain``, ``chain-dk``): ``make_train_step(cfg,
   chain=4)`` on ``fpn_mask`` at 800×1024 b2 and ``darknet_keypoint`` at
   256×320 b8 (its BatchNorms' running statistics moving inside the
   graph), an eager step, the capture of a CUDA graph of the step and three
   replays, against four eager steps from a copy of the same state: under
   deterministic algorithms equal in every bit (losses, parameters,
   buffers, momentum, the sampler generator); launch counts with the
   replays (``fpn_mask``: B2 8, B1 4, NMS 4); eager and graphed steps timed
   in turns; one ``fpn_mask`` eager step under
   ``torch.cuda.set_sync_debug_mode("error")``;
23. ``chain-cli``: ``cli.train`` at its default K on the card (``fpn_mask``
   256×320 b2, 8 steps, logs and snapshots every 4: K=4), resumed from step
   4, and with ``--steps-per-dispatch 1``, under deterministic algorithms:
   the logged losses and the resumed step equal bit for bit, with the
   launches of every replayed step;
24. ``bench-validate``: the bench's train line (``bench.bench_train``, in
   this process, ``BENCH_STEPS`` timed steps) on ``fpn_mask`` 800×1024 b2
   in float32 and in bfloat16 and on ``darknet_keypoint`` 256×320 b8, with
   its self-validation keys printed: ``step_flops`` must be positive and
   ``implied_mfu`` in (0, ``MFU_SUSPECT_BOUND``]; the launches of its timed
   steps are those of phase 5 (none of B2 and B1 under ``darknet_keypoint``'s
   gather pool); a slow or clock flag is printed with its reason. Then the
   FLOP count of one ``tiny_test`` step on the card, under
   ``set_sync_debug_mode("error")``, must equal the CPU's from the same
   weights and batch;
25. the kernels line: each kernel on the inputs the main paths gave it,
   held against its plain version, with both times, its bound (for the
   ROIAlign forward the work these inputs need, with the dense count beside
   it) and, where one PyTorch call computes the same function, that call's
   time; the region scatter's bookkeeping (the sort of its window rows) is
   timed alone beside it, the matrix products that build its input too, and
   ``torch.profiler`` lists the device kernels of one region-scatter call in
   each dtype pair with their device times. The NMS kernel is held against
   its plain version (the Jacobi loop) on request 0's two calls (the RPN's
   6000 boxes, per-class NMS over 80 classes × 300 proposals), the warm-up
   step's one (two images of 12000 boxes), the first of its images alone
   (P=1) and the RPN's call of an ``fpn_mask`` 800×1024 b8 batch (P=8, the
   JAX bench's train batch): keep masks equal up to the ``n_out``-th kept
   box, so equal ``(indices, valid)``, timed beside the bound of the pairs
   these inputs need, the mask pass and the walk also timed apart, with
   the walk's steps and microseconds a step. The launches of the
   evaluations and CLIs of phases 10, 11 and 17 and of phases 18-23 (each
   DP rank's own counts) are counted in (``launches_by_path``); every phase
   that predicts or trains checks NMS's count too (once a batch in the RPN,
   once a batch in predict's per-class NMS). With ``--against``, the
   ROIAlign forward source of another checkout (same C interface) is built too and timed on the same
   inputs in the order other, this, this, other.

The last three lines of standard output are the card's name and power limit,
the kernels JSON line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.metadata
import importlib.util
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from maskrcnn_tpu_torch import bench
from maskrcnn_tpu_torch.bench import (
    class_score_layer,
    passing_pairs,
    percentile,
    predict_config,
    spread_class_scores,
    time_in_turns,
    time_requests,
    time_train_proposals,
    time_train_steps,
)
from maskrcnn_tpu_torch import config as cfg_lib
from maskrcnn_tpu_torch.cli import demo as demo_cli
from maskrcnn_tpu_torch.cli import evaluate as evaluate_cli
from maskrcnn_tpu_torch.cli import train as train_cli
from maskrcnn_tpu_torch.cli import viewer as viewer_cli
from maskrcnn_tpu_torch.data import _native as coco_native
from maskrcnn_tpu_torch.data import coco as coco_mod
from maskrcnn_tpu_torch.data.coco_synthetic import write_coco
from maskrcnn_tpu_torch.data.depth import DepthKeypointDataset
from maskrcnn_tpu_torch.data.depth_synthetic import write_depth
from maskrcnn_tpu_torch.data.synthetic import (
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval import evaluator
from maskrcnn_tpu_torch.eval import export as export_mod
from maskrcnn_tpu_torch.eval.postprocess import decode_keypoints, paste_masks
from maskrcnn_tpu_torch.eval import predict as predict_mod
from maskrcnn_tpu_torch.eval.predict import make_predict_fn
from maskrcnn_tpu_torch.kernels import nms_cuda, region_scatter_cuda, roi_align_cuda
from maskrcnn_tpu_torch.kernels.build import nvcc_path
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN, pyramid_shapes
from maskrcnn_tpu_torch.ops import nms as nms_ops
from maskrcnn_tpu_torch.ops import roi_align as roi_align_ops
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels
from maskrcnn_tpu_torch.parallel import data_parallel as dp
from maskrcnn_tpu_torch.tools import diag_checkpoint
from maskrcnn_tpu_torch.train import step as step_mod
from maskrcnn_tpu_torch.train.state import create_train_state
from maskrcnn_tpu_torch.train.step import SamplerDraws, make_train_step
from maskrcnn_tpu_torch.utils.chainer_npz import emit_model_npz
from maskrcnn_tpu_torch.utils.convert_chainer import load_pretrained_npz
from maskrcnn_tpu_torch.utils.device import card_name_and_power_limit
from maskrcnn_tpu_torch.utils.peaks import H100_SXM

HBM_BYTES_PER_S = H100_SXM.hbm_bytes_per_s  # the bounds' peaks (utils/peaks.py)
F32_FLOPS = H100_SXM.float32
F32_TOL = 1e-5  # kernel vs plain, max abs / max |plain|: summation order
#   (the ROIAlign forward contracts Bx first, the plain version By first)
BF16_TOL = 1e-2  # bf16 features, same measure
F32, BF16 = torch.float32, torch.bfloat16
# the region scatter's (d_regs dtype, accumulator) pairs; each is held to
# region_scatter_exact's per-element rounding bound (scatter_check)
SCATTER_PAIRS = [(F32, F32), (BF16, F32), (BF16, BF16), (F32, BF16)]
BF16_FLOOR = 2e-3  # bf16 card vs CPU: the card's distance from the CPU's
#   float32 ≤ 2 × the CPU bf16's own distance + this, of max |float32|
SLICE_TOL = 1e-3  # GPU vs CPU request: max abs / max(1, max |CPU|)
TRAIN_LOSS_TOL = 1e-3  # GPU vs CPU train step, each loss term, relative:
#   ~60 layers of float32 sums in another order, forward
TRAIN_UPDATE_TOL = 5e-3  # each tensor's update, as a share of the largest
#   update of the step (the same again backward, and a weight difference)
TRAIN_OWN_TOL = 5e-2  # and as a share of the same tensor's largest update,
#   beyond two float32 roundings of its largest weight (an activation a
#   rounding away from zero passes a ReLU on one side only)
BUSY_CYCLES = 2_000_000  # spin ahead of a timed run: about 1.1 ms at 1.8 GHz
SCATTER_BUSY = 8 * BUSY_CYCLES  # the region scatter's wrapper also sorts and
#   allocates: up to ~400 µs of host time a call stays hidden
N_REQUESTS = 8  # served through the predict path, after one warm-up request
N_TRAIN_STEPS = 3  # taken through the train path, after one warm-up step
N_EVAL_BATCHES = 4  # evaluated at 800x1024 b1 through evaluate_dataset
FLIP_BAND = 1e-5  # a pasted pixel that differs between card and CPU lies
#   within this of 0.5 on the CPU ...
FLIP_SHARE = 1e-5  # ... and at most this share of pasted pixels differs
CLI_LOSS_TOL = 1e-3  # resumed CLI run vs uninterrupted, each loss, relative
#   (cuDNN's backward need not repeat bit for bit; B1 and B2 do)
CLI_REPORT_TOL = 1e-6  # cli.evaluate vs the in-run report, each field
SOFTMAX_UNSEEN = ("head.mask.deconv1.bias", "head.mask.conv2.bias")  # the
#   keypoint head's: a constant on all 56² bins of a keypoint, which its
#   softmax cannot see, so their gradients are rounding noise
BF16_SETTINGS = dict(dtype="bfloat16")  # phases 7 and 9's serving
BF16_TRAIN_SETTINGS = dict(dtype="bfloat16", freeze_bn=False)  # 8 and 9
N_KP_EVAL_BATCHES = 4  # keypoint evaluation at 800x1024 b1
COCO_SIZES = [(240, 320), (320, 240), (256, 300), (300, 256), (224, 320),
              (320, 224), (250, 310), (310, 250)]  # landscape and portrait
COCO_BUCKETS = "256x320,320x256"
C4_PRESETS = {"lh": "light_head", "c4": "c4_res5"}  # tag prefix: preset
C4_SHAPE = (50, 64)  # the C4 level of an 800x1024 image
PALLAS = dict(roi_align="pallas")  # the presets' pools through B2 and B1
DARKNET = {"tt": ("tiny_test", (128, 160), 2, "evaluate"),
           "dk": ("darknet_keypoint", (256, 320), 8, "visualize")}  # tag
#   prefix: (preset, its own image size and train batch, predict's preset:
#   the viewer's model serves under visualize)
DARKNET_LEVEL = (16, 20)  # the Darknet level of a 256x320 image, C=256
N_DK_EVAL_BATCHES = 2  # darknet_keypoint OKS evaluation at 256x320 b1
N_VIEWER_FRAMES = 30  # the viewer's --benchmark frames
DP_GLOO = {"dp-gloo": ("fpn_mask", (800, 1024), 2),
           "dp-gloo-dk": ("darknet_keypoint", (256, 320), 8)}  # tag: (preset,
#   size, global batch) of the 2-process gloo step on the one card
DP_TIMED_STEPS = 2  # per-rank steps timed after the compared one
DP_STATS_TOL = 1e-4  # 2-rank vs 1-process running statistics, of
#   max(1, |statistic|): sync-BN sums two ranks' float32 partial sums
C4_CPU_SAMPLES = {"c4_res5": 64}  # sampled ROIs an image of the card-vs-CPU
#   step: res5 and the 2048-wide 3x3 conv run on every ROI, about 5 GFLOP a
#   ROI forward, so the CPU's step grows with the ROIs it samples

ROI_ALIGN = roi_align_cuda.roi_align_fwd
SCATTER = region_scatter_cuda.region_scatter
NMS = nms_cuda.nms_greedy
# every hand-written kernel of the main paths: (wrapper, plain version,
# source, the TPU code it replaces: a Pallas kernel, or for NMS, which JAX
# computes in XLA ops, the Jacobi while_loop)
KERNELS = [
    (ROI_ALIGN, roi_align_cuda.roi_align_region_plain,
     "maskrcnn_tpu_torch/kernels/csrc/roi_align_fwd.cu",
     "maskrcnn_tpu/kernels/roi_align_pallas.py:116"),
    (SCATTER, region_scatter_cuda.region_scatter_plain,
     "maskrcnn_tpu_torch/kernels/csrc/region_scatter.cu",
     "maskrcnn_tpu/kernels/region_scatter_pallas.py:121"),
    (NMS, nms_cuda.nms_keep_plain,
     "maskrcnn_tpu_torch/kernels/csrc/nms_greedy.cu",
     "maskrcnn_tpu/ops/nms.py:128"),
]
NMS_CALLS = {}  # path → the NMS kernel's inputs there (request 0, the
#   warm-up step), for the kernels phase
BENCH_VALIDATE = [("fpn_mask", "float32", {ROI_ALIGN.name: 2, SCATTER.name: 1}),
                  ("fpn_mask", "bfloat16", {ROI_ALIGN.name: 2, SCATTER.name: 1}),
                  ("darknet_keypoint", "float32",
                   {ROI_ALIGN.name: 0, SCATTER.name: 0})]  # the bench's
#   train line at the preset's own size and batch: (preset, dtype, B2 and B1
#   launches a step; NMS 1 on each)
BENCH_STEPS = 10  # the bench's timed steps, and its back-to-back ones
BENCH_KEYS = ("step_flops", "implied_tflops_per_sec", "implied_mfu",
              "step_ms_chained", "step_ms_p50", "final_loss", "vs_baseline",
              "expected_step_ms")  # the self-validation's keys, printed
CHAIN_K = 4  # steps a chained call in the chain phases
CHAIN = {"chain": ("fpn_mask", (800, 1024), 2),
         "chain-dk": ("darknet_keypoint", (256, 320), 8)}  # tag: (preset,
#   size, batch) of the chained step held against eager steps


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, runs: int = 21, calls: int = 10, busy: int = BUSY_CYCLES) -> float:
    """Median over ``runs`` of the CUDA-event time per call of ``calls``
    back-to-back calls, after warm-up. Each run first keeps the card busy
    for about a millisecond (``torch.cuda._sleep``), so the host enqueues
    all the calls meanwhile and the events time the kernels alone: a
    wrapper's Python takes 30 to 50 microseconds a call, more than a short
    kernel, and events around calls that the card has to wait for would
    time the Python."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(busy)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def roi_align_bound(flat, base, stride, by, bx) -> dict:
    """Bound of one ROIAlign forward on these inputs, in ms
    (:func:`roi_align_cuda.roi_align_work`): the pyramid rows that a nonzero
    weight reaches, the geometry and weights read once and the output
    written once, over the memory rate; the FLOPs of the nonzero weights in
    the cheaper contraction order over the f32 peak; and the dense count of
    both (whole windows, two dense contractions) beside them."""
    work = roi_align_cuda.roi_align_work(flat, base, stride, by, bx)
    return {"bytes_ms": 1e3 * work["bytes"] / HBM_BYTES_PER_S,
            "ops_ms": 1e3 * work["flops"] / F32_FLOPS,
            "dense_bytes_ms": 1e3 * work["dense_bytes"] / HBM_BYTES_PER_S,
            "dense_ops_ms": 1e3 * work["dense_flops"] / F32_FLOPS,
            "reached": work["reached_elements"] / work["window_elements"]}


def region_scatter_bound(d_regs, base, stride, s_rows, acc_dtype=F32) -> dict:
    """Bound of one region scatter on these inputs, in ms: the cotangent
    windows and their geometry read once and the (s_rows, C) output, in the
    windows' dtype, written once, over the memory rate; one add per window
    element over the f32 peak."""
    c = d_regs.shape[-1]
    n_bytes = (d_regs.numel() * d_regs.element_size() + 8 * base.numel()
               + s_rows * c * d_regs.element_size())
    return {"bytes_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
            "ops_ms": 1e3 * d_regs.numel() / F32_FLOPS}


def index_add_ms(d_regs, base, stride, s_rows, acc_dtype=None) -> float:
    """The one PyTorch call that computes the region scatter: ``index_add_``
    of the flattened windows on precomputed row indices, into an output of
    the windows' dtype (so it sums in that dtype, whatever the kernel call's
    ``acc_dtype``)."""
    r, t, tx, c = d_regs.shape
    rows = region_scatter_cuda.scatter_rows(base, stride, t, tx, s_rows).reshape(-1)
    out = torch.zeros((s_rows + 1, c), dtype=d_regs.dtype, device=d_regs.device)
    src = d_regs.reshape(-1, c)
    return time_ms(lambda: out.index_add_(0, rows, src))


def scatter_check(got, want, args, label: str) -> dict:
    """Hold a region scatter's output ``got`` and its plain version's
    ``want`` (both from ``args``) to the float64 exact sum: every element of
    both within :func:`region_scatter_cuda.region_scatter_exact`'s rounding
    bound, and, with a bf16 accumulator (whose bound grows with the square
    of the windows that meet on an element), the kernel's mean error at
    most twice the plain version's (the same rounded adds in another
    order). The kernel's bookkeeping must equal a stable ``torch.sort`` of
    the window rows' starts, and the kernel must equal
    :func:`region_scatter_cuda.region_scatter_ordered` (the same adds in
    the same order) bit for bit, and a second call of the kernel its first.
    Returns the kernel's max and mean error and the plain version's mean
    error, as shares of max |exact|, and the largest share of its bound
    that an element's error takes."""
    d_regs, base, stride, s_rows, _ = args
    t, tx = d_regs.shape[1:3]
    got_start, tbase = SCATTER.sorted_segments(base, stride, t, tx, s_rows)
    start, order = torch.sort(region_scatter_cuda.segment_starts(
        base, stride, t, tx, s_rows), stable=True)
    if not (torch.equal(got_start, start)
            and torch.equal(tbase, (order * tx - start).int())):
        fail(f"region_scatter on {label}: the kernel's sort of the window rows "
             f"differs from torch.sort's")
    ordered = region_scatter_cuda.region_scatter_ordered(*args)
    if not torch.equal(got, ordered):
        diff = int((got != ordered).sum())
        fail(f"region_scatter on {label}: {diff} elements differ from "
             f"region_scatter_ordered")
    if not torch.equal(got, SCATTER(*args)):
        fail(f"region_scatter on {label}: a second call gave other bits")
    exact, bound = region_scatter_cuda.region_scatter_exact(*args)
    err = (got.double() - exact).abs()
    plain_err = (want.double() - exact).abs()
    scale = max(float(exact.abs().max()), 1e-30)
    out = dict(err=float(err.max()) / scale, mean=float(err.mean()) / scale,
               plain_mean=float(plain_err.mean()) / scale,
               share=float(torch.where(bound > 0, err / bound, err).max()))
    if not bool((plain_err <= bound).all()):
        fail(f"region_scatter plain version on {label}: outside the rounding "
             f"bound, so the bound is wrong")
    if not bool((err <= bound).all()):
        fail(f"region_scatter on {label}: {int((err > bound).sum())} elements "
             f"outside their rounding bound ({out})")
    if args[4] == BF16 and not out["mean"] <= 2 * out["plain_mean"]:
        fail(f"region_scatter on {label}: mean error over twice the plain "
             f"version's ({out})")
    return out


def scatter_skew(base, stride, t, tx, s_rows) -> str:
    """How the region scatter's terms spread over the output rows: the rows
    that some window row reaches, the terms per reached row, and the most
    on one row (the longest chain of adds one owner runs)."""
    start = region_scatter_cuda.segment_starts(base, stride, t, tx, s_rows)
    lo, hi = region_scatter_cuda.row_ranges(start.sort().values, tx, s_rows)
    terms = hi - lo
    reached = int((terms > 0).sum())
    return (f"{reached} of {s_rows} output rows reached, "
            f"{float(terms.sum()) / max(reached, 1):.2f} terms a reached row, "
            f"at most {int(terms.max())} on one row")


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def test_rois(rng, b, hw, n):
    """``n`` ROIs of a b-image request: log-uniform sizes over all five
    levels, a tenth long thin boxes (the window clamp) and a tenth at the
    bottom-right of the last image on P6 (windows past the buffer's end)."""
    h, w = hw
    n_thin = n_end = n // 10
    n_box = n - n_thin - n_end
    side = np.exp(rng.uniform(np.log(8), np.log(700), n_box))
    ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3), n_box))
    bh, bw = side * np.sqrt(ar), side / np.sqrt(ar)
    y0, x0 = rng.uniform(-8, h - bh / 2), rng.uniform(-8, w - bw / 2)
    boxes = [np.stack([y0, x0, y0 + bh, x0 + bw], 1)]
    th, tw = rng.uniform(6, 12, n_thin), rng.uniform(700, 1000, n_thin)
    flip = rng.rand(n_thin) < 0.5
    th, tw = np.where(flip, tw * h / w, th), np.where(flip, th, tw)
    ty0, tx0 = rng.uniform(0, h - th), rng.uniform(0, w - tw)
    boxes.append(np.stack([ty0, tx0, ty0 + th, tx0 + tw], 1))
    es = rng.uniform(150, 400, (n_end, 2))
    boxes.append(np.stack([h - es[:, 0], w - es[:, 1],
                           np.full(n_end, h), np.full(n_end, w)], 1))
    rois = torch.from_numpy(np.concatenate(boxes).astype(np.float32))
    levels = map_rois_to_fpn_levels(rois)
    levels[n - n_end:] = 4
    bi = torch.from_numpy(rng.randint(0, b, n).astype(np.int32))
    bi[n - n_end:] = b - 1
    return rois, bi, levels


def train_rois(rng, b, hw, n):
    """(b, n) sampled-ROI slots as a train step pools them: per image, half
    are jittered copies of four object boxes (many ROIs on one object, so
    their windows overlap heavily), the rest as :func:`test_rois` draws
    them, P6 boxes at the bottom-right corner included."""
    h, w = hw
    rois, levels = [], []
    for _ in range(b):
        r, _, lv = test_rois(rng, 1, hw, n - n // 2)
        side = rng.uniform(60, 500, (4, 2))
        y0, x0 = rng.uniform(0, h - side[:, 0]), rng.uniform(0, w - side[:, 1])
        objects = np.stack([y0, x0, y0 + side[:, 0], x0 + side[:, 1]], 1)
        near = objects[rng.randint(0, 4, n // 2)] + rng.uniform(-12, 12, (n // 2, 4))
        near = torch.from_numpy(near.astype(np.float32))
        rois.append(torch.cat([near, r]))
        levels.append(torch.cat([map_rois_to_fpn_levels(near), lv]))
    return torch.stack(rois), torch.stack(levels)


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on the GPU")
    print(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.device_count()} card(s), using "
          f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout.strip()
    present = {m: importlib.util.find_spec(m) is not None
               for m in ("triton", "ninja", "torchvision", "cv2", "PIL")}
    # the distributions behind the image modules, found without importing
    # them (a COCO loader would decode with them)
    dists = importlib.metadata.packages_distributions()
    versions = {m: [f"{d} {importlib.metadata.version(d)}" for d in dists.get(m, [])]
                for m in ("cv2", "PIL") if present[m]}
    print(f"[device] nvidia-smi: {card_name_and_power_limit()}")
    print(f"[device] nvcc: {nvcc.splitlines()[-1] if nvcc else 'absent'}; "
          f"python modules present: {present}; image modules' "
          f"distributions: {versions}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] TF32 off for matmul and cuDNN: float32 throughout")


def phase_build():
    """One ``nvcc`` per source, all started together; a failed build raises."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(lambda entry: entry[0].library.load(), KERNELS))
    print(f"[build] {len(KERNELS)} kernel(s) built in "
          f"{time.perf_counter() - t0:.1f} s")
    for kernel, *_ in KERNELS:
        for line in kernel.library.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kernel.name}: {line.strip()}")


def phase_roi_align_vs_plain(seed: int) -> float:
    """ROIAlign forward against its plain version → worst f32 error."""
    cfg = predict_config("fpn_mask", 1, 800, 1024)
    shapes = pyramid_shapes(cfg, (800, 1024))
    scales = tuple(1.0 / s for s in (4, 8, 16, 32, 64))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    kernel, plain = ROI_ALIGN, roi_align_cuda.roi_align_region_plain
    banded = roi_align_cuda.roi_align_region_banded
    worst = 0.0
    for b in (1, 2):
        feats = [torch.randn(b, h, w, 256, device="cuda", generator=gen)
                 for h, w in shapes]
        for n, out in ((300, 7), (100, 14)):
            rois, bi, levels = (t.cuda() for t in test_rois(rng, b, (800, 1024), n))
            for geometry in ("region", "pallas"):
                build = getattr(roi_align_ops, f"{geometry}_geometry")
                flat, row_ids, by, bx = build(feats, rois, bi, levels,
                                              (out, out), scales)
                args = (flat, *roi_align_ops.window_starts(row_ids), by, bx)
                got, want = kernel(*args), plain(*args)
                err = rel_err(got, want)
                steps_err = rel_err(got, banded(*args))
                args16 = (flat.bfloat16(),) + args[1:]
                err16 = rel_err(kernel(*args16), plain(*args16))
                torch.cuda.synchronize()
                ms = time_ms(lambda: kernel(*args))
                plain_ms = time_ms(lambda: plain(*args))
                bound = roi_align_bound(*args)
                past = int((row_ids[:, -1] + bx.shape[2] > flat.shape[0]).sum())
                print(f"[kernels] roi_align_fwd b{b} R={n} {out}x{out} "
                      f"{geometry} window {by.shape[2]}x{bx.shape[2]}, "
                      f"{past} past the buffer's end: "
                      f"f32 err {err:.2e} (against the banded steps "
                      f"{steps_err:.2e}), bf16 err {err16:.2e}, "
                      f"{ms:.4f} ms (plain {plain_ms:.4f} ms; bound bytes "
                      f"{bound['bytes_ms']:.4f} / operations "
                      f"{bound['ops_ms']:.4f} ms; dense count bytes "
                      f"{bound['dense_bytes_ms']:.4f} / operations "
                      f"{bound['dense_ops_ms']:.4f} ms; "
                      f"{bound['reached']:.3f} of the windows reached)")
                if not err <= F32_TOL:
                    fail(f"roi_align_fwd f32 error {err} > {F32_TOL}")
                if not steps_err <= F32_TOL:
                    fail(f"roi_align_fwd differs from its banded steps by "
                         f"{steps_err} > {F32_TOL}")
                if not err16 <= BF16_TOL:
                    fail(f"roi_align_fwd bf16 error {err16} > {BF16_TOL}")
                worst = max(worst, err)
    return worst


def phase_region_scatter_vs_plain(seed: int) -> float:
    """Region scatter against its plain version, on the cotangent windows a
    train step builds: the geometry of :func:`train_rois`, a random pooled
    gradient pulled back through ``By``/``Bx`` (zero outside each ROI's
    extent, as on the train path), the mask prefix added in → worst error."""
    cfg = predict_config("fpn_mask", 1, 800, 1024)
    shapes = np.array(pyramid_shapes(cfg, (800, 1024)))
    scales = tuple(1.0 / s for s in (4, 8, 16, 32, 64))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed + 1)
    plain = region_scatter_cuda.region_scatter_plain
    worst = 0.0
    n, n_pos, c = 256, 64, 256
    for b in (2, 8):
        offsets = np.concatenate([[0], np.cumsum(shapes[:, 0] * shapes[:, 1] * b)[:-1]])
        s_rows = int((shapes[:, 0] * shapes[:, 1]).sum()) * b
        rois, levels = (t.cuda() for t in train_rois(rng, b, (800, 1024), n))
        row_ids, by_b, bx_b, by_m, bx_m = roi_align_ops.pair_geometry(
            shapes, offsets, rois, levels, n_pos, (7, 7), (14, 14), scales)
        base, stride = roi_align_ops.window_starts(row_ids)
        d_regs = roi_align_ops._d_regions(
            by_b, bx_b, torch.randn(b * n, 7, 7, c, device="cuda", generator=gen))
        t, tx = d_regs.shape[1:3]
        d_regs.reshape(b, n, t, tx, c)[:, :n_pos] += roi_align_ops._d_regions(
            by_m, bx_m, torch.randn(b * n_pos, 14, 14, c, device="cuda", generator=gen)
        ).reshape(b, n_pos, t, tx, c)
        past = int((row_ids[:, -1] + tx > s_rows).sum())
        nonzero = float((d_regs != 0).float().mean())
        if past == 0:
            fail("region_scatter case has no window past the buffer's end")
        print(f"[kernels] region_scatter b{b} R={b * n}: ROIs per level P2-P6 "
              f"{torch.bincount(levels.flatten(), minlength=5).tolist()}, "
              f"{scatter_skew(base, stride, t, tx, s_rows)}")
        for dt, acc in SCATTER_PAIRS:
            args = (d_regs.to(dt), base, stride, s_rows, acc)
            label = f"b{b} R={b * n} {str(dt)[6:]} in, {str(acc)[6:]} accumulator"
            check = scatter_check(SCATTER(*args), plain(*args), args, label)
            torch.cuda.synchronize()
            ms = time_ms(lambda: SCATTER(*args), busy=SCATTER_BUSY)
            plain_ms = time_ms(lambda: plain(*args), runs=7, calls=3)
            lib_ms = index_add_ms(*args)
            b_ms = region_scatter_bound(*args)
            print(f"[kernels] region_scatter {label}, window {t}x{tx} C={c} "
                  f"S={s_rows}, {past} past the buffer's end, {nonzero:.3f} of "
                  f"d_regs nonzero: against the exact sum err {check['err']:.2e}"
                  f" (mean {check['mean']:.2e}, plain's mean "
                  f"{check['plain_mean']:.2e}; worst {check['share']:.3f} of an "
                  f"element's rounding bound), {ms:.4f} ms (plain "
                  f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
                  f"{max(b_ms['bytes_ms'], b_ms['ops_ms']):.4f} ms); equal "
                  f"to region_scatter_ordered and to a second call, bit for "
                  f"bit")
            if dt == acc == F32:
                worst = max(worst, check["err"])
    return worst


def c4_rois(rng, b, hw, n, max_side: float = 800.0):
    """``n`` proposal-like ROIs of a b-image request on one level:
    log-uniform sizes from 16 to ``max_side`` pixels, aspect ratios 1/3 to
    3, some partly off the image."""
    h, w = hw
    side = np.exp(rng.uniform(np.log(16), np.log(max_side), n))
    ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3), n))
    bh, bw = np.minimum(side * np.sqrt(ar), h), np.minimum(side / np.sqrt(ar), w)
    y0, x0 = rng.uniform(-8, h - bh / 2), rng.uniform(-8, w - bw / 2)
    rois = torch.from_numpy(np.stack([y0, x0, y0 + bh, x0 + bw], 1).astype(np.float32))
    bi = torch.from_numpy(rng.randint(0, b, n).astype(np.int32))
    return rois, bi, torch.zeros(n, dtype=torch.int32)


def phase_c4_kernels_vs_plain(seed: int) -> float:
    """Both kernels against their plain versions at the C4 presets' shapes:
    one 50×64 level (an 800×1024 image) at C=1024 (``c4_res5``) and at the
    light head's C=490, which the port pads to 512 channels; 300 ROIs at
    7×7 (a request, b1) and 512 train ROIs (b2) in the pallas window
    geometry, whose pooled gradient the region scatter takes back. Also
    how far the pallas pool (a window of 20 or 22 cells) lies from the
    gather form on ROIs wider than its window → worst f32 error."""
    scales = (1.0 / 16,)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed + 2)
    kernel, plain = ROI_ALIGN, roi_align_cuda.roi_align_region_plain
    scatter_plain = region_scatter_cuda.region_scatter_plain
    worst = 0.0
    for c in (1024, 490):
        for b, n, kind in ((1, 300, "request"), (2, 512, "train")):
            feats = [torch.randn(b, *C4_SHAPE, c, device="cuda", generator=gen)]
            rois, bi, lv = (t.cuda() for t in c4_rois(rng, b, (800, 1024), n))
            flat, row_ids, by, bx = roi_align_ops.pallas_geometry(
                feats, rois, bi, lv, (7, 7), scales)
            base, stride = roi_align_ops.window_starts(row_ids)
            args = (flat, base, stride, by, bx)
            err = rel_err(kernel(*args), plain(*args))
            torch.cuda.synchronize()
            ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: plain(*args))
            bound = roi_align_bound(*args)
            label = f"C4 b{b} R={n} C={c} (flat {flat.shape[1]})"
            print(f"[c4-kernels] roi_align_fwd {label} 7x7 pallas window "
                  f"{by.shape[2]}x{bx.shape[2]}: err {err:.2e}, {ms:.4f} ms "
                  f"(plain {plain_ms:.4f} ms; bound bytes {bound['bytes_ms']:.4f}"
                  f" / operations {bound['ops_ms']:.4f} ms)")
            if not err <= F32_TOL:
                fail(f"roi_align_fwd on {label}: error {err} > {F32_TOL}")
            worst = max(worst, err)
            if kind == "request":
                gather = roi_align_ops.multilevel_roi_align(
                    feats, rois, bi, lv, (7, 7), scales, impl="gather")
                pallas = roi_align_ops.multilevel_roi_align(
                    feats, rois, bi, lv, (7, 7), scales, impl="pallas")
                span = ((rois[:, 2:] - rois[:, :2]) / 16).max(dim=1).values
                off = (pallas - gather).abs().amax(dim=(1, 2, 3)) / float(
                    gather.abs().max())
                inside = span <= by.shape[2] - 3
                wide = off[~inside] if bool((~inside).any()) else off.new_zeros(1)
                print(f"[c4-kernels] pallas vs gather pool, C={c}: "
                      f"{int(inside.sum())} of {n} ROIs span at most "
                      f"{by.shape[2] - 3} cells, worst {float(off[inside].max()):.2e}"
                      f" of max |gather|; the {int((~inside).sum())} wider "
                      f"(up to {float(span.max()):.1f} cells) worst "
                      f"{float(wide.max()):.2e}, mean {float(wide.mean()):.2e}")
                if not float(off[inside].max()) <= F32_TOL:
                    fail(f"pallas pool differs from gather inside its window at C={c}")
                continue
            g = torch.randn(n, 7, 7, flat.shape[1], device="cuda", generator=gen)
            g[..., c:] = 0  # the padded channels' pool is sliced off
            d_regs = roi_align_ops._d_regions(by, bx, g, F32)
            sargs = (d_regs, base, stride, flat.shape[0], F32)
            t, tx = d_regs.shape[1:3]
            check = scatter_check(SCATTER(*sargs), scatter_plain(*sargs), sargs,
                                  label)
            torch.cuda.synchronize()
            ms = time_ms(lambda: SCATTER(*sargs), busy=SCATTER_BUSY)
            plain_ms = time_ms(lambda: scatter_plain(*sargs), runs=7, calls=3)
            b_ms = region_scatter_bound(*sargs)
            print(f"[c4-kernels] region_scatter {label} window {t}x{tx} "
                  f"S={flat.shape[0]}: {scatter_skew(base, stride, t, tx, flat.shape[0])}; "
                  f"against the exact sum {check['err']:.2e} (worst "
                  f"{check['share']:.3f} of an element's bound), {ms:.4f} ms "
                  f"(plain {plain_ms:.4f} ms, index_add_ {index_add_ms(*sargs):.4f}"
                  f" ms, bound {max(b_ms['bytes_ms'], b_ms['ops_ms']):.4f} ms); "
                  f"equal to region_scatter_ordered and to a second call")
            worst = max(worst, check["err"])
    return worst


class Capture:
    """Calls ``fn`` and keeps copies of the arguments of its first ``n``
    calls: the inputs a main path gives a kernel."""

    def __init__(self, fn, n: int):
        self.fn, self.n, self.calls = fn, n, []

    def __call__(self, *args):
        if len(self.calls) < self.n:
            self.calls.append(tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return self.fn(*args)


class Proposals:
    """Swaps ``generate_proposals`` in a module for a spy: ``keep()`` records
    the proposals of each call, ``give(props)`` hands every call those
    proposals, moved to the caller's device. For the C4 presets' card
    against CPU comparisons: their one level's RPN scores hold exact ties,
    which the card's and the CPU's softmax break a rounding apart, so the top-k order and the NMS after it differ between
    the two from identical inputs; the head, the decode, per-class NMS and
    the masks are compared from the same proposals."""

    def __init__(self, module):
        self.module, self.real, self.calls = module, module.generate_proposals, []

    def keep(self):
        def spy(*args, **kwargs):
            props = self.real(*args, **kwargs)
            self.calls.append(props)
            return props
        self.module.generate_proposals = spy
        return self

    def give(self, props):
        def fixed(locs, *args, **kwargs):
            return type(props)(*(t.to(locs.device) for t in props))
        self.module.generate_proposals = fixed
        return self

    def restore(self):
        self.module.generate_proposals = self.real


def shared_slots(a, b) -> str:
    """How many of two proposal sets' slots hold the same box."""
    same = ((a.rois.cpu() - b.rois.cpu()).abs().amax(dim=-1) < 1e-2) & (
        a.valid.cpu() == b.valid.cpu())
    return f"{int(same.sum())} of {same.numel()}"


def reset_launches():
    for kernel, *_ in KERNELS:
        kernel.launches = 0


def read_launches() -> dict:
    return {kernel.name: kernel.launches for kernel, *_ in KERNELS}


def pool_counts(launches: dict) -> dict:
    """The ROIAlign kernels' counts of a launches dict (phases whose NMS
    count is not worked out; ``nms_launches`` requires it nonzero)."""
    return {k: v for k, v in launches.items() if k != NMS.name}


def nms_launches(launches: dict, want: int | None, tag: str):
    """NMS runs once per (micro-)batch in the RPN, all its images in one
    call, and once per batch in predict's per-class NMS: fail unless the
    count is ``want`` (or, when None, at least one)."""
    got = launches[NMS.name]
    if (got != want) if want is not None else got < 1:
        fail(f"[{tag}] nms_greedy launched {got} times, expected "
             f"{want if want is not None else 'some'}")


def pool_launches(cfg) -> tuple[int, int, int]:
    """(B2 launches a request, B2 a step, B1 a step) of a config's paths:
    the FPN heads' shared pair under auto/region/fused trains with 2 and 1;
    any other pool through a window geometry (``roi_align`` pallas or
    region) launches B2 once and, training, B1 once per pool; the gather
    form (``auto`` on one level, or ``gather``) launches neither."""
    m = cfg.model
    fpn = m.backbone == "fpn"
    windows = m.roi_align in ("region", "pallas")
    request = 2 if windows or (fpn and m.roi_align == "auto") else 0
    if fpn and m.roi_align in ("auto", "region", "fused"):
        return request, 2, 1
    return (request, 2, 2) if windows else (request, 0, 0)


def visualize_load(model):
    """The class-score layer's weights scaled by 32 and every foreground
    class's bias raised by 2, in place: a chosen load under the
    ``visualize`` preset's 0.7 threshold, which random weights spread by 8
    (:func:`spread_class_scores`) do not clear."""
    spread_class_scores(model, 32.0)
    with torch.no_grad():
        class_score_layer(model).bias[1:] += 2.0
    return model


def phase_predict(n_requests: int, seed: int, settings=None,
                  preset: str = "fpn_mask", tag: str = "predict",
                  hw=(800, 1024), mode: str = "evaluate"):
    """Serve requests through the port's predict on the card, at ``hw`` b1
    under the ``mode`` preset (score 0.05, or 0.7 under ``visualize``); with
    ``settings`` (model config fields) in that configuration, else float32
    and held against the CPU."""
    cfg = cfg_lib.use_preset(cfg_lib._rep(predict_config(preset, 1, *hw),
                                          model=settings or {}), mode)
    keypoint = cfg.model.head == "fpn_keypoint"
    single = cfg.model.backbone != "fpn"
    per_request = pool_launches(cfg)[0]
    t0 = time.perf_counter()
    model = MaskRCNN(cfg, seed=seed)
    if mode == "visualize":
        visualize_load(model)
    else:
        spread_class_scores(model)
    checksum = sum(float(v.double().abs().sum()) for v in model.state_dict().values())
    predict = make_predict_fn(cfg, model)
    data = SyntheticRequests(cfg, seed=seed)
    requests = [tuple(data.batch(i)) for i in range(n_requests)]
    print(f"[{tag}] {preset} {hw[0]}x{hw[1]} b1 {cfg.model.dtype}, {mode} "
          f"(score {cfg.eval.score_thresh}), roi_align "
          f"{cfg.model.roi_align}, {cfg.model.n_fg_class} classes, "
          f"{cfg.proposals.n_test_pre_nms}/{cfg.proposals.n_test_post_nms} "
          f"proposals, weights' abs sum {checksum:.6f}, "
          f"model and {n_requests} requests ready in "
          f"{time.perf_counter() - t0:.1f} s")

    # request 0 eagerly, keeping the kernel inputs it makes (2 per request)
    capture = Capture(ROI_ALIGN, per_request)
    nms_capture = Capture(NMS, 2)
    roi_align_ops.roi_align_fwd, nms_ops.nms_greedy = capture, nms_capture
    try:
        det0 = predict.eager(*requests[0])
        torch.cuda.synchronize()
    finally:
        roi_align_ops.roi_align_fwd, nms_ops.nms_greedy = ROI_ALIGN, NMS
    NMS_CALLS.setdefault(tag, nms_capture.calls)

    reset_launches()
    times, dets = time_requests(predict, requests, warmup=0)
    launches = read_launches()
    print(f"[{tag}] launches over {n_requests} requests: {launches}")
    nms_launches(launches, 2 * n_requests, tag)
    if pool_counts(launches) != {"roi_align_fwd": per_request * n_requests,
                                 "region_scatter": 0}:
        fail(f"expected {per_request} forward launches per request, got "
             f"{launches}")
    for det in dets:
        for name, value in det._asdict().items():
            if value is not None and value.is_floating_point() and not torch.isfinite(value).all():
                fail(f"non-finite {name}")
        d = cfg.eval.max_detections
        if keypoint and det.heatmaps.shape != (1, d, 56, 56, cfg.model.n_keypoints):
            fail(f"heatmap shape {tuple(det.heatmaps.shape)}")
        size = model.head.mask_size
        if not keypoint and det.masks.shape != (1, d, size, size):
            fail(f"mask shape {tuple(det.masks.shape)}")
    print(f"[{tag}] request p50 {percentile(times, 0.5):.3f} ms, max "
          f"{max(times):.3f} ms (CUDA events, {n_requests} requests: the "
          f"first eager, the second captures, replays after); valid "
          f"detections per request "
          f"{[int(d.valid.sum()) for d in dets]} of {cfg.eval.max_detections}")
    pairs = passing_pairs(cfg, model, predict, requests)
    print(f"[{tag}] (ROI, class) pairs above score_thresh "
          f"{cfg.eval.score_thresh} per request (untimed rerun): {pairs}")
    if n_requests > 1:
        phase_predict_graph(cfg, model, requests, f"{tag}-graph", per_request)
    if settings is not None:
        return launches, capture.calls

    # the same request on the CPU, through the same port and weights
    t0 = time.perf_counter()
    cpu_model = MaskRCNN(cfg, device="cpu", seed=seed)
    cpu_model.load_state_dict(model.state_dict())
    spy = Proposals(predict_mod).keep()
    try:
        ref = make_predict_fn(cfg, cpu_model)(*requests[0])
        if single:
            det0 = predict.eager(*requests[0])
            spy.give(spy.calls[0])
            det0 = predict.eager(*requests[0])
    finally:
        spy.restore()
    print(f"[{tag}] request 0 on the CPU in {time.perf_counter() - t0:.1f} s, "
          f"{int(ref.valid.sum())} valid detections")
    if single:
        with torch.no_grad():
            scores = cpu_model(torch.as_tensor(requests[0][0]))[2][0]
        fg = torch.softmax(scores, -1)[:, 1]
        top = fg.sort(descending=True).values[:cfg.proposals.n_test_pre_nms]
        apart = float((torch.softmax(scores.cuda(), -1)[:, 1].cpu() - fg).abs().max())
        print(f"[{tag}] the card's own proposals share {shared_slots(*spy.calls)}"
              f" slots with the CPU's: {top.numel() - torch.unique(top).numel()} "
              f"foreground scores of the CPU's top {top.numel()} repeat an "
              f"earlier one exactly, and the card's softmax of the same RPN "
              f"scores lies up to {apart:.1e} from the CPU's; the card's "
              f"request is compared from the CPU's proposals")
    for name in ("valid", "labels"):
        if not torch.equal(getattr(det0, name).cpu(), getattr(ref, name)):
            fail(f"GPU and CPU {name} differ")
    for name in ("boxes", "scores", "heatmaps" if keypoint else "masks"):
        got, want = getattr(det0, name).cpu(), getattr(ref, name)
        err = float((got - want).abs().max())
        print(f"[{tag}] GPU vs CPU {name}: max abs {err:.3e}")
        if not err <= SLICE_TOL * max(1.0, float(want.abs().max())):
            fail(f"GPU and CPU {name} differ by {err}")
    if keypoint:
        keypoints_card_vs_cpu(det0, ref, tag)
    return launches, capture.calls


def same_bits(got, want) -> list[str]:
    """The fields of two ``Detections`` that differ in any bit."""
    return [name for name, g, w in zip(got._fields, got, want)
            if (g is None) != (w is None) or (g is not None and not torch.equal(g, w))]


def phase_predict_graph(cfg, model, requests, tag: str, per_request: int):
    """``predict-graph`` (the module's docstring, phase 4) on a served
    model and its requests; the model's weights are as before on return."""
    predict = make_predict_fn(cfg, model)
    inputs = [torch.as_tensor(x, device=model.device) for x in requests[0]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        predict.eager(*inputs)
    except RuntimeError as err:
        fail(f"[{tag}] an eager request waits for the host: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    predict(*requests[0])
    predict(*requests[1])
    graph, = predict.graphs.values()
    if (graph.captures, graph.replays) != (1, 1):
        fail(f"[{tag}] after two calls {graph.captures} captures and "
             f"{graph.replays} replays, expected 1 and 1")
    want = {ROI_ALIGN.name: per_request, SCATTER.name: 0, NMS.name: 2}
    for name, fn in (("graphed", predict), ("eager", predict.eager)):
        torch.cuda.synchronize()
        reset_launches()
        fn(*requests[2])
        torch.cuda.synchronize()
        if read_launches() != want:
            fail(f"[{tag}] a {name} request launched {read_launches()}, "
                 f"expected {want}")
    turns = time_in_turns({"graphed": predict, "eager": predict.eager},
                          requests, warmup=0)
    for i, (got, ref) in enumerate(zip(turns["graphed"][1], turns["eager"][1])):
        if same_bits(got, ref):
            fail(f"[{tag}] request {i}: replayed {same_bits(got, ref)} differ "
                 "from eager")
    (g_ms, _), (e_ms, _) = turns["graphed"], turns["eager"]
    print(f"[{tag}] {len(requests)} requests replayed and eager in turns, equal "
          f"in every bit; launches a request {want} both ways; p50 / p90 ms "
          f"graphed {percentile(g_ms, 0.5):.3f} / {percentile(g_ms, 0.9):.3f}, "
          f"eager {percentile(e_ms, 0.5):.3f} / {percentile(e_ms, 0.9):.3f} "
          f"(CUDA events, enqueue to last kernel); capture {graph.capture_s:.3f} s, "
          f"its pool reserved {graph.reserved_bytes / 2**30:.3f} GiB; "
          f"{card_name_and_power_limit()}")

    first, second = predict(*requests[0]), predict(*requests[1])
    ref = predict.eager(*requests[0])
    if same_bits(first, ref) or torch.equal(first.scores, second.scores):
        fail(f"[{tag}] two replayed results held at once: request 0's differs "
             f"from eager in {same_bits(first, ref)}, or equals request 1's")
    layer = class_score_layer(model)
    weight = layer.weight

    def held(change: str):
        det = predict(*requests[0])
        differ = same_bits(det, predict.eager(*requests[0]))
        if differ or graph.captures != 2:
            fail(f"[{tag}] the class-score weight {change}: {differ} differ "
                 f"from eager, {graph.captures} captures (expected 2)")
        return det

    try:
        layer.weight = torch.nn.Parameter(weight.detach() * 1.25)
        replaced = held("replaced")
        with torch.no_grad():
            layer.weight.mul_(0.8)
        scaled = held("scaled in place")
    finally:
        layer.weight = weight
    if torch.equal(replaced.scores, ref.scores) or torch.equal(
            scaled.scores, replaced.scores):
        fail(f"[{tag}] the replays did not follow the weights")
    print(f"[{tag}] two replayed results held at once, each its own "
          f"request's; the class-score weight replaced: captured again, equal "
          f"to eager; scaled in place: not captured again, the replay follows "
          f"it ({graph.captures} captures, {graph.replays} replays)")


def keypoints_card_vs_cpu(det, ref, tag: str):
    """Decode request 0's keypoints from the card's and the CPU's heatmaps:
    each within ``SLICE_TOL`` of its box's size, except where the two pick
    different bins, which may happen only at a tie: the CPU heatmap's value
    at the card's bin within ``SLICE_TOL`` of max(1, max |heatmap|) of its
    maximum."""
    valid = ref.valid[0].numpy()
    boxes = ref.boxes[0].numpy()[valid]
    heat_cpu = ref.heatmaps[0].numpy()[valid]
    heat_card = det.heatmaps[0].cpu().numpy()[valid]
    ones = np.ones(len(boxes), bool)
    got = decode_keypoints(det.boxes[0].cpu().numpy()[valid], heat_card, ones)
    want = decode_keypoints(boxes, heat_cpu, ones)
    size = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    off = np.abs(got[..., :2] - want[..., :2]).max(axis=2) / size[:, None]
    s, k = heat_cpu.shape[1], heat_cpu.shape[3]
    flat_cpu = heat_cpu.reshape(len(boxes), s * s, k)
    card_bin = heat_card.reshape(len(boxes), s * s, k).argmax(axis=1)
    at_card = np.take_along_axis(flat_cpu, card_bin[:, None], 1)[:, 0]
    gap = flat_cpu.max(axis=1) - at_card
    tol = SLICE_TOL * max(1.0, float(np.abs(heat_cpu).max()))
    ties = (off > SLICE_TOL) & (gap <= tol)
    print(f"[{tag}] GPU vs CPU decoded keypoints of {len(boxes)} "
          f"detections: worst {float(off.max(initial=0)):.3e} of the box size; "
          f"{int(ties.sum())} of {off.size} at a heatmap tie")
    if ((off > SLICE_TOL) & ~ties).any():
        fail("GPU and CPU decoded keypoints differ away from a heatmap tie")


def snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def phase_train(n_steps: int, seed: int, settings=None, preset: str = "fpn_mask",
                tag: str = "train", hw=(800, 1024), batch: int = 2):
    """Take optimizer steps through the port's train step on the card, at
    ``hw`` and ``batch``; with ``settings`` (model config fields) in that
    configuration."""
    cfg = cfg_lib._rep(predict_config(preset, batch, *hw), model=settings or {})
    keypoint = cfg.model.head == "fpn_keypoint"
    _, per_step, scatters = pool_launches(cfg)
    t0 = time.perf_counter()
    state = create_train_state(cfg, MaskRCNN(cfg, seed=seed), seed)
    step = make_train_step(cfg)
    data = SyntheticDetectionData(cfg, seed=seed)
    batches = [data.batch(i) for i in range(n_steps + 1)]
    print(f"[{tag}] {preset} {hw[0]}x{hw[1]} b{batch} {cfg.model.dtype}, freeze_bn "
          f"{cfg.model.freeze_bn}, roi_align {cfg.model.roi_align}, "
          f"{cfg.model.n_fg_class} classes, "
          f"{cfg.proposals.n_train_pre_nms}/{cfg.proposals.n_train_post_nms} "
          f"proposals, {cfg.sampler.n_sample} sampled ROIs per image; model "
          f"and {n_steps + 1} batches ready in {time.perf_counter() - t0:.1f} s")

    # the warm-up step, keeping the kernel inputs it makes
    # (and the cotangents that the products feeding the scatter get)
    fwd, bwd = Capture(ROI_ALIGN, per_step), Capture(SCATTER, scatters)
    d_regions = roi_align_ops._d_regions
    products = Capture(d_regions, 2 if scatters else 0)
    nms_capture = Capture(NMS, 1)
    roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter = fwd, bwd
    roi_align_ops._d_regions, nms_ops.nms_greedy = products, nms_capture
    try:
        t1 = time.perf_counter()
        step(state, batches[0])
        torch.cuda.synchronize()
        print(f"[{tag}] warm-up step in {time.perf_counter() - t1:.1f} s")
    finally:
        roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter = ROI_ALIGN, SCATTER
        roi_align_ops._d_regions, nms_ops.nms_greedy = d_regions, NMS
    NMS_CALLS.setdefault(tag, nms_capture.calls)

    before = snapshot(state.model)
    stats = running_statistics(state.model)
    reset_launches()
    times, metrics, peak = time_train_steps(step, state, batches[1:], warmup=0)
    launches = read_launches()
    print(f"[{tag}] launches over {n_steps} steps: {launches}")
    nms_launches(launches, n_steps, tag)
    if pool_counts(launches) != {"roi_align_fwd": per_step * n_steps,
                                 "region_scatter": scatters * n_steps}:
        fail(f"expected {per_step} forward launches and {scatters} region "
             f"scatters per step, got {launches}")
    for i, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        print(f"[{tag}] step {i + 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in m.items() if k.endswith("loss"))
            + f"; sampled slots valid {int(m['n_valid_rois'])}, positive "
              f"{int(m['n_pos_rois'])} of {batch * cfg.sampler.n_sample}")
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"non-finite loss at step {i + 1}: {m}")
    after = snapshot(state.model)
    unseen = tuple(rounding_only(cfg))
    still = [k for k in before if torch.equal(before[k], after[k])
             and k not in unseen]
    bn = next(k for k in before if ".bn" in k)
    print(f"[{tag}] {len(before) - len(still)} of {len(before)} parameter "
          f"tensors moved{f' ({unseen} by rounding noise, if at all)' if unseen else ''}; "
          f"{bn} by {float((after[bn] - before[bn]).abs().max()):.3e}")
    if still or state.step != n_steps + 1:
        fail(f"parameters that did not move: {still[:5]}; step {state.step}")
    if not cfg.model.freeze_bn or cfg.model.backbone == "darknet":
        # (Darknet's BatchNorms always train)
        now = running_statistics(state.model)
        unmoved = [k for k in stats if torch.equal(stats[k], now[k])]
        print(f"[{tag}] {len(stats) - len(unmoved)} of {len(stats)} BatchNorm "
              f"running statistics moved")
        if unmoved:
            fail(f"running statistics that did not move: {unmoved[:5]}")
    ms = statistics.median(times)
    print(f"[{tag}] step p50 {ms:.3f} ms, max {max(times):.3f} ms (CUDA "
          f"events, {n_steps} steps after 1 warm-up): {batch * 1e3 / ms:.3f} images/s; "
          f"peak memory {peak / 2**30:.3f} GiB")
    return launches, fwd.calls, bwd.calls, products.calls


def running_statistics(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def rounding_only(cfg) -> dict:
    """The parameters whose true gradient is zero, so that a step moves them
    by float32 rounding alone, and the share of the step's largest update
    each must stay under: the keypoint head's two biases that its softmax
    cannot see (``SOFTMAX_UNSEEN``, a millionth), and Darknet's conv
    biases, which the BatchNorm after each subtracts again on batch
    statistics (a thousandth; up to 6.8e-5 measured on the CPU,
    ``tests/test_torch_darknet_step.py``)."""
    out = {}
    if cfg.model.head == "fpn_keypoint":
        out.update(dict.fromkeys(SOFTMAX_UNSEEN, 1e-6))
    if cfg.model.backbone == "darknet":
        out.update({f"extractor.conv{i}.conv0.bias": 1e-3 for i in range(1, 6)})
    return out


def phase_train_gpu_vs_cpu(seed: int, preset: str = "fpn_mask",
                           tag: str = "train", hw=(256, 320)):
    """One train step from the same weights, batch and sampler draws on the
    card and on the CPU: full widths (80 classes for the mask head) on a
    ``hw`` canvas (256×320 unless given) with 1000/256 proposals, so the
    CPU step stays short. Parameters that move by rounding alone
    (:func:`rounding_only`) must stay below their share of the step's
    largest update instead."""
    cfg = cfg_lib._rep(predict_config(preset, 2, *hw),
                       proposals=dict(n_train_pre_nms=1000, n_train_post_nms=256))
    if preset in C4_CPU_SAMPLES:
        cfg = cfg_lib._rep(cfg, sampler=dict(n_sample=C4_CPU_SAMPLES[preset]))
        print(f"[{tag}] card vs CPU step cut to sampler.n_sample "
              f"{cfg.sampler.n_sample} (from 256) so the CPU side stays short")
    batch = SyntheticDetectionData(cfg, seed=seed).batch(0)
    gen = torch.Generator().manual_seed(seed)
    n_anchor = 3 * sum(h * w for h, w in pyramid_shapes(cfg, hw))
    draws = SamplerDraws(
        torch.rand((2, 2, 256 + cfg.train.max_gt), generator=gen),
        torch.rand((2, 2, n_anchor), generator=gen))
    step = make_train_step(cfg)
    runs = {}
    single = cfg.model.backbone != "fpn"
    spy = Proposals(step_mod)
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        state = create_train_state(cfg, MaskRCNN(cfg, device=device, seed=seed))
        before = snapshot(state.model)
        if single:  # the CPU's proposals on both sides (see Proposals)
            spy.keep() if device == "cpu" else spy.give(spy.calls[0])
        try:
            metrics = {k: float(v) for k, v in step(state, batch, draws).items()}
        finally:
            spy.restore()
        update = {k: (v - before[k]).cpu() for k, v in snapshot(state.model).items()}
        runs[device] = metrics, update
        print(f"[{tag}] {hw[0]}x{hw[1]} b2 step on {device} in "
              f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
                  f"{k} {v:.6f}" for k, v in metrics.items()))
    if single:
        print(f"[{tag}] the card's step took the CPU's proposals")
    (got, got_up), (want, want_up) = runs["cuda"], runs["cpu"]
    hold_step(tag, cfg, got, got_up, want, want_up, before, "GPU", "CPU")


def hold_step(tag: str, cfg, got: dict, got_up: dict, want: dict, want_up: dict,
              before: dict, name: str, ref: str):
    """Fail unless one train step (``got``: its metrics, and each
    parameter's update) equals the reference step (``want``) of the same
    weights, batch and draws: the same ROI counts, each loss term within
    ``TRAIN_LOSS_TOL`` relative, each update within ``TRAIN_UPDATE_TOL`` of
    the step's largest and ``TRAIN_OWN_TOL`` of its own largest beyond two
    float32 roundings of its weights. Parameters that move by rounding
    alone (:func:`rounding_only`) must stay below their share of the step's
    largest update instead."""
    got_up, want_up = dict(got_up), dict(want_up)
    shares = rounding_only(cfg)
    unseen = {k: (got_up.pop(k), want_up.pop(k)) for k in shares}
    if (got["n_valid_rois"], got["n_pos_rois"]) != (want["n_valid_rois"],
                                                    want["n_pos_rois"]):
        fail(f"[{tag}] {name} and {ref} sampled different ROI counts")
    for key, w in want.items():
        if not abs(got[key] - w) <= TRAIN_LOSS_TOL * max(abs(w), 1e-30):
            fail(f"[{tag}] {name} and {ref} {key} differ: {got[key]} vs {w}")
    largest = max(float(u.abs().max()) for u in want_up.values())
    for k, pair in unseen.items():
        noise = max(float(u.abs().max()) for u in pair)
        print(f"[{tag}] {k}: update {noise:.3e} in {name} or {ref} (rounding "
              f"noise, {noise / largest:.2e} of the largest)")
        if not noise <= shares[k] * largest:
            fail(f"{k} moved by {noise}: its true gradient is zero")
    worst = max(want_up, key=lambda k: float((got_up[k] - want_up[k]).abs().max()))
    err = float((got_up[worst] - want_up[worst]).abs().max())
    print(f"[{tag}] {name} vs {ref} parameter update: worst tensor {worst}, max "
          f"abs {err:.3e} = {err / largest:.3e} of the largest update {largest:.3e}")
    if not err <= TRAIN_UPDATE_TOL * largest:
        fail(f"{name} and {ref} updates differ by {err / largest} of the largest")
    eps = torch.finfo(torch.float32).eps
    own = {k: float(u.abs().max()) for k, u in want_up.items()}
    over = {k: max(float((got_up[k] - u).abs().max())
                   - 2 * eps * float(before[k].abs().max()), 0.0)
            / max(own[k], 1e-30) for k, u in want_up.items()}
    worst = max(over, key=over.get)
    print(f"[{tag}] {name} vs {ref}, each tensor against its own update: worst "
          f"{worst}, {over[worst]:.3e} of its largest update {own[worst]:.3e}")
    if not over[worst] <= TRAIN_OWN_TOL:
        fail(f"{name} and {ref} updates of {worst} differ by {over[worst]} of its own")


def quiet_rpn(model):
    """Zero the RPN's shared 3×3 conv in place: every anchor scores the same
    and every run proposes and samples the same ROIs (its ReLU passes no
    gradient at 0, so it stays zero)."""
    with torch.no_grad():
        model.rpn_head.conv.weight.zero_()
        model.rpn_head.conv.bias.zero_()
    return model


def bf16_distances(runs: dict, what: str) -> None:
    """``runs`` maps 'card16', 'cpu16', 'cpu32' to equal-shaped tensors;
    fail unless the card's distance from the CPU's float32 is within twice
    the CPU bf16's own distance from it plus ``BF16_FLOOR``."""
    want = runs["cpu32"].float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    card = float((runs["card16"].float().cpu() - want).abs().max()) / scale
    cpu = float((runs["cpu16"].float().cpu() - want).abs().max()) / scale
    print(f"[bf16-vs-cpu] {what}: card bf16 {card:.3e}, CPU bf16 {cpu:.3e} "
          f"of max |CPU float32| {scale:.3e}")
    if not card <= 2 * cpu + BF16_FLOOR:
        fail(f"bf16 {what}: the card is {card} from the CPU's float32, the "
             f"CPU's bf16 {cpu}")


def phase_bf16_gpu_vs_cpu(seed: int):
    """bfloat16 on the card against the CPU at 256×320: one request (80
    classes, spread class scores) and one train step (trainable BN, the
    RPN's shared conv zeroed, 1000/256 proposals) in bf16 on the card, bf16
    on the CPU and float32 on the CPU, from the same weights, inputs and
    sampler draws."""
    t0 = time.perf_counter()
    cfg32 = predict_config("fpn_mask", 1, 256, 320)
    card = spread_class_scores(MaskRCNN(
        cfg_lib._rep(cfg32, model=BF16_SETTINGS), seed=seed))
    models = {"card16": card}
    for name, settings in (("cpu16", BF16_SETTINGS), ("cpu32", {})):
        models[name] = MaskRCNN(cfg_lib._rep(cfg32, model=settings), device="cpu")
        models[name].load_state_dict(card.state_dict())
    req = SyntheticRequests(cfg32, seed=seed).batch(0)
    dets, rpn = {}, {}
    for name, model in models.items():
        dets[name] = make_predict_fn(model.cfg, model)(*req)
        with torch.no_grad():
            rpn[name] = model(torch.as_tensor(req.images, device=model.device))[1:]
    ref = dets["cpu32"]
    for i, what in enumerate(("RPN locs", "RPN scores")):
        bf16_distances({k: v[i] for k, v in rpn.items()}, what)
    counts = {k: int(d.valid.sum()) for k, d in dets.items()}
    k = min(counts.values())
    print(f"[bf16-vs-cpu] request: valid detections {counts}; the top {k} "
          f"scores compared, order-free (bf16 reorders near-tied detections)")
    if k < min(counts["cpu32"], 10):
        fail(f"bf16 request: valid detections {counts}")
    bf16_distances({name: d.scores[d.valid].sort(descending=True).values[:k]
                    for name, d in dets.items()}, "top valid detection scores")
    flat = ref.boxes.reshape(-1, 4)
    geometry = (torch.zeros(flat.shape[0], dtype=torch.int32),
                map_rois_to_fpn_levels(flat), ref.labels.reshape(-1))
    masks = {}
    for name, model in models.items():
        dev = model.device
        with torch.no_grad():
            feats = model.extract(torch.as_tensor(req.images, device=dev))
            masks[name] = torch.sigmoid(model.head_mask(
                feats, flat.to(dev), *(t.to(dev) for t in geometry)))
    bf16_distances(masks, "pass-2 masks on the CPU float32's detections")

    cfg = cfg_lib._rep(predict_config("fpn_mask", 2, 256, 320),
                       proposals=dict(n_train_pre_nms=1000, n_train_post_nms=256))
    batch = SyntheticDetectionData(cfg, seed=seed).batch(0)
    gen = torch.Generator().manual_seed(seed)
    n_anchor = 3 * sum(h * w for h, w in pyramid_shapes(cfg, (256, 320)))
    draws = SamplerDraws(
        torch.rand((2, 2, 256 + cfg.train.max_gt), generator=gen),
        torch.rand((2, 2, n_anchor), generator=gen))
    weights = quiet_rpn(MaskRCNN(cfg, device="cpu", seed=seed)).state_dict()
    losses, updates = {}, {}
    for name, device, settings in (("card16", "cuda", BF16_TRAIN_SETTINGS),
                                   ("cpu16", "cpu", BF16_TRAIN_SETTINGS),
                                   ("cpu32", "cpu", dict(freeze_bn=False))):
        c = cfg_lib._rep(cfg, model=settings)
        model = MaskRCNN(c, device=device)
        model.load_state_dict(weights)
        before = snapshot(model)
        m = make_train_step(c)(create_train_state(c, model), batch, draws)
        losses[name] = {k: float(v) for k, v in m.items()}
        updates[name] = {k: (v - before[k]).cpu() for k, v in snapshot(model).items()}
    print(f"[bf16-vs-cpu] train step losses: {losses}")
    for k in ("n_valid_rois", "n_pos_rois"):
        if len({losses[name][k] for name in losses}) != 1:
            fail(f"bf16 train step: the runs sampled different {k}")
    for k in ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
              "roi_cls_loss", "mask_loss"):
        bf16_distances({name: torch.tensor(v[k]) for name, v in losses.items()},
                       f"train {k}")
    keys = list(updates["cpu32"])
    bf16_distances({name: torch.cat([u[k].reshape(-1) for k in keys])
                    for name, u in updates.items()}, "train parameter update")
    print(f"[bf16-vs-cpu] done in {time.perf_counter() - t0:.1f} s")


def paste_card_vs_cpu(det, hw):
    """Paste request 0's detections on the card and on the CPU: the count of
    differing pixels, each within ``FLIP_BAND`` of 0.5 on the CPU (it lies
    between the CPU's pastes at 0.5 ∓ the band), at most ``FLIP_SHARE`` of
    the pasted pixels."""
    boxes, masks, valid = det.boxes[0], det.masks[0], det.valid[0]
    t0 = time.perf_counter()
    got = paste_masks(boxes, masks, valid, hw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = [t.cpu() for t in (boxes, masks, valid)]
    t0 = time.perf_counter()
    want = paste_masks(*cpu, hw)
    cpu_s = time.perf_counter() - t0
    lo, hi = (paste_masks(*cpu, hw, threshold=0.5 + s * FLIP_BAND) for s in (-1, 1))
    diff = got.cpu() != want
    n_diff, pasted = int(diff.sum()), want.numel()
    print(f"[eval] paste_masks of request 0's {int(valid.sum())} detections at "
          f"{hw[0]}x{hw[1]}: {n_diff} of {pasted} pixels differ between card and "
          f"CPU ({int(want.sum())} set); card {card_s * 1e3:.1f} ms, CPU "
          f"{cpu_s * 1e3:.1f} ms")
    if not bool((~diff | (lo & ~hi)).all()):
        fail("a pasted pixel differs between card and CPU away from 0.5")
    if n_diff > FLIP_SHARE * pasted:
        fail(f"{n_diff} pasted pixels differ between card and CPU")


class Timed:
    """Calls ``fn`` and sums the wall time of its calls."""

    def __init__(self, fn):
        self.fn, self.seconds = fn, 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0


def phase_eval(n_batches: int, seed: int):
    """The evaluation path: ``fpn_mask`` at 800×1024 b1 (spread class
    scores) predicts request 0 and pastes its masks on the card and on the
    CPU, then ``evaluate_dataset`` scores ``n_batches`` synthetic batches
    (launch counters around it: 2 ROIAlign forward launches a batch)."""
    cfg = predict_config("fpn_mask", 1, 800, 1024)
    model = spread_class_scores(MaskRCNN(cfg, seed=seed))
    data = SyntheticDetectionData(cfg, seed=seed)
    batch = data.batch(0)
    det = make_predict_fn(cfg, model)(batch.images, batch.img_hw, batch.scale)
    paste_card_vs_cpu(det, (800, 1024))

    scorers = {name: Timed(getattr(evaluator, name)) for name in
               ("eval_instance_segmentation_voc", "evaluate_coco")}
    for name, timed in scorers.items():
        setattr(evaluator, name, timed)
    cache = {}  # the bucket's predict: its first evaluation warms up
    try:  # and captures, the timed one replays
        t0 = time.perf_counter()
        evaluator.evaluate_dataset(cfg, model, iter(data), n_batches, None, cache)
        torch.cuda.synchronize()
        first_secs = time.perf_counter() - t0
        for timed in scorers.values():
            timed.seconds = 0.0
        reset_launches()
        t0 = time.perf_counter()
        report = evaluator.evaluate_dataset(cfg, model, iter(data), n_batches,
                                            None, cache)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
    finally:
        for name, timed in scorers.items():
            setattr(evaluator, name, timed.fn)
    print(f"[eval] launches over {n_batches} batches: {launches}")
    nms_launches(launches, 2 * n_batches, "eval")
    if pool_counts(launches) != {"roi_align_fwd": 2 * n_batches, "region_scatter": 0}:
        fail(f"expected 2 forward launches per evaluated batch, got {launches}")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in report.values()):
        fail(f"eval report out of [0, 1]: {report}")
    scoring = sum(t.seconds for t in scorers.values())
    print(f"[eval] report over {n_batches} images: " + ", ".join(
        f"{k} {v:.4f}" for k, v in report.items() if not k.startswith("ap/")))
    print(f"[eval] {secs:.3f} s for {n_batches} images (replays; the first "
          f"evaluation, warm-up and capture, {first_secs:.3f} s): "
          f"{secs / n_batches:.3f} s "
          f"an image, of which the numpy scorers {scoring / n_batches:.3f} s "
          f"(VOC {scorers['eval_instance_segmentation_voc'].seconds:.3f} s, "
          f"COCO {scorers['evaluate_coco'].seconds:.3f} s in all); "
          f"{card_name_and_power_limit()}")
    return launches


def resumed_steps(rows: dict, tag: str):
    """The ``main/*`` rows of a 4-step run ``a`` and of ``b``, resumed from
    its step 2, by step, and the worst relative difference of their losses
    at steps 3 and 4, each within ``CLI_LOSS_TOL``."""
    steps = {d: {r["iteration"]: r for r in rs if "main/loss" in r}
             for d, rs in rows.items()}
    if sorted(steps["a"]) != [1, 2, 3, 4] or sorted(steps["b"]) != [3, 4]:
        fail(f"[{tag}] log rows {sorted(steps['a'])} and {sorted(steps['b'])}")
    worst = 0.0
    for it in (3, 4):
        for k, v in steps["a"][it].items():
            if k.endswith("loss"):
                rel = abs(steps["b"][it][k] - v) / max(abs(v), 1e-30)
                worst = max(worst, rel)
                if not np.isfinite(v) or rel > CLI_LOSS_TOL:
                    fail(f"[{tag}] resumed step {it} {k}: {steps['b'][it][k]} vs {v}")
    return steps, worst


def phase_cli(seed: int, preset: str = "fpn_mask", tag: str = "cli",
              hw: str = "256x320", demo: int = 0, after=None):
    """The CLIs in this process, in a temporary directory: ``cli.train
    --preset`` at ``hw`` b2 for 4 steps (snapshots at 2 and 4, an
    evaluation of 2 held-out batches at 4), the same run resumed from its
    step-2 checkpoint, and ``cli.evaluate`` on the step-4 checkpoint. Losses
    of steps 3 and 4 agree, the evaluation reproduces the in-run report and
    detections, and B2 and B1 launch as the steps and evaluations need.
    With ``demo``, ``cli.demo`` then writes that many overlays from the
    step-4 checkpoint; ``after(path)`` is called on that checkpoint last."""
    common = ["--preset", preset, "--image-size", hw, "--batch-size", "2",
              "--iterations", "4", "--snapshot-every", "2", "--eval-every", "4",
              "--eval-batches", "2", "--log-every", "1", "--seed", str(seed)]
    fwd, per_step, scatters = pool_launches(cfg_lib.PRESETS[preset]())
    spy_dets = {}
    make = evaluator.make_predict_fn

    def spy(name):
        def factory(*args, **kwargs):
            predict = make(*args, **kwargs)

            def spied(*a):
                det = predict(*a)
                spy_dets.setdefault(name, []).append(
                    {k: v.clone() for k, v in det._asdict().items() if v is not None})
                return det
            return spied
        return factory

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    launches = {}
    t0 = time.perf_counter()
    try:
        for name in ("run", "resumed", "evaluate"):
            evaluator.make_predict_fn = spy(name)
            torch.cuda.synchronize()
            reset_launches()
            if name == "run":
                train_cli.main(["--out", str(tmp / "a"), *common])
            elif name == "resumed":
                (tmp / "b" / "checkpoints").mkdir(parents=True)
                shutil.copy(tmp / "a" / "checkpoints" / "step_00000002.pt",
                            tmp / "b" / "checkpoints")
                train_cli.main(["--out", str(tmp / "b"), "--resume", *common])
            else:
                report = evaluate_cli.main([
                    "--preset", preset,
                    "--weight", str(tmp / "a" / "checkpoints" / "step_00000004.pt"),
                    "--n-batches", "2", "--seed", str(seed),
                    "--set", f"train.image_size={hw}",
                    "--set", "train.batch_size=2"])
            torch.cuda.synchronize()
            launches[name] = read_launches()
        rows = {d: [json.loads(line) for line in open(tmp / d / "log.jsonl")]
                for d in ("a", "b")}
        if demo:
            evaluator.make_predict_fn = make
            t1 = time.perf_counter()
            paths = demo_cli.main([
                "--preset", preset, "--n", str(demo), "--score-thresh", "0.0",
                "--out", str(tmp / "demo"),
                "--weight", str(tmp / "a" / "checkpoints" / "step_00000004.pt")])
            shapes = [png_size(p) for p in paths]
            print(f"[{tag}] cli.demo wrote {len(paths)} overlays {shapes} in "
                  f"{time.perf_counter() - t1:.1f} s")
            if len(paths) != demo or len(set(shapes)) != 1 or shapes[0] is None:
                fail(f"cli.demo wrote {paths} ({shapes})")
        if after:
            evaluator.make_predict_fn = make
            after(str(tmp / "a" / "checkpoints" / "step_00000004.pt"))
    finally:
        evaluator.make_predict_fn = make
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    print(f"[{tag}] {preset}: launches (train, resumed, evaluate): {launches}")
    want = {"run": {"roi_align_fwd": 4 * per_step + 2 * fwd,
                    "region_scatter": 4 * scatters},
            "resumed": {"roi_align_fwd": 2 * per_step + 2 * fwd,
                        "region_scatter": 2 * scatters},
            "evaluate": {"roi_align_fwd": 2 * fwd, "region_scatter": 0}}
    for name, counts in launches.items():
        nms_launches(counts, None, f"{tag} {name}")
    if {name: pool_counts(counts) for name, counts in launches.items()} != want:
        fail(f"CLI launches {launches}, expected {want}")
    steps, worst = resumed_steps(rows, tag)
    print(f"[{tag}] steps 3-4 resumed from the step-2 checkpoint: worst loss "
          f"difference {worst:.3e} relative; losses "
          + ", ".join(f"{it}: {steps['a'][it]['main/loss']:.5f}" for it in (1, 2, 3, 4)))
    val = [r for r in rows["a"] if "validation/main/map" in r]
    in_run = {k[len("validation/main/"):]: v for k, v in val[0].items()
              if k.startswith("validation/main/")}
    if report.keys() != in_run.keys():
        fail("cli.evaluate report keys differ from the in-run report's")
    err = max(abs(report[k] - in_run[k]) for k in report)
    dets = [max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
            for a, b in zip(spy_dets["run"], spy_dets["evaluate"])]
    print(f"[{tag}] cli.evaluate on the step-4 checkpoint against the in-run "
          f"report: worst field {err:.3e}; detections' worst difference "
          f"{max(dets):.3e} over {len(dets)} batches; map {report['map']:.4f}, "
          f"coco/map {report['coco/map']:.4f}; {secs:.1f} s for the phase")
    if err > CLI_REPORT_TOL or len(dets) != 2 or max(dets) > CLI_REPORT_TOL:
        fail(f"cli.evaluate differs from the in-run evaluation: report {err}, "
             f"detections {dets}")
    return {k: sum(v[k] for v in launches.values()) for k in read_launches()}


def png_size(path) -> tuple[int, int] | None:
    """(height, width) from a PNG file's header, or None if it is none."""
    head = Path(path).read_bytes()[:24]
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    return int.from_bytes(head[20:24], "big"), int.from_bytes(head[16:20], "big")


class ShapeLaunches:
    """Wraps a factory of per-image-size functions (``make_train_step``,
    ``make_predict_fn``): every function it builds adds its calls' kernel
    launches to ``counts["<kind> HxW"]``. With ``capture`` set to an image
    size, the first call at that size keeps copies of its kernel inputs (2
    ROIAlign forwards, 1 region scatter, 2 products) in ``calls``. The
    request graphs of every predict function it builds are kept by image
    size in ``graphs``."""

    def __init__(self, factory, kind: str, counts: dict, capture=None):
        self.factory, self.kind, self.counts = factory, kind, counts
        self.capture, self.calls, self.graphs = capture, None, {}

    def __call__(self, *args, image_size=None, **kwargs):
        fn = self.factory(*args, image_size=image_size, **kwargs)
        hw = tuple(image_size or args[0].train.image_size)
        key = f"{self.kind} {hw[0]}x{hw[1]}"
        if hasattr(fn, "graphs"):
            self.graphs.setdefault(key, []).append(fn.graphs)

        def counted(*a, **k):
            capturing = hw == self.capture and self.calls is None
            if capturing:
                fwd, bwd = Capture(ROI_ALIGN, 2), Capture(SCATTER, 1)
                products = Capture(roi_align_ops._d_regions, 2)
                saved = (roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter,
                         roi_align_ops._d_regions)
                (roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter,
                 roi_align_ops._d_regions) = fwd, bwd, products
            before = read_launches()
            try:
                out = fn(*a, **k)
            finally:
                if capturing:
                    (roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter,
                     roi_align_ops._d_regions) = saved
                    self.calls = (fwd.calls, bwd.calls, products.calls)
            after = read_launches()
            total = self.counts.setdefault(key, dict.fromkeys(after, 0))
            for name in after:
                total[name] += after[name] - before[name]
            return out

        return counted


def coco_run(tmp: Path, coco_root: str, preset: str, iterations: int,
             resume_from: int | None, extra: list, counts: dict):
    """``cli.train --dataset coco --buckets`` (an evaluation at the last
    step), optionally the same run resumed from a middle checkpoint, and
    ``cli.evaluate --dump-results`` on the last checkpoint, with the kernel
    launches of every step and predict counted by image size → (log rows of
    the runs, the evaluate report, the results file, the masks the export
    pasted, the portrait step's kernel inputs)."""
    data = ["--dataset", "coco", "--coco-root", coco_root, "--coco-split", "val",
            "--buckets", COCO_BUCKETS, "--preset", preset, "--seed", "0",
            *extra]  # the presets' batch of 2
    portrait = tuple(int(v) for v in COCO_BUCKETS.split(",")[1].split("x"))
    steps = ShapeLaunches(step_mod.make_train_step, f"{preset} train", counts,
                          capture=portrait)
    predicts = ShapeLaunches(make_predict_fn, f"{preset} predict", counts)
    pasted = []

    def paste_spy(*args, **kwargs):
        out = paste_masks(*args, **kwargs)
        pasted.append(out.cpu().numpy())
        return out

    saved = (step_mod.make_train_step, evaluator.make_predict_fn,
             export_mod.paste_masks)
    step_mod.make_train_step = steps
    evaluator.make_predict_fn = predicts  # the evaluators' and the exports'
    export_mod.paste_masks = paste_spy
    try:
        train = [*data, "--iterations", str(iterations), "--log-every", "1",
                 "--eval-every", str(iterations), "--eval-batches", "2",
                 "--eval-split", "val"]
        train_cli.main(["--out", str(tmp / "a"), "--snapshot-every",
                        str(resume_from or iterations), *train])
        rows = {"a": [json.loads(line) for line in open(tmp / "a" / "log.jsonl")]}
        if resume_from:
            (tmp / "b" / "checkpoints").mkdir(parents=True)
            shutil.copy(tmp / "a" / "checkpoints" / f"step_{resume_from:08d}.pt",
                        tmp / "b" / "checkpoints")
            train_cli.main(["--out", str(tmp / "b"), "--resume", *train])
            rows["b"] = [json.loads(line) for line in open(tmp / "b" / "log.jsonl")]
        report = evaluate_cli.main([
            *data, "--n-batches", "2", "--dump-results", str(tmp / "results.json"),
            "--weight", str(tmp / "a" / "checkpoints" / f"step_{iterations:08d}.pt")])
    finally:
        (step_mod.make_train_step, evaluator.make_predict_fn,
         export_mod.paste_masks) = saved
    with open(tmp / "results.json") as f:
        results = json.load(f)
    for key, made in predicts.graphs.items():
        print(f"[coco] {key}: " + "; ".join(
            f"b{sig[0][0]} {sig[1]} {g.captures} captures {g.replays} replays, "
            + (f"pool {g.reserved_bytes / 2**30:.3f} GiB" if g.captures
               else "eager only (its first request)")
            for graphs in made for sig, g in graphs.items()))
    return rows, report, results, pasted, steps.calls


def check_in_run_report(rows, report, tag: str):
    val = [r for r in rows if any(k.startswith("validation/") for k in r)]
    in_run = {k[len("validation/main/"):]: v for k, v in val[0].items()
              if k.startswith("validation/main/")}
    if report.keys() != in_run.keys():
        fail(f"{tag}: cli.evaluate report keys differ from the in-run report's")
    err = max(abs(report[k] - in_run[k]) for k in report)
    if err > CLI_REPORT_TOL:
        fail(f"{tag}: cli.evaluate differs from the in-run report by {err}")
    return err


def check_results(results, instances: dict, tag: str, keypoint: bool, pasted):
    """Every entry in its image's original coordinates and under the file's
    category ids; every ``segm`` decodes to the mask the export pasted."""
    images = {im["id"]: im for im in instances["images"]}
    cats = {c["id"] for c in instances["categories"]}
    if not results or {e["image_id"] for e in results} != set(images):
        fail(f"{tag}: the results cover images "
             f"{sorted({e['image_id'] for e in results})}, not {sorted(images)}")
    masks = iter(m for per_image in pasted for m in per_image)
    for e in results:
        im = images[e["image_id"]]
        x, y, w, h = e["bbox"]
        if not (x >= -0.01 and y >= -0.01 and x + w <= im["width"] + 0.5
                and y + h <= im["height"] + 0.5):
            fail(f"{tag}: box {e['bbox']} outside image {im}")
        if keypoint:
            if e["category_id"] != 1 or len(e["keypoints"]) != 51:
                fail(f"{tag}: keypoint entry {e['category_id']}, "
                     f"{len(e['keypoints'])} numbers")
            continue
        if e["category_id"] not in cats:
            fail(f"{tag}: category id {e['category_id']} not in the file")
        got = coco_mod.rle_decode(e["segmentation"])
        want = next(masks)
        if got.shape != (im["height"], im["width"]) or not np.array_equal(got, want):
            fail(f"{tag}: a segm does not decode to the mask the export pasted")


def phase_coco_cli(seed: int):
    """COCO-format data through the CLIs, in a temporary directory: a
    directory written from a seed (PNG images, landscape and portrait, all
    three mask forms, a crowd annotation, sparse category ids, people with
    keypoints), ``fpn_mask`` (the file's 3 categories) trained 4 steps at
    the buckets 256x320 and 320x256 with an evaluation at 4, resumed from
    step 2, then ``cli.evaluate --dump-results``; ``fpn_keypoint`` trained 2
    steps, evaluated and dumped the same way. Launches by path and bucket
    shape; B2 and B1 must run at both shapes."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_coco_"))
    counts = {}
    t0 = time.perf_counter()
    try:
        instances = write_coco(str(tmp / "coco"), "val", COCO_SIZES, seed=seed)
        with open(tmp / "coco" / "annotations" / "person_keypoints_val.json") as f:
            people = json.load(f)
        print(f"[coco] {len(COCO_SIZES)} images, "
              f"{len(instances['annotations'])} instance and "
              f"{len(people['annotations'])} person annotations, categories "
              f"{[c['id'] for c in instances['categories']]}; native decoder "
              f"{'loaded' if coco_native.available() else 'absent: numpy and cv2'}")
        (tmp / "mask").mkdir()
        rows, report, results, pasted, calls = coco_run(
            tmp / "mask", str(tmp / "coco"), "fpn_mask", 4, 2,
            ["--set", "model.n_fg_class=3"], counts)
        err = check_in_run_report(rows["a"], report, "coco fpn_mask")
        steps = {d: {r["iteration"]: r for r in rs if "main/loss" in r}
                 for d, rs in rows.items()}
        worst = max(abs(steps["b"][it][k] - v) / max(abs(v), 1e-30)
                    for it in (3, 4) for k, v in steps["a"][it].items()
                    if k.endswith("loss"))
        if worst > CLI_LOSS_TOL:
            fail(f"coco: resumed losses differ by {worst} relative")
        check_results(results, instances, "coco fpn_mask", False, pasted)
        print(f"[coco] fpn_mask: resumed steps 3-4 within {worst:.3e}; "
              f"cli.evaluate equal to the in-run report within {err:.1e} "
              f"(map {report['map']:.4f}); {len(results)} segm results, each "
              f"decoding to the pasted mask, in original coordinates; padding "
              f"waste {steps['a'][4]['main/padding_waste']:.3f}")
        (tmp / "kp").mkdir()
        rows, report, results, _, _ = coco_run(
            tmp / "kp", str(tmp / "coco"), "fpn_keypoint", 2, None, [], counts)
        check_in_run_report(rows["a"], report, "coco fpn_keypoint")
        check_results(results, people, "coco fpn_keypoint", True, [])
        print(f"[coco] fpn_keypoint: cli.evaluate equal to the in-run report "
              f"(ap {report['ap']:.4f}); {len(results)} keypoint results of "
              f"17 x 3")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    print(f"[coco] launches by path and bucket shape: {json.dumps(counts)}; "
          f"{secs:.1f} s for the phase")
    for preset in ("fpn_mask", "fpn_keypoint"):
        for shape in COCO_BUCKETS.split(","):
            train = counts.get(f"{preset} train {shape}", {})
            pred = counts.get(f"{preset} predict {shape}", {})
            if not (train.get(ROI_ALIGN.name) and train.get(SCATTER.name)
                    and pred.get(ROI_ALIGN.name)):
                fail(f"coco {preset} at {shape}: launches train {train}, "
                     f"predict {pred}")
    total = {name: sum(c[name] for c in counts.values()) for name in read_launches()}
    return total, counts, calls


def phase_kp_eval(n_batches: int, seed: int, preset: str = "fpn_keypoint",
                  hw=(800, 1024), tag: str = "kp-eval"):
    """OKS evaluation of the keypoint serving model (``hw`` b1, spread
    class scores) over ``n_batches`` synthetic batches, launch counters
    around it (2 ROIAlign forwards a batch on a pyramid, none on one level
    under the gather pool)."""
    cfg = predict_config(preset, 1, *hw)
    per_batch = pool_launches(cfg)[0]
    model = spread_class_scores(MaskRCNN(cfg, seed=seed))
    data = SyntheticDetectionData(cfg, seed=seed)
    evaluator.evaluate_keypoint_dataset(cfg, model, iter(data), 1)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    report = evaluator.evaluate_keypoint_dataset(cfg, model, iter(data), n_batches)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{tag}] launches over {n_batches} batches: {launches}; report "
          f"{report}; {secs:.3f} s for {n_batches} images, "
          f"{secs / n_batches:.3f} s an image; {card_name_and_power_limit()}")
    nms_launches(launches, 2 * n_batches, tag)
    if pool_counts(launches) != {"roi_align_fwd": per_batch * n_batches,
                                 "region_scatter": 0}:
        fail(f"expected {per_batch} forward launches per evaluated batch, got "
             f"{launches}")
    if set(report) != {"ap", "ap50", "ap75"} or not all(
            0.0 <= v <= 1.0 for v in report.values()):
        fail(f"keypoint eval report {report}")
    return launches


def phase_darknet_kernels_vs_plain(seed: int) -> float:
    """Both kernels against their plain versions at the Darknet presets'
    shapes: one 16×20 level of 256 channels (a 256×320 image) in the pallas
    window geometry (24 cells at C=256); B2 on 10 ROIs of a b1 request
    (``darknet_keypoint``'s ``n_test_post_nms``) at 7×7 and 14×14 and on
    2048 ROIs of a b8 step at 7×7; B1 on those 2048 train windows, bit for
    bit against ``region_scatter_ordered`` and a second call. Each timed
    beside its bound, its plain version and, for B1, ``index_add_``. Also
    how many ROIs span wider than the window and how far the pallas pool
    lies from the gather form → worst f32 error."""
    scales = (1.0 / 16,)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed + 3)
    kernel, plain = ROI_ALIGN, roi_align_cuda.roi_align_region_plain
    scatter_plain = region_scatter_cuda.region_scatter_plain
    worst = 0.0
    for b, n, out in ((1, 10, 7), (1, 10, 14), (8, 2048, 7)):
        feats = [torch.randn(b, *DARKNET_LEVEL, 256, device="cuda", generator=gen)]
        rois, bi, lv = (t.cuda() for t in c4_rois(rng, b, (256, 320), n, 320.0))
        rois = torch.minimum(rois, rois.new_tensor([256.0, 320.0, 256.0, 320.0]))
        flat, row_ids, by, bx = roi_align_ops.pallas_geometry(
            feats, rois, bi, lv, (out, out), scales)
        base, stride = roi_align_ops.window_starts(row_ids)
        args = (flat, base, stride, by, bx)
        err = rel_err(kernel(*args), plain(*args))
        torch.cuda.synchronize()
        ms, plain_ms = time_ms(lambda: kernel(*args)), time_ms(lambda: plain(*args))
        bound = roi_align_bound(*args)
        label = f"Darknet b{b} R={n} {out}x{out}"
        span = ((rois[:, 2:] - rois[:, :2]) / 16).max(dim=1).values
        gather = roi_align_ops.multilevel_roi_align(feats, rois, bi, lv, (out, out),
                                                    scales, impl="gather")
        pallas = roi_align_ops.multilevel_roi_align(feats, rois, bi, lv, (out, out),
                                                    scales, impl="pallas")
        off = (pallas - gather).abs().amax(dim=(1, 2, 3)) / float(gather.abs().max())
        inside = span <= by.shape[2] - 3
        wide = off[~inside] if bool((~inside).any()) else off.new_zeros(1)
        print(f"[dk-kernels] roi_align_fwd {label} pallas window "
              f"{by.shape[2]}x{bx.shape[2]}: err {err:.2e}, {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms; bound bytes {bound['bytes_ms']:.4f} / "
              f"operations {bound['ops_ms']:.4f} ms); pallas vs gather pool: "
              f"{int(inside.sum())} of {n} ROIs span at most {by.shape[2] - 3} "
              f"cells (widest {float(span.max()):.1f}), worst "
              f"{float(off[inside].max()):.2e} of max |gather|; the "
              f"{int((~inside).sum())} wider worst {float(wide.max()):.2e}")
        if not err <= F32_TOL:
            fail(f"roi_align_fwd on {label}: error {err} > {F32_TOL}")
        if not float(off[inside].max()) <= F32_TOL:
            fail(f"pallas pool differs from gather inside its window on {label}")
        worst = max(worst, err)
        if n < 2048:
            continue
        g = torch.randn(n, out, out, 256, device="cuda", generator=gen)
        d_regs = roi_align_ops._d_regions(by, bx, g, F32)
        sargs = (d_regs, base, stride, flat.shape[0], F32)
        t, tx = d_regs.shape[1:3]
        check = scatter_check(SCATTER(*sargs), scatter_plain(*sargs), sargs, label)
        torch.cuda.synchronize()
        ms = time_ms(lambda: SCATTER(*sargs), busy=SCATTER_BUSY)
        plain_ms = time_ms(lambda: scatter_plain(*sargs), runs=7, calls=3)
        b_ms = region_scatter_bound(*sargs)
        print(f"[dk-kernels] region_scatter {label} window {t}x{tx}x256 "
              f"S={flat.shape[0]}: {scatter_skew(base, stride, t, tx, flat.shape[0])}; "
              f"against the exact sum {check['err']:.2e} (worst "
              f"{check['share']:.3f} of an element's bound), {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, index_add_ {index_add_ms(*sargs):.4f}"
              f" ms, bound {max(b_ms['bytes_ms'], b_ms['ops_ms']):.4f} ms); "
              f"equal to region_scatter_ordered and to a second call")
        worst = max(worst, check["err"])
    return worst


def phase_depth_cli(seed: int):
    """``cli.train --preset darknet_keypoint --dataset depth`` at its own
    256×320 b8 on a generated manifest of 240×320 depth frames, in a
    temporary directory: 4 steps (snapshots at 2 and 4, an OKS evaluation
    of 2 held-out batches at 4), the run resumed from step 2 (losses of
    steps 3 and 4 within ``CLI_LOSS_TOL``), the in-run report against
    ``evaluate_keypoint_dataset`` on the step-4 checkpoint and the held-out
    loader (seed + 999, augmented as the JAX CLI's is); the preset's gather
    pool launches no kernel. Then the viewer on a frame with that
    checkpoint (:func:`phase_viewer`)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_depth_"))
    launches = {}
    t0 = time.perf_counter()
    try:
        manifest = write_depth(str(tmp / "frames"), 24, (240, 320), seed=seed)
        common = ["--preset", "darknet_keypoint", "--dataset", "depth",
                  "--depth-manifest", manifest, "--iterations", "4",
                  "--snapshot-every", "2", "--log-every", "1", "--seed", str(seed)]
        for name in ("run", "resumed"):
            torch.cuda.synchronize()
            reset_launches()
            if name == "run":
                train_cli.main(["--out", str(tmp / "a"), "--eval-every", "4",
                                "--eval-batches", "2", *common])
            else:
                (tmp / "b" / "checkpoints").mkdir(parents=True)
                shutil.copy(tmp / "a" / "checkpoints" / "step_00000002.pt",
                            tmp / "b" / "checkpoints")
                train_cli.main(["--out", str(tmp / "b"), "--resume", *common])
            torch.cuda.synchronize()
            launches[name] = read_launches()
        rows = {d: [json.loads(line) for line in open(tmp / d / "log.jsonl")]
                for d in ("a", "b")}
        cfg, _ = train_cli.build_config("darknet_keypoint", None, [])
        state = create_train_state(cfg, MaskRCNN(cfg, seed=seed))
        weight = tmp / "a" / "checkpoints" / "step_00000004.pt"
        state.model.load_state_dict(torch.load(weight, weights_only=False)["model"])
        report = evaluator.evaluate_keypoint_dataset(
            cfg, state.model, iter(DepthKeypointDataset(cfg, manifest,
                                                        seed=seed + 999)), 2)
        secs = time.perf_counter() - t0
        phase_viewer(str(weight), str(tmp / "frames" / "frame_0000.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[dk-depth-cli] launches (train, resumed): {launches}")
    if any(pool_counts(v) != {"roi_align_fwd": 0, "region_scatter": 0}
           for v in launches.values()):
        fail(f"the gather pool launched a kernel: {launches}")
    steps, worst = resumed_steps(rows, "dk-depth-cli")
    val = [r for r in rows["a"] if "validation/main/ap" in r]
    in_run = {k[len("validation/main/"):]: v for k, v in val[0].items()
              if k.startswith("validation/main/")}
    err = max(abs(report[k] - in_run[k]) for k in report)
    elapsed = [round(r["elapsed_time"], 3) for r in rows["a"] if "main/loss" in r]
    print(f"[dk-depth-cli] 4 steps at 256x320 b8 on 24 depth frames, resumed "
          f"from step 2: worst loss difference {worst:.3e} relative; losses "
          + ", ".join(f"{it}: {steps['a'][it]['main/loss']:.5f}" for it in (1, 2, 3, 4))
          + f"; in-run OKS {in_run}, direct evaluation off by {err:.3e}; the "
          f"CLI's elapsed s by step {elapsed}; {secs:.1f} s for the phase")
    if report.keys() != in_run.keys() or err > CLI_REPORT_TOL:
        fail(f"depth in-run report {in_run} vs direct {report}")
    return {k: sum(v[k] for v in launches.values()) for k in launches["run"]}


def phase_viewer(weight: str, frame: str):
    """``cli.viewer --image FRAME.npz --no-display --benchmark N`` with a
    checkpoint: the overlay PNG is written at the frame's size, and the
    EMA frame rate of N frames (resize, predict, keypoint decode) is the
    card's viewer FPS."""
    args = viewer_cli.parse_args(["--image", frame, "--no-display", "--weight",
                                  weight, "--benchmark", str(N_VIEWER_FRAMES)])
    viewer = viewer_cli.Viewer(args)
    reset_launches()
    out = viewer.run_image(frame)
    launches = read_launches()
    size = png_size(out)
    depth_hw = tuple(np.load(frame)["depth"].shape)
    times = []
    img = viewer_cli.normalize_depth(np.load(frame)["depth"])
    for _ in range(N_VIEWER_FRAMES):
        t0 = time.perf_counter()
        viewer.infer_frame(img)
        times.append(time.perf_counter() - t0)
    print(f"[dk-viewer] {Path(out).name} {size} for a {depth_hw} frame; "
          f"fps(EMA) over {N_VIEWER_FRAMES} frames {viewer.fps_ema:.2f} "
          f"(graphed: replays from the second frame); "
          f"median frame {1e3 * statistics.median(times):.3f} ms over "
          f"{N_VIEWER_FRAMES} more (host clock, {card_name_and_power_limit()}); "
          f"launches {launches}")
    if size != depth_hw or not viewer.fps_ema > 0:
        fail(f"viewer wrote {out} at {size}, fps {viewer.fps_ema}")


def dp_rank(rank: int, world: int, preset: str, hw, batch: int, seed: int,
            steps: int) -> dict:
    """One rank of the ``dp-gloo`` phase, on the card: rank 0's seeded
    weights (the other rank starts from another seed) broadcast by
    ``replicate``, the RPN's shared conv zeroed, one step on this rank's
    rows of batch 0 (its metrics, parameters and buffers, and the kernels'
    launches), then ``steps`` more, each timed alone (host clock around a
    synchronised step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = predict_config(preset, batch, *hw)
    model = quiet_rpn(MaskRCNN(cfg, seed=seed + rank))
    dp.replicate(model)
    start = dp.parameter_digest(model)
    state = create_train_state(cfg, model, seed)
    step = make_train_step(cfg)
    data = SyntheticDetectionData(cfg, seed=seed)
    batches = [dp.shard_rows(data.batch(i), rank, world) for i in range(steps + 1)]
    torch.cuda.synchronize()
    reset_launches()
    metrics = {k: float(v) for k, v in step(state, batches[0]).items()}
    torch.cuda.synchronize()
    launches = read_launches()
    after = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    digest = dp.parameter_digest(model)
    times = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        step(state, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"rank_world": dp.rank_world(), "metrics": metrics, "launches": launches,
            "state": after, "digest": digest, "start": start, "times": times,
            "final": dp.parameter_digest(model)}


def phase_dp_gloo(seed: int, preset: str, hw, batch: int, tag: str) -> dict:
    """Two processes on the one card joined by gloo (which takes CUDA
    tensors) take one step of ``preset`` at ``hw`` with the global ``batch``
    split between them, from the same weights (the RPN's shared conv
    zeroed, so every run proposes and samples the same ROIs) and the same
    sampler seed as one step of the 1-process train step on the card: the
    ranks' losses and updates are held to it as the card is held to the
    CPU (:func:`hold_step`), their BatchNorm statistics within
    ``DP_STATS_TOL``, and their parameters must be equal in bits. Each rank
    counts its own kernel launches: the FPN pair's 2 and 1 a step. Then
    ``DP_TIMED_STEPS`` more steps give the per-rank step time (two ranks
    share one card: a functional number, not a scaling one)."""
    cfg = predict_config(preset, batch, *hw)
    _, per_step, scatters = pool_launches(cfg)
    t0 = time.perf_counter()
    model = quiet_rpn(MaskRCNN(cfg, seed=seed))
    start = dp.parameter_digest(model)
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model, seed)
    want = {k: float(v) for k, v in make_train_step(cfg)(
        state, SyntheticDetectionData(cfg, seed=seed).batch(0)).items()}
    single = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model, state
    torch.cuda.empty_cache()
    ranks = dp.spawn_ranks(dp_rank, 2, preset, hw, batch, seed, DP_TIMED_STEPS)
    secs = time.perf_counter() - t0
    print(f"[{tag}] {preset} {hw[0]}x{hw[1]}, global b{batch} over 2 gloo "
          f"processes on {torch.cuda.get_device_name(0)} ({batch // 2} images a "
          f"rank), {cfg.model.n_fg_class} classes, freeze_bn "
          f"{cfg.model.freeze_bn}: {secs:.1f} s for the phase")
    if [r["rank_world"] for r in ranks] != [(0, 2), (1, 2)]:
        fail(f"[{tag}] ranks {[r['rank_world'] for r in ranks]}")
    if any(r["start"] != start for r in ranks):
        fail(f"[{tag}] replicate did not give every rank rank 0's weights")
    if ranks[0]["digest"] != ranks[1]["digest"] or ranks[0]["final"] != ranks[1]["final"]:
        fail(f"[{tag}] the ranks' parameters differ after the steps")
    stats = [k for k in single if k.endswith(("running_mean", "running_var"))]
    cpu_before = {k: v for k, v in before.items() if k not in stats}
    for r, out in enumerate(ranks):
        print(f"[{tag}] rank {r}: " + ", ".join(
            f"{k} {v:.6f}" for k, v in out["metrics"].items())
            + f"; launches {out['launches']}")
        nms_launches(out["launches"], 1, f"{tag} rank {r}")
        if pool_counts(out["launches"]) != {"roi_align_fwd": per_step,
                                            "region_scatter": scatters}:
            fail(f"[{tag}] rank {r} launched {out['launches']}, expected "
                 f"{per_step} forward and {scatters} region scatters")
        got_up = {k: out["state"][k] - cpu_before[k] for k in cpu_before}
        want_up = {k: single[k] - cpu_before[k] for k in cpu_before}
        hold_step(f"{tag} rank {r}", cfg, out["metrics"], got_up, want, want_up,
                  cpu_before, "2-rank", "1-process")
    worst = max((float((ranks[0]["state"][k] - single[k]).abs().max())
                 / max(1.0, float(single[k].abs().max())) for k in stats),
                default=0.0)
    moved = sum(not torch.equal(single[k], before[k]) for k in stats)
    print(f"[{tag}] BatchNorm running statistics: {moved} of {len(stats)} moved; "
          f"2-rank vs 1-process worst {worst:.3e} of max(1, |statistic|); "
          f"parameters equal in bits on both ranks")
    if worst > DP_STATS_TOL:
        fail(f"[{tag}] running statistics differ by {worst}")
    times = [t for out in ranks for t in out["times"]]
    print(f"[{tag}] per-rank step {', '.join(f'{t:.1f}' for t in times)} ms "
          f"(2 ranks sharing one card; host clock around synchronised steps) "
          f"on {card_name_and_power_limit()}")
    return {f"rank{r}": out["launches"] for r, out in enumerate(ranks)}


def phase_dp_nccl(seed: int) -> None:
    """``cli.train --data-parallel`` under ``torchrun --nproc_per_node 1``
    (one NCCL rank on the card), ``tiny_test`` for 4 steps with snapshots at
    2 and 4, resumed once from step 2, against the same run without
    ``--data-parallel`` in this process: losses within ``CLI_LOSS_TOL``."""
    common = ["--preset", "tiny_test", "--iterations", "4", "--snapshot-every", "2",
              "--log-every", "1", "--seed", str(seed)]
    root = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    t0 = time.perf_counter()
    try:
        train_cli.main(["--out", str(tmp / "single"), *common])

        def torchrun(out, *extra):
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1", "-m", "maskrcnn_tpu_torch.cli.train",
                 "--data-parallel", "--out", str(out), *extra, *common],
                cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"[dp-nccl] torchrun exited {proc.returncode}:\n"
                     f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            return proc.stdout

        out = torchrun(tmp / "dp")
        (tmp / "resumed" / "checkpoints").mkdir(parents=True)
        shutil.copy(tmp / "dp" / "checkpoints" / "step_00000002.pt",
                    tmp / "resumed" / "checkpoints")
        torchrun(tmp / "resumed", "--resume")
        rows = {d: [json.loads(line) for line in open(tmp / d / "log.jsonl")]
                for d in ("single", "dp", "resumed")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = next((ln for ln in out.splitlines() if ln.startswith("[dp] rank 0 of 1")), "")
    print(f"[dp-nccl] {line}")
    if "over nccl" not in line:
        fail(f"[dp-nccl] the CLI's rank line: {line!r}")
    steps, worst = resumed_steps({"a": rows["dp"], "b": rows["resumed"]}, "dp-nccl")
    single = {r["iteration"]: r for r in rows["single"] if "main/loss" in r}
    off = max(abs(steps["a"][it][k] - v) / max(abs(v), 1e-30)
              for it, row in single.items() for k, v in row.items()
              if k.endswith("loss"))
    print(f"[dp-nccl] tiny_test 4 steps under torchrun (1 NCCL rank) against "
          f"the same run without --data-parallel: worst loss {off:.3e} "
          f"relative; resumed from step 2: {worst:.3e}; "
          f"{time.perf_counter() - t0:.1f} s for the phase")
    if off > CLI_LOSS_TOL:
        fail(f"[dp-nccl] the DP run's losses differ from the plain run's by {off}")


PRETRAINED = {"fpn_mask": ("fpn", "fpn", (800, 1024)), "c4_res5": ("c4", "res5", (800, 1024)),
              "tiny_test": ("darknet", "fpn", (128, 160))}  # preset: its npz
#   (backbone, head) and the request's size


def phase_pretrained(seed: int) -> dict:
    """For each backbone an npz emitted in chainer's ``save_npz`` layout
    (full serialized model, the preset's classes) is loaded loosely into a
    model on the card and into one on the CPU: equal tensors, bit for bit;
    then one request with those weights on the card (finite boxes and
    scores)."""
    launches = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_npz_"))
    try:
        for preset, (backbone, head, hw) in PRETRAINED.items():
            t0 = time.perf_counter()
            cfg = predict_config(preset, 1, *hw)
            path = tmp / f"{preset}.npz"
            np.savez(path, **emit_model_npz(backbone, head,
                                            n_fg_class=cfg.model.n_fg_class,
                                            seed=seed))
            models = {}
            for device in ("cpu", "cuda"):
                models[device] = MaskRCNN(cfg, device=device, seed=seed)
                n = load_pretrained_npz(models[device], str(path), backbone, head,
                                        cfg.model.n_mask_convs, verbose=False)
            want = models["cpu"].state_dict()
            unequal = [k for k, v in models["cuda"].state_dict().items()
                       if not torch.equal(v.cpu(), want[k])]
            if unequal:
                fail(f"[pretrained] {preset}: card and CPU loads differ in {unequal[:5]}")
            torch.cuda.synchronize()
            reset_launches()
            det = make_predict_fn(cfg, models["cuda"])(
                *SyntheticRequests(cfg, seed=seed).batch(0))
            torch.cuda.synchronize()
            launches[preset] = read_launches()
            finite = bool(torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all())
            print(f"[pretrained] {preset}: {n[0]} parameter + {n[1]} statistic "
                  f"tensors from a {backbone}/{head} npz, card equal to CPU on "
                  f"all {len(want)}; one {hw[0]}x{hw[1]} request: "
                  f"{int(det.valid.sum())} detections, finite {finite}; "
                  f"{time.perf_counter() - t0:.1f} s")
            if not finite or n[0] == 0:
                fail(f"[pretrained] {preset}: loaded {n}, finite {finite}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: sum(v[k] for v in launches.values()) for k in read_launches()}


def phase_diag(weight: str, preset: str, hw: str, seed: int) -> dict:
    """``tools/diag_checkpoint.py`` on a checkpoint the CLI wrote: its four
    stages on the card, with the kernels' launches (the train step's, the
    box head's pool and predict's)."""
    fwd, per_step, scatters = pool_launches(cfg_lib.PRESETS[preset]())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    stages = diag_checkpoint.main(["--weight", weight, "--preset", preset,
                                   "--image-size", hw, "--batch", "2",
                                   "--seed", str(seed)])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[diag] {preset} {hw} b2 on the step-4 checkpoint: loss "
          f"{stages['loss']['loss']:.5f}, proposals "
          f"{[p['valid'] for p in stages['proposals']]}, top foreground "
          f"probability {[b and round(b['max_fg'], 4) for b in stages['box']]}, "
          f"detections {[d['n'] for d in stages['detections']]}; launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s")
    # the train step's, the box head's pool on the proposals (one), predict's
    want = {"roi_align_fwd": per_step + 1 + fwd, "region_scatter": scatters}
    nms_launches(launches, None, "diag")
    if (pool_counts(launches) != want
            or not np.isfinite(list(stages["loss"].values())).all()):
        fail(f"[diag] launches {launches} (expected {want}), loss {stages['loss']}")
    return launches


def phase_profile(seed: int) -> dict:
    """``cli.train --profile-dir`` on ``tiny_test`` for 21 steps under
    ``roi_align="pallas"`` (its gather pool launches no kernel): the trace
    of steps 11-20 must exist and name both kernels, 2 launches each a step."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_profile_"))
    t0 = time.perf_counter()
    try:
        torch.cuda.synchronize()
        reset_launches()
        train_cli.main(["--preset", "tiny_test", "--iterations", "21",
                        "--snapshot-every", "21", "--log-every", "21",
                        "--steps-per-dispatch", "1",  # eager steps, traced
                        "--seed", str(seed), "--set", "model.roi_align=pallas",
                        "--profile-dir", str(tmp / "trace"), "--out", str(tmp / "run")])
        torch.cuda.synchronize()
        launches = read_launches()
        path = tmp / "trace" / "trace_rank0.json"
        size = path.stat().st_size
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kernels = {name: sum(1 for e in events if e.get("cat") == "kernel"
                         and name in e.get("name", ""))
               for name in ("roi_align_fwd_kernel", "region_scatter_kernel")}
    print(f"[profile] tiny_test 21 steps under pallas with --profile-dir: trace "
          f"of {size / 2**20:.1f} MiB, {len(events)} events; device kernels "
          f"in it {kernels}; launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    if kernels != {"roi_align_fwd_kernel": 20, "region_scatter_kernel": 20}:
        fail(f"[profile] the trace holds {kernels}, expected 20 launches of each "
             "kernel over steps 11-20")
    nms_launches(launches, None, "profile")
    if pool_counts(launches) != {"roi_align_fwd": 42, "region_scatter": 42}:
        fail(f"[profile] launches {launches}")
    return launches


def everything(state) -> dict:
    """Copies of a train state's tensors: parameters, buffers, momentum."""
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        if p in state.optimizer.state:
            out[f"momentum.{i}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    return out


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (a warning where an op has none): the card then repeats
    a train step bit for bit."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)


def phase_chain(seed: int, preset: str, hw, batch: int, tag: str) -> dict:
    """Chained dispatch on the card: ``make_train_step(cfg, chain=CHAIN_K)``
    (its first call: one eager step, the capture of a CUDA graph of the
    step, CHAIN_K - 1 replays) against CHAIN_K eager steps from a copy of
    the same state (same seed: same weights and sampler generator), on the
    same batches. By default the card does not repeat its float32 sums bit
    for bit (cuDNN's backward algorithms, the atomics of index gradients:
    two eager runs part by 1e-3 in a loss by the fourth step), so both run
    under deterministic algorithms, where two eager runs agree in every
    bit, and the graphed steps must equal the eager ones in every bit:
    the losses of each step, the parameters, buffers and momentum after
    them, and the sampler generator. Launch counters around the chained
    call (replays included): per step B2 and B1 as the step's pool gives
    them, NMS once a step (the batch in one call). Then, with the default
    algorithms, fresh
    states time steps in turns: CHAIN_K eager steps, a chain, a chain,
    CHAIN_K eager steps (CUDA events, after a warm-up chain each); and for
    ``fpn_mask`` one eager step with its batch already on the card runs
    under ``torch.cuda.set_sync_debug_mode("error")``."""
    cfg = predict_config(preset, batch, *hw)
    _, per_step, scatters = pool_launches(cfg)
    data = SyntheticDetectionData(cfg, seed=seed)
    batches = [data.batch(i) for i in range(2 * CHAIN_K)]
    first, later = (step_mod.stack_batches(batches[:CHAIN_K]),
                    step_mod.stack_batches(batches[CHAIN_K:]))

    def fresh():
        return create_train_state(cfg, MaskRCNN(cfg, seed=seed), seed)

    with deterministic():
        step = make_train_step(cfg)
        chained = make_train_step(cfg, chain=CHAIN_K)
        eager_state, graph_state = fresh(), fresh()
        eager = [step(eager_state, b) for b in batches[:CHAIN_K]]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        metrics = chained(graph_state, first)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_launches()
    want = {ROI_ALIGN.name: per_step * CHAIN_K, SCATTER.name: scatters * CHAIN_K,
            NMS.name: CHAIN_K}
    print(f"[{tag}] {preset} {hw[0]}x{hw[1]} b{batch}: chain={CHAIN_K}'s first "
          f"call (an eager step, the capture, {CHAIN_K - 1} replays) in "
          f"{first_s:.2f} s; launches {launches}")
    if launches != want:
        fail(f"[{tag}] launches {launches}, expected {want}")
    for i in range(CHAIN_K):
        print(f"[{tag}] step {i + 1}: " + ", ".join(
            f"{k} {float(v[i]):.6f}" for k, v in metrics.items()))
        for k, v in eager[i].items():
            if not torch.equal(metrics[k][i], v):
                fail(f"[{tag}] step {i + 1}: {k} graphed {float(metrics[k][i])}, "
                     f"eager {float(v)}")
    want_t, got_t = everything(eager_state), everything(graph_state)
    unequal = [k for k in want_t if not torch.equal(want_t[k], got_t[k])]
    if unequal or graph_state.step != CHAIN_K or not torch.equal(
            graph_state.generator.get_state(), eager_state.generator.get_state()):
        fail(f"[{tag}] after the chain: tensors unlike the eager run's "
             f"{unequal[:5]} of {len(want_t)}, step {graph_state.step}")
    print(f"[{tag}] deterministic algorithms: the {CHAIN_K} graphed steps equal "
          f"the eager ones in every bit (losses, {len(want_t)} tensors, the "
          "generator)")
    del eager_state, graph_state, step, chained
    step = make_train_step(cfg)
    chained = make_train_step(cfg, chain=CHAIN_K)
    eager_state, graph_state = fresh(), fresh()
    for b in batches[:CHAIN_K]:
        step(eager_state, b)
    chained(graph_state, first)
    times = {"eager": [], "graphed": []}
    for kind in ("eager", "graphed", "graphed", "eager"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if kind == "eager":
            for b in batches[CHAIN_K:]:
                step(eager_state, b)
        else:
            chained(graph_state, later)
        end.record()
        end.synchronize()
        times[kind].append(start.elapsed_time(end) / CHAIN_K)
    print(f"[{tag}] ms per step, in turns: eager {times['eager'][0]:.2f}, "
          f"graphed {times['graphed'][0]:.2f}, graphed {times['graphed'][1]:.2f}, "
          f"eager {times['eager'][1]:.2f}; {card_name_and_power_limit()}")
    if preset == "fpn_mask":
        on_card = step_mod.to_device(batches[0], eager_state.model.device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(eager_state, on_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[{tag}] one eager step under set_sync_debug_mode('error'): "
              "no host sync")
    return launches


def phase_chain_cli(seed: int) -> dict:
    """``cli.train`` on the card at its default K: ``fpn_mask`` at 256×320
    b2, 8 steps, logs and snapshots every 4 (so K=4, the JAX rule's largest
    divisor of 4, 4 and 8 under 20), resumed from step 4 (K=4 again), and
    the same run with ``--steps-per-dispatch 1``, all under deterministic
    algorithms (with the default ones eight steps part by 3e-3 in a loss,
    and the resumed run's step 8 by 8e-3): the logged losses equal the K=1
    run's bit for bit, and the resumed run's step 8 the uninterrupted
    run's; launches, replays included, B2 2, B1 1 and NMS 1 a step."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_chain_cli_"))
    common = ["--preset", "fpn_mask", "--image-size", "256x320",
              "--batch-size", "2", "--iterations", "8", "--snapshot-every", "4",
              "--log-every", "4", "--seed", str(seed)]
    launches, said = {}, {}
    t0 = time.perf_counter()
    try:
        for name in ("a", "resumed", "k1"):
            argv = ["--out", str(tmp / name), *common]
            if name == "resumed":
                (tmp / name / "checkpoints").mkdir(parents=True)
                shutil.copy(tmp / "a" / "checkpoints" / "step_00000004.pt",
                            tmp / name / "checkpoints")
                argv.append("--resume")
            if name == "k1":
                argv += ["--steps-per-dispatch", "1"]
            torch.cuda.synchronize()
            reset_launches()
            out = io.StringIO()
            with contextlib.redirect_stdout(out), deterministic():
                train_cli.main(argv)
            torch.cuda.synchronize()
            launches[name] = read_launches()
            said[name] = [ln for ln in out.getvalue().splitlines()
                          if ln.startswith("[dispatch]")]
        rows = {d: [r for r in (json.loads(line) for line in open(tmp / d / "log.jsonl"))
                    if "main/loss" in r] for d in ("a", "resumed", "k1")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[chain-cli] fpn_mask 256x320 b2, 8 steps at the default K: "
          f"{said}; launches {launches}; {time.perf_counter() - t0:.1f} s")
    want = {n: {ROI_ALIGN.name: 2 * k, SCATTER.name: k, NMS.name: k}
            for n, k in (("a", 8), ("resumed", 4), ("k1", 8))}
    if launches != want:
        fail(f"[chain-cli] launches {launches}, expected {want}")
    if (said["a"] != ["[dispatch] chaining 4 steps per call of the step"]
            or said["resumed"] != said["a"] or said["k1"]):
        fail(f"[chain-cli] chains chosen: {said}")
    steps = {name: {r["iteration"]: r["main/loss"] for r in rows[name]}
             for name in rows}
    print(f"[chain-cli] logged losses: {steps}")
    if sorted(steps["a"]) != [1, 4, 8] or sorted(steps["resumed"]) != [8]:
        fail(f"[chain-cli] logged steps {steps}")
    if steps["a"] != steps["k1"] or steps["resumed"][8] != steps["a"][8]:
        fail("[chain-cli] the K=4 run's losses are not the K=1 run's, or the "
             "resumed run's not the uninterrupted run's")
    print("[chain-cli] K=4 equals K=1 at every logged step, and the resumed "
          "step 8 the uninterrupted one, bit for bit")
    return {k: sum(v[k] for v in launches.values()) for k in read_launches()}


def phase_bench_validate(seed: int):
    """``bench-validate`` (the module's docstring, phase 24)."""
    t0 = time.perf_counter()
    for preset, dtype, pools in BENCH_VALIDATE:
        tag = f"[bench-validate] {preset} {dtype}"
        record = bench.bench_train(bench.parse_args(
            ["--mode", "train", "--preset", preset, "--dtype", dtype,
             "--steps", str(BENCH_STEPS)]))
        launches = record["kernel_launches_per_step"]
        print(f"{tag}: {json.dumps({k: record.get(k) for k in BENCH_KEYS})}; "
              f"launches a step {launches}; {card_name_and_power_limit()}")
        if record.get("suspect"):
            print(f"{tag}: suspect: {record['suspect_reason']}")
        flops, mfu = record.get("step_flops"), record.get("implied_mfu")
        if not flops or flops <= 0:
            fail(f"{tag}: step_flops {flops}")
        if mfu is None or not 0 < mfu <= bench.MFU_SUSPECT_BOUND:
            fail(f"{tag}: implied_mfu {mfu} outside (0, {bench.MFU_SUSPECT_BOUND}]")
        want = {**pools, NMS.name: 1}
        if launches != want:
            fail(f"{tag}: launches a step {launches}, expected {want}")
    cfg = cfg_lib.tiny_test()
    batch = SyntheticDetectionData(cfg, seed=seed).batch(0)
    counts = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(cfg, MaskRCNN(cfg, seed=seed, device=dev))
        step = make_train_step(cfg)
        if dev == "cpu":
            counts[dev] = bench.step_flops(step, state, batch)
            continue
        step(state, batch)  # cuBLAS and cuDNN set up outside the check
        on_card = step_mod.to_device(batch, state.model.device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            counts[dev] = bench.step_flops(step, state, on_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    print(f"[bench-validate] tiny_test 128x160 b2 step FLOPs: card "
          f"{counts['cuda']}, CPU {counts['cpu']} (counted on the card under "
          f"set_sync_debug_mode('error')); {time.perf_counter() - t0:.1f} s")
    if counts["cuda"] != counts["cpu"]:
        fail(f"[bench-validate] tiny_test's count on the card {counts['cuda']} "
             f"differs from the CPU's {counts['cpu']}")


def nms_b8_call(seed: int) -> tuple:
    """The RPN's NMS call of an ``fpn_mask`` 800×1024 b8 batch at the train
    budgets (the JAX bench's train batch): eight problems of 12000 boxes
    from the float32 model's own RPN outputs (``bench.time_train_proposals``,
    one run, the call captured)."""
    cfg = predict_config("fpn_mask", 8, 800, 1024)
    model = MaskRCNN(cfg, seed=seed)
    capture = Capture(NMS, 1)
    nms_ops.nms_greedy = capture
    try:
        took = time_train_proposals(
            cfg, model, SyntheticDetectionData(cfg, seed=seed).batch(0), runs=1)
    finally:
        nms_ops.nms_greedy = NMS
    print(f"[kernels] fpn_mask 800x1024 b8 proposals at 12000/2000: "
          f"{took['proposals_ms']:.3f} ms (one run, the first), valid per "
          f"image {took['proposals_valid_per_image']}")
    del model
    return capture.calls[0]


def nms_call(args, label: str, plain: bool = True) -> dict:
    """One NMS call: its keep mask held to the plain version's (the Jacobi
    loop, problem by problem) up to each ``n_out``-th kept box, so
    ``nms_padded``'s ``(indices, valid)`` are equal; timed whole, and as its
    mask pass and its walk apart, beside the plain version (when ``plain``)
    and the bound of the work these inputs need (each box compared with
    the kept boxes before it, up to the ``n_out``-th kept; the boxes,
    validity and keep mask moved once), with the dense count beside it
    (every pair of the upper triangle; the mask's bytes); the walk's steps
    (the most any problem walks: they walk at once) and microseconds a
    step."""
    boxes_s, valid_s, thresh, n_out = args
    got = NMS(*args)
    want = torch.cat([nms_cuda.nms_keep_plain(b[None], v[None], thresh, n_out)
                      for b, v in zip(boxes_s, valid_s)])
    if not torch.equal(kept_prefix(got, n_out), kept_prefix(want, n_out)):
        fail(f"nms_greedy on the {label} call {tuple(valid_s.shape)} differs "
             "from its plain version")
    mask_pass, walk = NMS.parts(*args)
    mask_pass()
    if not torch.equal(walk(), got):
        fail(f"nms_greedy on the {label} call: the walk launched alone differs")
    work = nms_cuda.nms_work(want, n_out)
    out = {"shape": list(valid_s.shape), "n_out": n_out,
           "kept": int(kept_prefix(want, n_out).sum()),
           "ms": time_ms(lambda: NMS(*args)), "mask_ms": time_ms(mask_pass),
           "walk_ms": time_ms(walk), "walk_steps": work["max_steps"],
           "plain_ms": (time_ms(lambda: nms_cuda.nms_keep_plain(*args), runs=7,
                                calls=3) if plain else None),
           "bytes_ms": 1e3 * work["bytes"] / HBM_BYTES_PER_S,
           "ops_ms": 1e3 * work["flops"] / F32_FLOPS,
           "dense_ops_ms": 1e3 * work["dense_flops"] / F32_FLOPS,
           "mask_bytes_ms": 1e3 * work["mask_bytes"] / HBM_BYTES_PER_S,
           "pairs": work["pairs"]}
    out["walk_us_per_step"] = 1e3 * out["walk_ms"] / max(work["max_steps"], 1)
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    plain_ms = "not timed" if out["plain_ms"] is None else f"{out['plain_ms']:.4f} ms"
    print(f"[kernels] nms_greedy {label} call {tuple(valid_s.shape)} (threshold "
          f"{thresh}, n_out {n_out}, {out['kept']} kept): {out['ms']:.4f} ms "
          f"(mask pass {out['mask_ms']:.4f}, walk {out['walk_ms']:.4f}: "
          f"{work['max_steps']} steps, {out['walk_us_per_step']:.3f} µs a step; "
          f"steps by problem {work['steps']}), plain {plain_ms}, bound bytes "
          f"{out['bytes_ms']:.5f} / operations {out['ops_ms']:.5f} ms "
          f"({work['pairs']} pairs; dense: {out['dense_ops_ms']:.4f} ms of "
          f"operations, the mask's bytes {out['mask_bytes_ms']:.4f} ms); keep "
          f"mask equal to the plain version's up to the n_out-th kept box")
    return out


def nms_entry(paths: dict, b8_call: tuple) -> dict:
    """The NMS kernel on the inputs the f32 request and train step gave it
    (request 0's two calls, the warm-up step's one call of both images) and
    on the first image of that step alone (P=1) and a b8 batch's call
    (P=8), each held and timed by :func:`nms_call`. The entry's ``ms``,
    ``plain_ms`` and bound sum the request's and the step's calls, as the
    paths run them; ``calls`` lists every call's numbers."""
    calls = {}
    for path in ("predict", "train"):
        for i, args in enumerate(NMS_CALLS[path]):
            calls[f"{path}_{i}"] = nms_call(args, f"{path}-path")
    boxes_s, valid_s, thresh, n_out = NMS_CALLS["train"][0]
    calls["train_p1"] = nms_call((boxes_s[:1].contiguous(), valid_s[:1].contiguous(),
                                  thresh, n_out), "train-path first image", False)
    calls["fpn_mask_b8"] = nms_call(b8_call, "fpn_mask b8 train", False)
    on_paths = [v for k, v in calls.items() if k.startswith(("predict_", "train_"))
                and k != "train_p1"]
    out = {key: sum(v[key] for v in on_paths)
           for key in ("ms", "plain_ms", "mask_ms", "walk_ms")}
    bytes_ms = sum(v["bytes_ms"] for v in on_paths)
    ops_ms = sum(v["ops_ms"] for v in on_paths)
    out["max_abs_err"] = 0.0  # keep masks are compared for equality
    out["bound_ms"] = max(bytes_ms, ops_ms)
    out["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    out["bound_dense_ms"] = max(sum(v["dense_ops_ms"] for v in on_paths),
                                sum(v["mask_bytes_ms"] for v in on_paths))
    n = {path: v[0].get(NMS.name, 0) for path, v in paths.items()}
    return {"name": NMS.name, "route": "cuda", "source": KERNELS[2][2],
            "replaces": KERNELS[2][3], "launches": sum(n.values()),
            "launches_by_path": n, **out, "calls": calls,
            "library_ms": None}  # torchvision, which has an NMS, is absent


def kept_prefix(keep: torch.Tensor, n_out: int) -> torch.Tensor:
    """The kept boxes of a keep mask (P, N) up to each row's ``n_out``-th:
    equal prefixes compact to equal ``(indices, valid)`` in ``nms_padded``."""
    return keep & (torch.cumsum(keep.long(), dim=-1) <= n_out)


def time_calls(kernel, plain, bound, calls, label: str) -> dict:
    """Hold ``kernel`` against ``plain`` on each of ``calls`` (a path's own
    inputs) and time both → sums over the calls."""
    out = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0, rel_err=0.0)
    bounds = {}
    for args in calls:
        got, want = kernel(*args), plain(*args)
        rel = rel_err(got, want)
        check = ""
        if kernel.name == SCATTER.name:
            c = scatter_check(got, want, args, f"the {label} path's inputs")
            check = (f", against the exact sum {c['err']:.2e} (worst "
                     f"{c['share']:.3f} of an element's rounding bound); "
                     f"equal to region_scatter_ordered and to a second call")
        elif not rel <= F32_TOL:
            fail(f"{kernel.name} on the {label} path's inputs: error "
                 f"{rel} > {F32_TOL}")
        busy = SCATTER_BUSY if kernel.name == SCATTER.name else BUSY_CYCLES
        ms = time_ms(lambda: kernel(*args), busy=busy)
        plain_ms = time_ms(lambda: plain(*args), runs=7, calls=3)
        b = bound(*args)
        dense = ""
        if kernel.name == SCATTER.name:  # its bookkeeping alone, in the call
            d_regs, base, stride, s_rows, _ = args
            sort_ms = time_ms(lambda: SCATTER.sorted_segments(
                base, stride, *d_regs.shape[1:3], s_rows), busy=busy)
            dense = f" (of which the sort of its window rows {sort_ms:.4f} ms)"
            out["sort_ms"] = out.get("sort_ms", 0.0) + sort_ms
        if "reached" in b:  # the ROIAlign forward's bound
            dense = (f" (dense count: bytes {b['dense_bytes_ms']:.4f} / operations "
                     f"{b['dense_ops_ms']:.4f} ms; {b.pop('reached'):.3f} of the "
                     f"windows reached)")
        print(f"[kernels] {kernel.name} {label}-path call {call_shape(kernel, args)}: "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound bytes "
              f"{b['bytes_ms']:.4f} / operations {b['ops_ms']:.4f} ms{dense}; "
              f"the bound is {max(b['bytes_ms'], b['ops_ms']) / ms:.3f} of the "
              f"kernel's time; error {rel:.2e} of max |plain|{check}")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        for key, value in b.items():
            bounds[key] = bounds.get(key, 0.0) + value
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((got.float() - want.float()).abs().max()))
        out["rel_err"] = max(out["rel_err"], rel)
    out["bound_ms"] = max(bounds["bytes_ms"], bounds["ops_ms"])
    out["bound_by"] = "bytes" if bounds["bytes_ms"] >= bounds["ops_ms"] else "operations"
    if "dense_ops_ms" in bounds:
        out["bound_dense_ms"] = max(bounds["dense_bytes_ms"], bounds["dense_ops_ms"])
    return out


def call_shape(kernel, args) -> tuple:
    """(R, oh, ow) of a ROIAlign forward call, else its first argument's shape."""
    if kernel.name == ROI_ALIGN.name:
        return tuple(args[3].shape[:2]) + tuple(args[4].shape[1:2])
    return tuple(args[0].shape)


def d_regs_matmul_ms(product_calls) -> float:
    """Time of the matrix products ``Byᵀ·g·Bx`` that build the region
    scatter's input, on the cotangents the train path gave them (one call
    for the box pool, one for the mask pool), summed."""
    total = 0.0
    for args in product_calls:
        by, bx, g, dtype = args
        ms = time_ms(lambda: roi_align_ops._d_regions(*args), runs=7, calls=3)
        print(f"[kernels] d_regs products {str(dtype)[6:]} train-path call "
              f"{tuple(g.shape)} -> "
              f"{(g.shape[0], by.shape[2], bx.shape[2], g.shape[3])}: {ms:.4f} ms")
        total += ms
    return total


def device_kernels(fn) -> list[tuple[str, float]]:
    """(name, device µs) of every device kernel that one call of ``fn`` runs,
    as ``torch.profiler`` traces them (memory copies and sets left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def scatter_kernels_per_call(paths: dict) -> dict:
    """Device kernels one region-scatter call runs, in each (input,
    accumulator) pair, on the train paths' own windows: the ROI bounds, the
    rank of every window row, the row pointers and the scatter."""
    by_dtype = {}  # the first path's windows in each dtype
    for v in paths.values():
        if v[2]:
            by_dtype.setdefault(v[2][0][0].dtype, v[2][0])
    device_kernels(lambda: SCATTER(*by_dtype[F32]))  # the first trace drops
    #   its first kernel
    counts = {}
    for dt, acc in SCATTER_PAIRS:
        d_regs, base, stride, s_rows, _ = by_dtype[dt]
        kernels = device_kernels(lambda: SCATTER(d_regs, base, stride, s_rows, acc))
        key = f"{str(dt)[6:]} in, {str(acc)[6:]} accumulator"
        print(f"[kernels] region_scatter {key}: {len(kernels)} device kernels a "
              f"call (torch.profiler, device µs): "
              + "; ".join(f"{n[:70]} {us:.1f}" for n, us in kernels))
        counts[key] = [n[:70] for n, _ in kernels]
    return counts


def time_by_roi_count(args):
    """Time the ROIAlign forward on the first R, and on repeats, of one
    call's ROIs: what one block's chain of latencies costs (R = 1) and what
    each further ROI adds."""
    flat, *per_roi = args
    n = per_roi[0].shape[0]
    readings = []
    for r in (1, 32, n // 2, n, 2 * n, 4 * n):
        idx = torch.arange(r, device=flat.device) % n
        sub = [flat] + [t[idx].contiguous() for t in per_roi]
        readings.append(f"R={r} {time_ms(lambda: ROI_ALIGN(*sub)):.4f}")
    print(f"[kernels] roi_align_fwd by ROI count, call "
          f"{call_shape(ROI_ALIGN, args)}'s ROIs: " + ", ".join(readings) + " ms")


def time_against(other_source: str, calls_by_path: dict):
    """Build the ROIAlign forward of ``other_source`` (another checkout's
    ``roi_align_fwd.cu``, same C interface) and time it against this
    checkout's on the main paths' own inputs: other, this, this, other."""
    other = roi_align_cuda.RoiAlignForward(source=str(Path(other_source).resolve()))
    plain = roi_align_cuda.roi_align_region_plain
    for label, calls in calls_by_path.items():
        for args in calls:
            err = rel_err(other(*args), plain(*args))
            times = [time_ms(lambda: k(*args)) for k in (other, ROI_ALIGN, ROI_ALIGN, other)]
            print(f"[against] roi_align_fwd {label}-path call "
                  f"{call_shape(ROI_ALIGN, args)}: other {times[0]:.4f}, this "
                  f"{times[1]:.4f}, this {times[2]:.4f}, other {times[3]:.4f} ms "
                  f"(other's error {err:.2e})")


def phase_kernels_line(paths: dict, nms_b8: tuple):
    """Time each kernel on the inputs the main paths gave it (one request's
    or one step's calls, summed), beside its plain version and its bound.
    ``paths`` maps each path to (launches, ROIAlign calls, region-scatter
    calls, product calls). An entry's top-level numbers are those of the
    first path that runs the kernel (float32 predict for the ROIAlign
    forward, float32 train for the region scatter), the others are under
    the path's name; ``launches`` counts every path, ``launches_by_path``
    each."""
    (_, fwd_plain, fwd_src, fwd_repl), (_, bwd_plain, bwd_src, bwd_repl) = KERNELS[:2]
    fwd, bwd, lib, products = {}, {}, {}, {}
    for path, (_, fwd_calls, bwd_calls, product_calls) in paths.items():
        if not fwd_calls:  # the eval and CLI paths: launches only
            continue
        fwd[path] = time_calls(ROI_ALIGN, fwd_plain, roi_align_bound,
                               fwd_calls, path)
        if bwd_calls:
            bwd[path] = time_calls(SCATTER, bwd_plain, region_scatter_bound,
                                   bwd_calls, path)
            lib[path] = sum(index_add_ms(*args) for args in bwd_calls)
            print(f"[kernels] region_scatter {path}-path call: index_add_ "
                  f"{lib[path]:.4f} ms (in {bwd_calls[0][0].dtype})")
            products[path] = d_regs_matmul_ms(product_calls)
    for args in paths["predict"][1]:
        time_by_roi_count(args)
    per_call = scatter_kernels_per_call(paths)  # after the timings: traced
    n = {name: {path: v[0].get(name, 0) for path, v in paths.items()}
         for name in (ROI_ALIGN.name, SCATTER.name)}
    first_fwd, first_bwd = "predict", "train"
    return [
        {"name": ROI_ALIGN.name, "route": "cuda", "source": fwd_src,
         "replaces": fwd_repl, "launches": sum(n[ROI_ALIGN.name].values()),
         "launches_by_path": n[ROI_ALIGN.name], **fwd[first_fwd],
         "library_ms": None,  # no one PyTorch call computes ROIAlign
         **{f"{path}_path": v for path, v in fwd.items() if path != first_fwd}},
        {"name": SCATTER.name, "route": "cuda", "source": bwd_src,
         "replaces": bwd_repl, "launches": sum(n[SCATTER.name].values()),
         "launches_by_path": n[SCATTER.name],
         "device_kernels_per_launch": per_call,
         **bwd[first_bwd], "library_ms": lib[first_bwd],
         "d_regs_matmul_ms": products[first_bwd],
         **{f"{path}_path": {**v, "library_ms": lib[path],
                             "d_regs_matmul_ms": products[path]}
            for path, v in bwd.items() if path != first_bwd}},
        nms_entry(paths, nms_b8),
    ]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--against", metavar="SOURCE", help="another checkout's "
                   "roi_align_fwd.cu, timed beside this one's")
    args = p.parse_args(argv)

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    worst = max(phase_roi_align_vs_plain(args.seed),
                phase_region_scatter_vs_plain(args.seed),
                phase_c4_kernels_vs_plain(args.seed))
    worst = max(worst, phase_darknet_kernels_vs_plain(args.seed))
    print(f"[kernels] worst f32 error against the plain versions: {worst:.2e}")
    paths = {}
    launches, calls = phase_predict(N_REQUESTS, args.seed)
    paths["predict"] = (launches, calls, [], [])
    paths["train"] = phase_train(N_TRAIN_STEPS, args.seed)
    phase_train_gpu_vs_cpu(args.seed)
    launches, calls = phase_predict(N_REQUESTS, args.seed, BF16_SETTINGS,
                                    tag="bf16-predict")
    paths["bf16_predict"] = (launches, calls, [], [])
    paths["bf16_train"] = phase_train(N_TRAIN_STEPS, args.seed,
                                      BF16_TRAIN_SETTINGS, tag="bf16-train")
    phase_bf16_gpu_vs_cpu(args.seed)
    paths["eval"] = (phase_eval(N_EVAL_BATCHES, args.seed), [], [], [])
    diag = {}
    paths["cli"] = (phase_cli(args.seed, after=lambda weight: diag.update(
        phase_diag(weight, "fpn_mask", "256x320", args.seed))), [], [], [])
    paths["diag"] = (diag, [], [], [])
    launches, calls = phase_predict(N_REQUESTS, args.seed, preset="fpn_keypoint",
                                    tag="kp-predict")
    paths["kp_predict"] = (launches, calls, [], [])
    paths["kp_train"] = phase_train(N_TRAIN_STEPS, args.seed, preset="fpn_keypoint",
                                    tag="kp-train")
    phase_train_gpu_vs_cpu(args.seed, preset="fpn_keypoint", tag="kp-train")
    paths["kp_eval"] = (phase_kp_eval(N_KP_EVAL_BATCHES, args.seed), [], [], [])
    launches, by_shape, (fwd_calls, bwd_calls, product_calls) = phase_coco_cli(args.seed)
    paths["coco_portrait"] = (launches, fwd_calls, bwd_calls, product_calls)
    for short, preset in C4_PRESETS.items():
        launches, calls = phase_predict(N_REQUESTS, args.seed, preset=preset,
                                        tag=f"{short}-predict")
        paths[f"{short}_predict"] = (launches, calls, [], [])
        paths[f"{short}_train"] = phase_train(N_TRAIN_STEPS, args.seed,
                                              preset=preset, tag=f"{short}-train")
        phase_train_gpu_vs_cpu(args.seed, preset, tag=f"{short}-train")
        launches, calls = phase_predict(1, args.seed, PALLAS, preset,
                                        tag=f"{short}-pallas-predict")
        paths[f"{short}_pallas_predict"] = (launches, calls, [], [])
        paths[f"{short}_pallas_train"] = phase_train(
            1, args.seed, PALLAS, preset, tag=f"{short}-pallas-train")
        paths[f"{short}_cli"] = (phase_cli(args.seed, preset, f"{short}-cli"),
                                 [], [], [])
    for short, (preset, hw, batch, mode) in DARKNET.items():
        launches, calls = phase_predict(N_REQUESTS, args.seed, preset=preset,
                                        tag=f"{short}-predict", hw=hw, mode=mode)
        paths[f"{short}_predict"] = (launches, calls, [], [])
        paths[f"{short}_train"] = phase_train(N_TRAIN_STEPS, args.seed,
                                              preset=preset, tag=f"{short}-train",
                                              hw=hw, batch=batch)
        phase_train_gpu_vs_cpu(args.seed, preset, f"{short}-train", hw)
        launches, calls = phase_predict(1, args.seed, PALLAS, preset,
                                        f"{short}-pallas-predict", hw, mode)
        paths[f"{short}_pallas_predict"] = (launches, calls, [], [])
        paths[f"{short}_pallas_train"] = phase_train(
            1, args.seed, PALLAS, preset, f"{short}-pallas-train", hw, batch)
    paths["dk_eval"] = (phase_kp_eval(N_DK_EVAL_BATCHES, args.seed,
                                      "darknet_keypoint", (256, 320), "dk-eval"),
                        [], [], [])
    paths["dk_depth_cli"] = (phase_depth_cli(args.seed), [], [], [])
    paths["tt_cli"] = (phase_cli(args.seed, "tiny_test", "tt-cli", "128x160",
                                 demo=4), [], [], [])
    for tag, (preset, hw, batch) in DP_GLOO.items():
        for rank, launches in phase_dp_gloo(args.seed, preset, hw, batch, tag).items():
            paths[f"{tag}_{rank}"] = (launches, [], [], [])
    phase_dp_nccl(args.seed)
    paths["pretrained"] = (phase_pretrained(args.seed), [], [], [])
    paths["profile"] = (phase_profile(args.seed), [], [], [])
    for tag, (preset, hw, batch) in CHAIN.items():
        paths[tag.replace("-", "_")] = (phase_chain(args.seed, preset, hw, batch, tag),
                                        [], [], [])
    paths["chain_cli"] = (phase_chain_cli(args.seed), [], [], [])
    phase_bench_validate(args.seed)
    entries = phase_kernels_line(paths, nms_b8_call(args.seed))
    for entry in entries:
        entry["coco_launches_by_shape"] = {k: v[entry["name"]]
                                           for k, v in by_shape.items()}
    if args.against:
        time_against(args.against, {path: v[1] for path, v in paths.items()})
    torch.cuda.synchronize()
    print(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s")

    print(card_name_and_power_limit())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
