"""Two-pass predict latency and train-step throughput of the port on one
GPU (counterpart of the JAX package's ``bench.py``).

    python -m maskrcnn_tpu_torch.bench --mode predict|train
        [--preset fpn_mask|fpn_keypoint|light_head|c4_res5|tiny_test|
                  darknet_keypoint]
        [--batch B] [--height H] [--width W] [--steps 20]
        [--roi-align auto] [--dtype float32|bfloat16]
        [--roi-align-acc float32|bfloat16] [--remat] [--grad-accum N]
        [--momentum-dtype bfloat16] [--set SECTION.KEY=VALUE ...]
        [--profile N] [--steps-per-dispatch K]

The JAX package's bench options: ``--dtype`` is ``model.dtype`` (float32
by default, so earlier numbers stay comparable), ``--roi-align-acc`` the
accumulator of the shared pool's backward, ``--remat`` checkpoints the
backbone, ``--grad-accum`` splits a step into micro-batches,
``--momentum-dtype`` stores the momentum buffer in bf16, and ``--set``
applies any config override (``--set model.freeze_bn=False`` trains the
BatchNorms). The line records the settings it ran with. The image size
is the preset's own bucket unless ``--height``/``--width`` say otherwise:
800×1024 for the FPN and C4 presets, 256×320 for ``darknet_keypoint``,
128×160 for ``tiny_test``.

``--mode train`` (the preset's batch unless given: 2, or 8 for
``darknet_keypoint``) takes optimizer steps on synthetic
batches from seeded random weights (TF32 off) through
:func:`maskrcnn_tpu_torch.train.step.make_train_step` and prints ONE JSON
line: the median milliseconds per step after warm-up (CUDA events), steps
and images per second, the peak device memory of a step (allocated, and
reserved by the caching allocator: a CUDA graph's pool, allocated at
capture, counts only in the latter), the last step's
losses, the hand-written kernels' launches per step, and the time and
memory of proposal generation (exact NMS) alone; with ``--profile N`` also,
under ``traced``, the program's tracer's summary of N more steps
(:func:`traced`). The FPN heads train through the shared window under
``--roi-align`` auto, region or fused and through two pools under gather or
pallas; the light and Res5 heads always pool twice. With
``--steps-per-dispatch K`` (K > 1) the line also holds, under ``chained``,
the same numbers for ``make_train_step(cfg, chain=K)`` from a fresh state on
the same batches: each call runs K steps, replays of a CUDA graph of the
step after the first call's capture; ms per step is a chain's time over K,
and ``--profile N`` traces N/K chains (a first one captures the traced
graph).

``--mode predict`` (batch 1 unless given) serves synthetic requests (seeded
random weights with the class scores spread as :func:`spread_class_scores`
says, TF32 off) through :func:`maskrcnn_tpu_torch.eval.predict.make_predict_fn` and prints
ONE JSON line: p50/p90 milliseconds per request, replays of the request's
CUDA graph timed with CUDA events after warm-up (the first warms up, the
second captures) from enqueue, the input copy included, to the last
kernel's end; under ``eager`` the same of ``predict.eager`` on the same
requests, timed in turns with the graphed ones; under ``graph`` the
capture's seconds and its memory pool's reserved GiB; the card's name and
power limit and the (ROI, class) pairs that clear the score threshold in
each of the 4 distinct requests (the load of per-class NMS); with
``--profile N`` also, under ``traced``, the tracer's summary of N more
graphed requests (two first ones capture the traced graph). Without a GPU
it exits non-zero.

Both lines check their own numbers, as the JAX bench does (its
``_validate``). ``--mode train`` also counts the FLOPs of one eager
optimizer step (:func:`step_flops`, on top of the timed steps), takes a
second clock, ``step_ms_chained``: ``--steps`` steps enqueued back to back
and closed by a value fetch of the last loss (``final_loss``), and derives
``implied_tflops_per_sec`` and ``implied_mfu`` from it against the card's
dense peak in the run's math mode (:mod:`maskrcnn_tpu_torch.utils.peaks`).
The line is marked ``"suspect": true`` with a ``suspect_reason`` when the
MFU passes ``MFU_SUSPECT_BOUND``, when the per-step clock and the
back-to-back clock disagree by more than ``CLOCK_MISMATCH_BOUND`` either
way, or when the back-to-back step runs over ``SLOW_SUSPECT_FACTOR`` times
the ``expected_step_ms`` of a recorded configuration
(``EXPECTED_STEP_MS``). The ``chained`` object gets the same count over its
own ms per step. ``--mode predict`` applies the slow check to its p50 and
counts no FLOPs. Both lines carry ``vs_baseline`` and the device's
metadata (``platform``, ``device_kind``, ``n_devices``, ``torch_version``,
``card``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from maskrcnn_tpu_torch import config as cfg_lib
from maskrcnn_tpu_torch.data.synthetic import (
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn
from maskrcnn_tpu_torch.models.maskrcnn import (
    MaskRCNN,
    backbone_geometry,
    pyramid_shapes,
)
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals
from maskrcnn_tpu_torch.train.state import create_train_state
from maskrcnn_tpu_torch.kernels import KERNELS
from maskrcnn_tpu_torch.train.step import make_train_step, stack_batches
from maskrcnn_tpu_torch.utils import tracing
from maskrcnn_tpu_torch.utils.device import card_name_and_power_limit
from maskrcnn_tpu_torch.utils.peaks import math_mode, peak_flops

# requests served before timing: lazy CUDA and cuDNN set-up, allocator growth
WARMUP = 3

# the JAX bench's bounds (its bench.py:44-51)
MFU_SUSPECT_BOUND = 0.60  # a detection train step never reaches this share
CLOCK_MISMATCH_BOUND = 2.0  # per-step over back-to-back clock, either way
SLOW_SUSPECT_FACTOR = 1.5  # measured over expected step time

# vs_baseline's anchors, the reference's (not TPU times): 1.0 images/s of
# training (BASELINE.md:30-40) and 1000 ms a batch-1 request (the JAX
# bench.py:230-231)
BASELINE_IMAGES_PER_S = 1.0
BASELINE_REQUEST_MS = 1000.0

# Expected ms per step (train: the back-to-back clock; the graphed step at
# K > 1: a chain's ms over K) or per request (predict: the replayed p50) of
# the recorded configurations with this bench's default settings, float32
# with TF32 off unless bfloat16 is named. Keyed by (preset, height, width,
# batch, dtype, mode, K), K the steps a dispatch (1 for predict). Each is the
# slower of two runs of this bench, one after the other on one NVIDIA H100
# 80GB HBM3 at 700.00 W (``--steps 40 --steps-per-dispatch 20`` for train,
# 20 requests for predict). Left out: ``tiny_test``'s eager train step,
# which the host sets: its back-to-back clock read from 22.60 to 39.73 ms
# on three machines with that card.
EXPECTED_STEP_MS = {
    ("fpn_mask", 800, 1024, 2, "float32", "train", 1): 133.71,
    ("fpn_mask", 800, 1024, 2, "bfloat16", "train", 1): 58.00,
    ("darknet_keypoint", 256, 320, 8, "float32", "train", 1): 83.27,
    ("fpn_mask", 800, 1024, 2, "float32", "train", 20): 125.88,
    ("fpn_mask", 800, 1024, 2, "bfloat16", "train", 20): 33.11,
    ("darknet_keypoint", 256, 320, 8, "float32", "train", 20): 71.59,
    ("tiny_test", 128, 160, 2, "float32", "train", 20): 8.65,
    ("fpn_mask", 800, 1024, 1, "float32", "predict", 1): 20.82,
    ("fpn_mask", 800, 1024, 1, "bfloat16", "predict", 1): 8.98,
    ("fpn_keypoint", 800, 1024, 1, "float32", "predict", 1): 24.00,
    ("light_head", 800, 1024, 1, "float32", "predict", 1): 18.08,
    ("c4_res5", 800, 1024, 1, "float32", "predict", 1): 72.75,
    ("tiny_test", 128, 160, 1, "float32", "predict", 1): 4.84,
    ("darknet_keypoint", 256, 320, 1, "float32", "predict", 1): 4.27,
}


def predict_config(preset: str, batch: int, height: int, width: int,
                   roi_align: str = "auto") -> cfg_lib.Config:
    return cfg_lib._rep(cfg_lib.PRESETS[preset](),
                        train=dict(batch_size=batch, image_size=(height, width)),
                        model=dict(roi_align=roi_align))


def image_size(args) -> tuple[int, int]:
    """``--height``/``--width``, each the preset's own where not given."""
    h, w = cfg_lib.PRESETS[args.preset]().train.image_size
    return args.height or h, args.width or w


def grad_accum_default(batch: int) -> int:
    """The JAX bench's ``--grad-accum`` when none is given: micro-batches of
    8 above batch 8, else the whole batch at once."""
    return max(1, batch // 8) if batch > 8 else 1


def bench_config(args, batch: int) -> cfg_lib.Config:
    """The preset at the requested size with the command line's settings."""
    accum = grad_accum_default(batch) if args.grad_accum is None else args.grad_accum
    cfg = cfg_lib._rep(
        predict_config(args.preset, batch, *image_size(args), args.roi_align),
        model=dict(dtype=args.dtype, roi_align_acc=args.roi_align_acc,
                   remat=args.remat),
        train=dict(grad_accum_steps=accum,
                   momentum_dtype=args.momentum_dtype))
    return cfg_lib.apply_overrides(cfg, args.set)


def expected_step_ms(args, cfg: cfg_lib.Config, mode: str, k: int = 1) -> float | None:
    """``EXPECTED_STEP_MS`` of this configuration, or None. Only the
    recorded settings are validated, as in the JAX bench: ``--set``, a
    non-default ``--roi-align``, ``--roi-align-acc``, ``--remat``,
    ``--grad-accum`` or ``--momentum-dtype`` shift the cost."""
    if (args.set or args.roi_align != "auto" or args.roi_align_acc != "float32"
            or args.remat or args.grad_accum is not None
            or args.momentum_dtype is not None):
        return None
    h, w = cfg.train.image_size
    return EXPECTED_STEP_MS.get(
        (args.preset, h, w, cfg.train.batch_size, cfg.model.dtype, mode, k))


def validate(record: dict, flops: float | None, peak: float | None,
             step_ms_chained: float, step_ms_p50: float,
             expected_ms: float | None = None) -> None:
    """The JAX bench's ``_validate``: add ``step_flops``,
    ``implied_tflops_per_sec`` and ``implied_mfu`` (over ``peak``, FLOP/s)
    and ``expected_step_ms`` to ``record`` where known, and ``"suspect":
    true`` with a ``suspect_reason`` where a check trips. The MFU divides
    by ``step_ms_chained``, the clock the slow check reads; the clock check
    compares it with ``step_ms_p50``."""
    reasons = []
    if expected_ms is not None:
        record["expected_step_ms"] = expected_ms
        if step_ms_chained > SLOW_SUSPECT_FACTOR * expected_ms:
            reasons.append(
                f"step {step_ms_chained:.2f} ms exceeds {SLOW_SUSPECT_FACTOR}x "
                f"the expected {expected_ms:.2f} ms for this config: a code "
                "regression or a degraded card")
    if flops is not None:
        record["step_flops"] = flops
        implied = flops / (step_ms_chained / 1e3)
        record["implied_tflops_per_sec"] = implied / 1e12
        if peak is not None:
            mfu = implied / peak
            record["implied_mfu"] = mfu
            if mfu > MFU_SUSPECT_BOUND:
                reasons.append(
                    f"implied MFU {mfu:.3f} exceeds {MFU_SUSPECT_BOUND} of the "
                    f"{peak / 1e12:.1f} TFLOP/s peak: physically implausible")
    ratio = step_ms_p50 / max(step_ms_chained, 1e-9)
    if ratio > CLOCK_MISMATCH_BOUND or ratio < 1.0 / CLOCK_MISMATCH_BOUND:
        reasons.append(
            f"back-to-back clock {step_ms_chained:.2f} ms a step disagrees "
            f"with the per-step clock's p50 {step_ms_p50:.2f} ms by "
            f"{ratio:.2f}x: a clock that does not wait for the device")
    if reasons:
        record["suspect"] = True
        record["suspect_reason"] = "; ".join(reasons)


class _StepFlops(FlopCounterMode):
    """``FlopCounterMode`` that leaves out the ops a hand-written kernel's
    wrapper runs: on the card the wrapper launches its kernel, which a
    dispatch mode never sees, and on the CPU its plain version, which the
    card never runs (NMS's Jacobi sweeps, one ``bmm`` a sweep, as many as
    the boxes need; ROIAlign's two ``einsum``). So the count is the same on
    both devices and does not depend on the data."""

    _wrappers = frozenset(type(k).__call__.__code__ for k in KERNELS)

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            frame = sys._getframe(1)
            while frame is not None:
                if frame.f_code in self._wrappers:
                    return out
                frame = frame.f_back
        return super()._count_flops(func_packet, out, args, kwargs)


def step_flops(step, state, batch) -> int:
    """The FLOPs of one eager optimizer step ``step(state, batch)`` (a
    ``make_train_step(cfg)`` step, K=1), counted by ``FlopCounterMode``:
    convolutions, matmuls and their backward, every micro-batch of
    ``grad_accum_steps`` and ``remat``'s recomputed forward, all of which
    the card runs. The step is real: it ADVANCES ``state`` (parameters,
    momentum, step, generator). Count outside any timed step and any CUDA
    graph capture: a dispatch mode cannot run inside a capture, and it
    slows the host.

    The hand-written kernels add nothing (:class:`_StepFlops`). They do
    little arithmetic: on ``fpn_mask`` 800×1024 b2 in float32 the ROIAlign
    forward's two calls take 0.039 ms, the region scatter 0.191 ms and NMS
    0.252 ms of a 134 ms step (``chip_smoke.py``'s kernels line, NVIDIA
    H100 80GB HBM3, 700.00 W)."""
    counter = _StepFlops(display=False)
    with counter:
        step(state, batch)
    return counter.get_total_flops()


def time_back_to_back(step, state, batches) -> tuple[float, float]:
    """The JAX bench's chained clock: one step per batch, enqueued back to
    back with no sync between them, the host clock closed by a value fetch
    of the last loss (``.item()``) → (ms per step, that loss). The fetch is
    a copy queued on the step's stream after the last step's every kernel,
    the optimizer's included, so it cannot return before they end.

    Not to be confused with ``--steps-per-dispatch K`` (the line's
    ``chained`` object): there each call replays a CUDA graph of the step K
    times, timed by CUDA events per call. Here every step is the same eager
    step that ``value`` and ``step_ms_p50`` time one at a time, each waited
    for; only the waits differ."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        metrics = step(state, batch)
    final_loss = metrics["loss"].item()
    return (time.perf_counter() - t0) * 1e3 / len(batches), final_loss


def device_meta() -> dict:
    """The device fields of a line (the JAX bench's ``_device_meta``), with
    the card's name and power limit."""
    return {"platform": "gpu", "device_kind": torch.cuda.get_device_name(0),
            "n_devices": torch.cuda.device_count(),
            "torch_version": torch.__version__,
            "card": card_name_and_power_limit()}


def settings(cfg: cfg_lib.Config) -> dict:
    """The settings a line ran with, by config name."""
    m, t = cfg.model, cfg.train
    return {"model.dtype": m.dtype, "model.freeze_bn": m.freeze_bn,
            "model.remat": m.remat, "model.roi_align": m.roi_align,
            "model.roi_align_acc": m.roi_align_acc,
            "train.grad_accum_steps": t.grad_accum_steps,
            "train.momentum_dtype": t.momentum_dtype}


def spread_class_scores(model, scale: float = 8.0):
    """Scale the class-score layer's random weights in place.

    At random init the class logits spread by about 0.25, so every class
    scores near 1/81, under the 0.05 threshold: no detection is valid and
    NMS, the merge and pass 2 see only empty slots. Scaled by 8 enough
    (ROI, class) pairs pass to fill every one of the ``max_detections``
    slots. That is a chosen load, not a measured property of trained
    weights; :func:`passing_pairs` counts it per request.
    """
    with torch.no_grad():
        class_score_layer(model).weight.mul_(scale)
    return model


def class_score_layer(model):
    """The head's dense layer that gives the class logits: ``head.box.score``
    of the FPN heads, ``head.score`` of the light and Res5 heads."""
    head = model.head
    return head.score if hasattr(head, "score") else head.box.score


def passing_pairs(cfg: cfg_lib.Config, model, predict, requests) -> list[int]:
    """Serve ``requests`` again through ``predict.eager``, untimed, and
    count for each the (ROI, class) pairs of pass 1 whose class score
    clears ``score_thresh``, over all proposal slots: the load that
    per-class NMS and the merge see."""
    counts = []

    def count(module, inputs, logits):
        probs = torch.softmax(logits, dim=-1)[:, 1:]
        counts.append(int((probs > cfg.eval.score_thresh).sum()))

    handle = class_score_layer(model).register_forward_hook(count)
    try:
        for req in requests:
            predict.eager(*req)  # a hook never runs in a graph's replay
    finally:
        handle.remove()
    return counts


def time_requests(predict, requests, warmup: int = 3):
    """Serve ``requests`` (after ``warmup`` unmeasured ones) → (ms per
    request from CUDA events, Detections per request). Each request's time
    runs from its enqueue, the copy of its inputs included, to the end of
    its last kernel."""
    return time_in_turns({"": predict}, requests, warmup)[""]


def time_in_turns(predicts: dict, requests, warmup: int = 3) -> dict:
    """Each of ``predicts`` (name → function) serves every request in
    turns, the order reversed from one request to the next, after
    ``warmup`` unmeasured requests each → name → (ms per request,
    Detections per request), timed as :func:`time_requests` times."""
    for predict in predicts.values():
        for req in requests[:warmup]:
            predict(*req)
    torch.cuda.synchronize()
    out = {name: ([], []) for name in predicts}
    names = list(predicts)
    for i, req in enumerate(requests[warmup:]):
        for name in names if i % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            det = predicts[name](*req)
            end.record()
            end.synchronize()
            out[name][0].append(start.elapsed_time(end))
            out[name][1].append(det)
    return out


def time_train_steps(step, state, batches, warmup: int = 2):
    """Take one optimizer step per batch (after ``warmup`` unmeasured ones)
    → (ms per step from CUDA events, metrics per step, peak bytes allocated
    over the measured steps)."""
    for batch in batches[:warmup]:
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for batch in batches[warmup:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(state, batch))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, metrics, torch.cuda.max_memory_allocated()


def time_train_proposals(cfg: cfg_lib.Config, model, batch, runs: int = 5) -> dict:
    """``generate_proposals`` at the train budgets alone, on the model's own
    RPN outputs for ``batch``: median ms (CUDA events) and the peak memory
    it allocates above what is held (the backbone's outputs stay held).
    Exact NMS builds a 64-bit suppression mask over the upper triangle of
    the ``(n_pre, n_pre)`` pairs per image."""
    shapes = pyramid_shapes(cfg, cfg.train.image_size)
    anchors = torch.as_tensor(
        anchors_for(cfg, shapes, backbone_geometry(cfg)[0]), device=model.device)
    with torch.no_grad():
        features, locs, scores = model(
            torch.as_tensor(batch.images, device=model.device))
        img_hw = torch.as_tensor(batch.img_hw, device=model.device)
        scale = torch.as_tensor(batch.scale, device=model.device)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _run in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            props = generate_proposals(
                locs, scores, anchors, scale, img_hw,
                n_pre=cfg.proposals.n_train_pre_nms,
                n_post=cfg.proposals.n_train_post_nms,
                nms_thresh=cfg.proposals.nms_thresh,
                min_size=cfg.proposals.min_size, n_levels=len(shapes))
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del features  # held through the runs, as in the step
    return {"proposals_ms": statistics.median(times),
            "proposals_peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
            "proposals_valid_per_image": props.valid.sum(dim=1).tolist()}


def traced(fn, warm: list, calls: list) -> dict:
    """``fn(*call)`` for each of ``warm`` and then of ``calls`` with the
    program's tracer on → :func:`maskrcnn_tpu_torch.utils.tracing.summary`
    of ``calls`` alone: per request or step, each device stage's median ms,
    each host span's median and p95 ms, each work counter. ``warm`` makes
    the traced graphs, which are kept apart from the untraced ones."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    tracing.enable()
    try:
        for call in warm:
            fn(*call)
        sync()
        tracing.reset()
        for call in calls:
            fn(*call)
        sync()
        return tracing.summary()
    finally:
        tracing.disable()
        tracing.reset()


def percentile(times, q: float) -> float:
    s = sorted(times)
    return s[min(len(s) - 1, int(len(s) * q))]


def bench_chained(args, cfg, batches, k: int) -> dict:
    """``make_train_step(cfg, chain=k)`` from a fresh state: two warm-up
    chains (the first captures), then chains over ``args.steps`` steps
    (rounded up to whole chains) → ms per step and the rest, per step."""
    batch = cfg.train.batch_size
    state = create_train_state(cfg, MaskRCNN(cfg, seed=0))
    step = make_train_step(cfg, chain=k)
    n_chains = 2 + -(-args.steps // k)
    chains = [stack_batches([batches[(i * k + j) % 4] for j in range(k)])
              for i in range(n_chains + -(-args.profile // k))]
    for kernel in KERNELS:
        kernel.launches = 0
    times, metrics, peak = time_train_steps(step, state, chains[:n_chains], 2)
    reserved = torch.cuda.max_memory_reserved()
    profiled = ({"traced": traced(lambda c: step(state, c), [(chains[0],)],
                                  [(c,) for c in chains[n_chains:]])}
                if args.profile else {})
    ms = statistics.median(times) / k
    return {
        "steps_per_dispatch": k,
        "images_per_s": batch * 1e3 / ms,
        "step_ms_p50": ms,
        "step_ms_max": max(times) / k,
        "steps": (n_chains - 2) * k,
        "peak_memory_gib": peak / 2**30,
        # the graph's private pool, allocated at capture, shows only here
        "peak_reserved_gib": reserved / 2**30,
        "last_step": {key: float(v[-1]) for key, v in metrics[-1].items()},
        "kernel_launches_per_step": {kernel.name: kernel.launches / (n_chains * k)
                                     for kernel in KERNELS},
        **profiled,
    }


def bench_train(args) -> dict:
    """The train line: the timed steps, then (on top of them) one counted
    step and the back-to-back clock over ``args.steps`` more, then the
    chained object; every check of :func:`validate` applied."""
    batch = args.batch or cfg_lib.PRESETS[args.preset]().train.batch_size
    cfg = bench_config(args, batch)
    h, w = cfg.train.image_size
    state = create_train_state(cfg, MaskRCNN(cfg, seed=0))
    step = make_train_step(cfg)
    data = SyntheticDetectionData(cfg, seed=0)
    warmup = 2
    n = warmup + args.steps
    batches = [data.batch(i % 4) for i in range(n + args.profile)]
    for k in KERNELS:
        k.launches = 0
    times, metrics, peak = time_train_steps(step, state, batches[:n], warmup)
    reserved = torch.cuda.max_memory_reserved()
    launches = {k.name: k.launches / n for k in KERNELS}
    profiled = ({"traced": traced(lambda b: step(state, b), [],
                                  [(b,) for b in batches[n:]])}
                if args.profile else {})
    proposals = time_train_proposals(cfg, state.model, batches[0])
    flops = step_flops(step, state, batches[0])
    chained_ms, final_loss = time_back_to_back(step, state, batches[warmup:n])
    peak_rate = peak_flops(torch.cuda.get_device_name(0), math_mode(cfg.model.dtype))
    chained = {}
    if args.steps_per_dispatch > 1:
        del state, step
        k = args.steps_per_dispatch
        chained = bench_chained(args, cfg, batches[:4], k)
        validate(chained, flops, peak_rate, chained["step_ms_p50"],
                 chained["step_ms_p50"], expected_step_ms(args, cfg, "train", k))
        chained = {"chained": chained}
    ms = statistics.median(times)
    record = {
        "metric": f"train_images_per_s_{args.preset}_{h}x{w}_b{batch}",
        "value": batch * 1e3 / ms,
        "unit": "images/s",
        "vs_baseline": batch * 1e3 / ms / BASELINE_IMAGES_PER_S,
        "step_ms_p50": ms,
        "step_ms_max": max(times),
        "step_ms_chained": chained_ms,
        "final_loss": final_loss,
        "steps_per_s": 1e3 / ms,
        "steps": args.steps,
        "peak_memory_gib": peak / 2**30,
        "peak_reserved_gib": reserved / 2**30,
        "last_step": {k: float(v) for k, v in metrics[-1].items()},
        "kernel_launches_per_step": launches,
        "settings": settings(cfg),
        **proposals,
        **profiled,
        **chained,
    }
    validate(record, flops, peak_rate, chained_ms, ms,
             expected_step_ms(args, cfg, "train"))
    return record


def bench_predict(args) -> dict:
    """The predict line, the slow check applied to its p50."""
    batch = args.batch or 1
    cfg = bench_config(args, batch)
    h, w = cfg.train.image_size
    model = spread_class_scores(MaskRCNN(cfg, seed=0))
    predict = make_predict_fn(cfg, model)
    data = SyntheticRequests(cfg, seed=0)
    n = WARMUP + args.steps
    requests = [tuple(data.batch(i % 4)) for i in range(n + args.profile)]
    turns = time_in_turns({"graphed": predict, "eager": predict.eager},
                          requests[:n], WARMUP)
    times, dets = turns["graphed"]
    eager_times = turns["eager"][0]
    profiled = ({"traced": traced(predict, requests[:2], requests[n:])}
                if args.profile else {})
    pairs = passing_pairs(cfg, model, predict, requests[:4])
    graph, = (g for key, g in predict.graphs.items() if not key[-1])  # untraced
    p50 = percentile(times, 0.5)
    record = {
        "metric": f"predict_p50_ms_{args.preset}_{h}x{w}_b{batch}",
        "value": p50,
        "unit": "ms",
        "vs_baseline": BASELINE_REQUEST_MS / p50,
        "p90_ms": percentile(times, 0.9),
        "steps": args.steps,
        "eager": {"p50_ms": percentile(eager_times, 0.5),
                  "p90_ms": percentile(eager_times, 0.9)},
        "graph": {"capture_s": graph.capture_s, "captures": graph.captures,
                  "reserved_gib": graph.reserved_bytes / 2**30},
        "valid_detections_mean": sum(int(d.valid.sum()) for d in dets) / len(dets),
        "passing_pairs_per_request": pairs,
        "settings": settings(cfg),
        **profiled,
    }
    # no FLOP count for a request, as in the JAX bench: the slow check only
    validate(record, None, None, p50, p50, expected_step_ms(args, cfg, "predict"))
    return record


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="predict", choices=["predict", "train"])
    p.add_argument("--preset", default="fpn_mask")
    p.add_argument("--batch", type=int, default=0,
                   help="images per request or step (default: 1 predict, "
                        "the preset's batch train)")
    p.add_argument("--height", type=int, default=None,
                   help="image height (default: the preset's)")
    p.add_argument("--width", type=int, default=None,
                   help="image width (default: the preset's)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--roi-align", default="auto",
                   choices=["auto", "region", "gather", "pallas", "fused"],
                   help="model.roi_align: the ROIAlign form of both paths")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="model.dtype: the compute dtype of convs and dense layers")
    p.add_argument("--roi-align-acc", default="float32",
                   choices=["float32", "bfloat16"],
                   help="model.roi_align_acc: the region scatter's accumulator")
    p.add_argument("--remat", action="store_true",
                   help="model.remat: checkpoint the backbone")
    p.add_argument("--grad-accum", type=int, default=None, metavar="N",
                   help="train.grad_accum_steps (default: batch//8 above "
                        "batch 8, else 1)")
    p.add_argument("--momentum-dtype", default=None, choices=["bfloat16"],
                   help="train.momentum_dtype (default: float32)")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (e.g. model.freeze_bn=False)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="then trace N more requests or steps with the "
                        "program's tracer and add its summary to the line")
    p.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                   help="train: also time make_train_step(chain=K), K steps "
                        "a call (a CUDA graph's replays)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the benchmark runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = bench_train(args) if args.mode == "train" else bench_predict(args)
    print(json.dumps({**record, "roi_align": args.roi_align, **device_meta()}))


if __name__ == "__main__":
    main()
