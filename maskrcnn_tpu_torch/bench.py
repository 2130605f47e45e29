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
memory of proposal generation (exact NMS) alone; with ``--profile N`` also
the device's busy share and the kernels that take its time, traced over N
more steps. The FPN heads train through the shared window under
``--roi-align`` auto, region or fused and through two pools under gather or
pallas; the light and Res5 heads always pool twice. With
``--steps-per-dispatch K`` (K > 1) the line also holds, under ``chained``,
the same numbers for ``make_train_step(cfg, chain=K)`` from a fresh state on
the same batches: each call runs K steps, replays of a CUDA graph of the
step after the first call's capture; ms per step is a chain's time over K,
and ``--profile N`` traces N/K chains.

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
``--profile N`` also the device's busy share and the kernels that take its
time, traced over N more graphed requests. Without a GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

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
from maskrcnn_tpu_torch.utils.device import card_name_and_power_limit

# requests served before timing: lazy CUDA and cuDNN set-up, allocator growth
WARMUP = 3


def predict_config(preset: str, batch: int, height: int, width: int,
                   roi_align: str = "auto") -> cfg_lib.Config:
    return cfg_lib._rep(cfg_lib.PRESETS[preset](),
                        train=dict(batch_size=batch, image_size=(height, width)),
                        model=dict(roi_align=roi_align))


def image_size(args) -> tuple[int, int]:
    """``--height``/``--width``, each the preset's own where not given."""
    h, w = cfg_lib.PRESETS[args.preset]().train.image_size
    return args.height or h, args.width or w


def bench_config(args, batch: int) -> cfg_lib.Config:
    """The preset at the requested size with the command line's settings."""
    cfg = cfg_lib._rep(
        predict_config(args.preset, batch, *image_size(args), args.roi_align),
        model=dict(dtype=args.dtype, roi_align_acc=args.roi_align_acc,
                   remat=args.remat),
        train=dict(grad_accum_steps=args.grad_accum,
                   momentum_dtype=args.momentum_dtype))
    return cfg_lib.apply_overrides(cfg, args.set)


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


def profile_requests(predict, requests, top: int = 12) -> dict:
    """Trace ``predict(*request)`` over ``requests`` with ``torch.profiler``
    → the device's busy share of the wall time, also of the wall time of
    the same requests served untraced just before (the tracer adds host
    time to each kernel of a replayed graph), the device kernels a request
    runs and the ``top`` kernels by device time per request (a train step
    is a request here, too)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for req in requests:
        predict(*req)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            predict(*req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    n = len(requests)
    return {
        "wall_ms_per_request": wall_ms / n,
        "device_ms_per_request": busy_ms / n,
        "device_busy_share": busy_ms / wall_ms,
        # the profiler's own cost grows with a graph's kernels: the same
        # requests untraced, just before, against the traced device time
        "wall_ms_per_request_untraced": plain_ms / n,
        "device_busy_share_untraced": busy_ms / plain_ms,
        "device_kernels_per_request": sum(e.count for e in kernels) / n,
        "top_kernels_ms_per_request": [
            [e.key[:90], e.self_device_time_total / 1e3 / n, e.count // n]
            for e in kernels[:top]],
    }


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
    profiled = (profile_requests(lambda b: step(state, b),
                                 [(c,) for c in chains[n_chains:]], top=16)
                if args.profile else {})
    if profiled:  # per step, not per chain
        for key in ("wall_ms_per_request", "device_ms_per_request"):
            profiled[key] /= k
        for row in profiled["top_kernels_ms_per_request"]:
            row[1] /= k
            row[2] //= k
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
    profiled = (profile_requests(lambda b: step(state, b),
                                 [(b,) for b in batches[n:]], top=16)
                if args.profile else {})
    proposals = time_train_proposals(cfg, state.model, batches[0])
    chained = {}
    if args.steps_per_dispatch > 1:
        del state, step
        chained = {"chained": bench_chained(args, cfg, batches[:4],
                                            args.steps_per_dispatch)}
    ms = statistics.median(times)
    return {
        "metric": f"train_images_per_s_{args.preset}_{h}x{w}_b{batch}",
        "value": batch * 1e3 / ms,
        "unit": "images/s",
        "step_ms_p50": ms,
        "step_ms_max": max(times),
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


def main(argv=None):
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
    p.add_argument("--grad-accum", type=int, default=1, metavar="N",
                   help="train.grad_accum_steps")
    p.add_argument("--momentum-dtype", default=None, choices=["bfloat16"],
                   help="train.momentum_dtype (default: float32)")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE",
                   help="config override, repeatable (e.g. model.freeze_bn=False)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="then trace N more requests with torch.profiler and "
                        "add the device time by kernel to the line")
    p.add_argument("--steps-per-dispatch", type=int, default=1, metavar="K",
                   help="train: also time make_train_step(chain=K), K steps "
                        "a call (a CUDA graph's replays)")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; the benchmark runs on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    common = {"roi_align": args.roi_align,
              "device": torch.cuda.get_device_name(0),
              "card": card_name_and_power_limit(), "torch": torch.__version__}
    if args.mode == "train":
        print(json.dumps({**bench_train(args), **common}))
        return
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
    profiled = profile_requests(predict, requests[n:]) if args.profile else {}
    pairs = passing_pairs(cfg, model, predict, requests[:4])
    graph, = predict.graphs.values()
    print(json.dumps({
        "metric": f"predict_p50_ms_{args.preset}_{h}x{w}_b{batch}",
        "value": percentile(times, 0.5),
        "unit": "ms",
        "p90_ms": percentile(times, 0.9),
        "steps": args.steps,
        "eager": {"p50_ms": percentile(eager_times, 0.5),
                  "p90_ms": percentile(eager_times, 0.9)},
        "graph": {"capture_s": graph.capture_s, "captures": graph.captures,
                  "reserved_gib": graph.reserved_bytes / 2**30},
        "valid_detections_mean": sum(int(d.valid.sum()) for d in dets) / len(dets),
        "passing_pairs_per_request": pairs,
        "settings": settings(cfg),
        **common,
        **profiled,
    }))


if __name__ == "__main__":
    main()
