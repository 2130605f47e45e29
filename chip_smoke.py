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
   pair (``region_scatter_exact``). ROIs lie on all five levels, many on one
   object, some with windows that run past the end of the buffer;
4. the serving path: ``fpn_mask`` at full width (ResNet-50-FPN, 80 classes,
   800×1024, batch 1, seeded random weights, class scores spread to a
   chosen load that fills every detection slot) serves synthetic requests
   through ``make_predict_fn``; every kernel's launch count is read around
   that run; one request is served again on the CPU (plain versions) and
   must agree;
5. the train path: the same model at batch 2 takes one warm-up step and
   three counted steps on synthetic batches through ``make_train_step``
   (12000/2000 proposals, 256 sampled ROIs per image); the launch counts
   are read around the three steps (forward kernel 2 per step, region
   scatter 1 per step), every loss term must be finite and every parameter,
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
10. the kernels line: each kernel on the inputs the main paths gave it,
   held against its plain version, with both times, its bound (for the
   ROIAlign forward the work these inputs need, with the dense count beside
   it; for the region scatter its scratch's cost beside it) and, where one
   PyTorch call computes the same function, that call's time; the matrix
   products that build the region scatter's input are timed beside it, and
   ``torch.profiler`` counts the device kernels of one region-scatter call
   in each dtype pair. With ``--against``, the ROIAlign forward source of
   another checkout (same C interface) is built too and timed on the same
   inputs in the order other, this, this, other.

The last three lines of standard output are the card's name and power limit,
the kernels JSON line and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from maskrcnn_tpu_torch.bench import (
    passing_pairs,
    percentile,
    predict_config,
    spread_class_scores,
    time_requests,
    time_train_steps,
)
from maskrcnn_tpu_torch import config as cfg_lib
from maskrcnn_tpu_torch.data.synthetic import (
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn
from maskrcnn_tpu_torch.kernels import region_scatter_cuda, roi_align_cuda
from maskrcnn_tpu_torch.kernels.build import nvcc_path
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN, pyramid_shapes
from maskrcnn_tpu_torch.ops import roi_align as roi_align_ops
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels
from maskrcnn_tpu_torch.train.state import create_train_state
from maskrcnn_tpu_torch.train.step import SamplerDraws, make_train_step
from maskrcnn_tpu_torch.utils.device import card_name_and_power_limit

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F32_TOL = 1e-5  # kernel vs plain, max abs / max |plain|: summation order
#   (the region scatter adds with atomics, in an order that varies per run)
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
N_REQUESTS = 8  # served through the predict path, after one warm-up request
N_TRAIN_STEPS = 3  # taken through the train path, after one warm-up step
BF16_SETTINGS = dict(dtype="bfloat16")  # phases 7 and 9's serving
BF16_TRAIN_SETTINGS = dict(dtype="bfloat16", freeze_bn=False)  # 8 and 9

ROI_ALIGN = roi_align_cuda.roi_align_fwd
SCATTER = region_scatter_cuda.region_scatter
# every hand-written kernel of the main paths: (wrapper, plain version,
# source, the Pallas kernel it replaces)
KERNELS = [
    (ROI_ALIGN, roi_align_cuda.roi_align_region_plain,
     "maskrcnn_tpu_torch/kernels/csrc/roi_align_fwd.cu",
     "maskrcnn_tpu/kernels/roi_align_pallas.py:116"),
    (SCATTER, region_scatter_cuda.region_scatter_plain,
     "maskrcnn_tpu_torch/kernels/csrc/region_scatter.cu",
     "maskrcnn_tpu/kernels/region_scatter_pallas.py:121"),
]


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, runs: int = 21, calls: int = 10) -> float:
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
        torch.cuda._sleep(BUSY_CYCLES)
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
    element over the f32 peak. Beside it and not in it, ``scratch_ms``: what
    this design adds when the accumulator's dtype is not the output's, its
    (s_rows, C) scratch written zeroed and read by the cast at the least
    (the TPU kernel sums in on-chip memory and needs no scratch)."""
    c = d_regs.shape[-1]
    n_bytes = (d_regs.numel() * d_regs.element_size() + 8 * base.numel()
               + s_rows * c * d_regs.element_size())
    scratch = 0 if acc_dtype == d_regs.dtype else 2 * s_rows * c * acc_dtype.itemsize
    return {"bytes_ms": 1e3 * n_bytes / HBM_BYTES_PER_S,
            "ops_ms": 1e3 * d_regs.numel() / F32_FLOPS,
            "scratch_ms": 1e3 * scratch / HBM_BYTES_PER_S}


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
    order). Returns the kernel's max and mean error and the plain version's
    mean error, as shares of max |exact|, and the largest share of its
    bound that an element's error takes."""
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
               for m in ("triton", "ninja", "torchvision")}
    print(f"[device] nvidia-smi: {card_name_and_power_limit()}")
    print(f"[device] nvcc: {nvcc.splitlines()[-1] if nvcc else 'absent'}; "
          f"python modules present: {present}")
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
        for dt, acc in SCATTER_PAIRS:
            args = (d_regs.to(dt), base, stride, s_rows, acc)
            label = f"b{b} R={b * n} {str(dt)[6:]} in, {str(acc)[6:]} accumulator"
            check = scatter_check(SCATTER(*args), plain(*args), args, label)
            torch.cuda.synchronize()
            ms = time_ms(lambda: SCATTER(*args))
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
                  f"{max(b_ms['bytes_ms'], b_ms['ops_ms']):.4f} ms, scratch "
                  f"beside it {b_ms['scratch_ms']:.4f} ms)")
            if dt == acc == F32:
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


def reset_launches():
    for kernel, *_ in KERNELS:
        kernel.launches = 0


def read_launches() -> dict:
    return {kernel.name: kernel.launches for kernel, *_ in KERNELS}


def phase_predict(n_requests: int, seed: int, settings=None):
    """Serve requests through the port's predict on the card; with
    ``settings`` (model config fields) in that configuration, else float32
    and held against the CPU."""
    cfg = cfg_lib._rep(predict_config("fpn_mask", 1, 800, 1024),
                       model=settings or {})
    tag = "predict" if settings is None else "bf16-predict"
    t0 = time.perf_counter()
    model = spread_class_scores(MaskRCNN(cfg, seed=seed))
    checksum = sum(float(v.double().abs().sum()) for v in model.state_dict().values())
    predict = make_predict_fn(cfg, model)
    data = SyntheticRequests(cfg, seed=seed)
    requests = [tuple(data.batch(i)) for i in range(n_requests)]
    print(f"[{tag}] fpn_mask 800x1024 b1 {cfg.model.dtype}, "
          f"{cfg.model.n_fg_class} classes, weights' abs sum {checksum:.6f}, "
          f"model and {n_requests} requests ready in "
          f"{time.perf_counter() - t0:.1f} s")

    # warm-up request 0, keeping the kernel inputs it makes (2 per request)
    capture = Capture(ROI_ALIGN, 2)
    roi_align_ops.roi_align_fwd = capture
    try:
        det0 = predict(*requests[0])
        torch.cuda.synchronize()
    finally:
        roi_align_ops.roi_align_fwd = ROI_ALIGN

    reset_launches()
    times, dets = time_requests(predict, requests, warmup=0)
    launches = read_launches()
    print(f"[{tag}] launches over {n_requests} requests: {launches}")
    if launches != {"roi_align_fwd": 2 * n_requests, "region_scatter": 0}:
        fail(f"expected 2 forward launches per request, got {launches}")
    for det in dets:
        for name, value in det._asdict().items():
            if value is not None and value.is_floating_point() and not torch.isfinite(value).all():
                fail(f"non-finite {name}")
        if det.masks.shape != (1, cfg.eval.max_detections, 28, 28):
            fail(f"mask shape {tuple(det.masks.shape)}")
    print(f"[{tag}] request p50 {percentile(times, 0.5):.3f} ms, max "
          f"{max(times):.3f} ms (CUDA events, {n_requests} requests after 1 "
          f"warm-up); valid detections per request "
          f"{[int(d.valid.sum()) for d in dets]} of {cfg.eval.max_detections}")
    pairs = passing_pairs(cfg, model, predict, requests)
    print(f"[{tag}] (ROI, class) pairs above score_thresh "
          f"{cfg.eval.score_thresh} per request (untimed rerun): {pairs}")
    if settings is not None:
        return launches, capture.calls

    # the same request on the CPU, through the same port and weights
    t0 = time.perf_counter()
    cpu_model = MaskRCNN(cfg, device="cpu", seed=seed)
    cpu_model.load_state_dict(model.state_dict())
    ref = make_predict_fn(cfg, cpu_model)(*requests[0])
    print(f"[predict] request 0 on the CPU in {time.perf_counter() - t0:.1f} s, "
          f"{int(ref.valid.sum())} valid detections")
    for name in ("valid", "labels"):
        if not torch.equal(getattr(det0, name).cpu(), getattr(ref, name)):
            fail(f"GPU and CPU {name} differ")
    for name in ("boxes", "scores", "masks"):
        got, want = getattr(det0, name).cpu(), getattr(ref, name)
        err = float((got - want).abs().max())
        print(f"[predict] GPU vs CPU {name}: max abs {err:.3e}")
        if not err <= SLICE_TOL * max(1.0, float(want.abs().max())):
            fail(f"GPU and CPU {name} differ by {err}")
    return launches, capture.calls


def snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def phase_train(n_steps: int, seed: int, settings=None):
    """Take optimizer steps through the port's train step on the card; with
    ``settings`` (model config fields) in that configuration."""
    cfg = cfg_lib._rep(predict_config("fpn_mask", 2, 800, 1024),
                       model=settings or {})
    tag = "train" if settings is None else "bf16-train"
    t0 = time.perf_counter()
    state = create_train_state(cfg, MaskRCNN(cfg, seed=seed), seed)
    step = make_train_step(cfg)
    data = SyntheticDetectionData(cfg, seed=seed)
    batches = [data.batch(i) for i in range(n_steps + 1)]
    print(f"[{tag}] fpn_mask 800x1024 b2 {cfg.model.dtype}, freeze_bn "
          f"{cfg.model.freeze_bn}, {cfg.model.n_fg_class} classes, "
          f"{cfg.proposals.n_train_pre_nms}/{cfg.proposals.n_train_post_nms} "
          f"proposals, {cfg.sampler.n_sample} sampled ROIs per image; model "
          f"and {n_steps + 1} batches ready in {time.perf_counter() - t0:.1f} s")

    # the warm-up step, keeping the kernel inputs it makes
    # (and the cotangents that the products feeding the scatter get)
    fwd, bwd = Capture(ROI_ALIGN, 2), Capture(SCATTER, 1)
    d_regions = roi_align_ops._d_regions
    products = Capture(d_regions, 2)
    roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter = fwd, bwd
    roi_align_ops._d_regions = products
    try:
        step(state, batches[0])
        torch.cuda.synchronize()
    finally:
        roi_align_ops.roi_align_fwd, roi_align_ops.region_scatter = ROI_ALIGN, SCATTER
        roi_align_ops._d_regions = d_regions

    before = snapshot(state.model)
    stats = running_statistics(state.model)
    reset_launches()
    times, metrics, peak = time_train_steps(step, state, batches[1:], warmup=0)
    launches = read_launches()
    print(f"[{tag}] launches over {n_steps} steps: {launches}")
    if launches != {"roi_align_fwd": 2 * n_steps, "region_scatter": n_steps}:
        fail(f"expected 2 forward launches and 1 region scatter per step, "
             f"got {launches}")
    for i, m in enumerate(metrics):
        m = {k: float(v) for k, v in m.items()}
        print(f"[{tag}] step {i + 1}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in m.items() if k.endswith("loss"))
            + f"; sampled slots valid {int(m['n_valid_rois'])}, positive "
              f"{int(m['n_pos_rois'])} of {2 * cfg.sampler.n_sample}")
        if not all(np.isfinite(v) for v in m.values()):
            fail(f"non-finite loss at step {i + 1}: {m}")
    after = snapshot(state.model)
    still = [k for k in before if torch.equal(before[k], after[k])]
    bn = "extractor.resnet.bn1.weight"
    print(f"[{tag}] {len(before) - len(still)} of {len(before)} parameter "
          f"tensors moved; {bn} by "
          f"{float((after[bn] - before[bn]).abs().max()):.3e}")
    if still or state.step != n_steps + 1:
        fail(f"parameters that did not move: {still[:5]}; step {state.step}")
    if not cfg.model.freeze_bn:
        now = running_statistics(state.model)
        unmoved = [k for k in stats if torch.equal(stats[k], now[k])]
        print(f"[{tag}] {len(stats) - len(unmoved)} of {len(stats)} BatchNorm "
              f"running statistics moved")
        if unmoved:
            fail(f"running statistics that did not move: {unmoved[:5]}")
    ms = statistics.median(times)
    print(f"[{tag}] step p50 {ms:.3f} ms, max {max(times):.3f} ms (CUDA "
          f"events, {n_steps} steps after 1 warm-up): {2e3 / ms:.3f} images/s; "
          f"peak memory {peak / 2**30:.3f} GiB")
    return launches, fwd.calls, bwd.calls, products.calls


def running_statistics(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def phase_train_gpu_vs_cpu(seed: int):
    """One train step from the same weights, batch and sampler draws on the
    card and on the CPU: full widths and 80 classes on a 256×320 canvas
    with 1000/256 proposals, so the CPU step stays short."""
    cfg = cfg_lib._rep(predict_config("fpn_mask", 2, 256, 320),
                       proposals=dict(n_train_pre_nms=1000, n_train_post_nms=256))
    batch = SyntheticDetectionData(cfg, seed=seed).batch(0)
    gen = torch.Generator().manual_seed(seed)
    n_anchor = 3 * sum(h * w for h, w in pyramid_shapes(cfg, (256, 320)))
    draws = SamplerDraws(
        torch.rand((2, 2, 256 + cfg.train.max_gt), generator=gen),
        torch.rand((2, 2, n_anchor), generator=gen))
    step = make_train_step(cfg)
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = create_train_state(cfg, MaskRCNN(cfg, device=device, seed=seed))
        before = snapshot(state.model)
        metrics = {k: float(v) for k, v in step(state, batch, draws).items()}
        update = {k: (v - before[k]).cpu() for k, v in snapshot(state.model).items()}
        runs[device] = metrics, update
        print(f"[train] 256x320 b2 step on {device} in "
              f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
                  f"{k} {v:.6f}" for k, v in metrics.items()))
    (got, got_up), (want, want_up) = runs["cuda"], runs["cpu"]
    if (got["n_valid_rois"], got["n_pos_rois"]) != (want["n_valid_rois"],
                                                    want["n_pos_rois"]):
        fail("GPU and CPU sampled different ROI counts")
    for name, w in want.items():
        if not abs(got[name] - w) <= TRAIN_LOSS_TOL * max(abs(w), 1e-30):
            fail(f"GPU and CPU {name} differ: {got[name]} vs {w}")
    largest = max(float(u.abs().max()) for u in want_up.values())
    worst = max(want_up, key=lambda k: float((got_up[k] - want_up[k]).abs().max()))
    err = float((got_up[worst] - want_up[worst]).abs().max())
    print(f"[train] GPU vs CPU parameter update: worst tensor {worst}, max abs "
          f"{err:.3e} = {err / largest:.3e} of the largest update {largest:.3e}")
    if not err <= TRAIN_UPDATE_TOL * largest:
        fail(f"GPU and CPU updates differ by {err / largest} of the largest")
    eps = torch.finfo(torch.float32).eps
    own = {k: float(u.abs().max()) for k, u in want_up.items()}
    over = {k: max(float((got_up[k] - u).abs().max())
                   - 2 * eps * float(before[k].abs().max()), 0.0)
            / max(own[k], 1e-30) for k, u in want_up.items()}
    worst = max(over, key=over.get)
    print(f"[train] GPU vs CPU, each tensor against its own update: worst "
          f"{worst}, {over[worst]:.3e} of its largest update {own[worst]:.3e}")
    if not over[worst] <= TRAIN_OWN_TOL:
        fail(f"GPU and CPU updates of {worst} differ by {over[worst]} of its own")


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
                     f"{c['share']:.3f} of an element's rounding bound)")
        elif not rel <= F32_TOL:
            fail(f"{kernel.name} on the {label} path's inputs: error "
                 f"{rel} > {F32_TOL}")
        ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args), runs=7, calls=3)
        b = bound(*args)
        dense = ""
        if "reached" in b:  # the ROIAlign forward's bound
            dense = (f" (dense count: bytes {b['dense_bytes_ms']:.4f} / operations "
                     f"{b['dense_ops_ms']:.4f} ms; {b.pop('reached'):.3f} of the "
                     f"windows reached)")
        if "scratch_ms" in b:  # the region scatter's
            dense = f" (this design's scratch beside it {b['scratch_ms']:.4f} ms)"
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
    if "scratch_ms" in bounds:
        out["scratch_ms"] = bounds["scratch_ms"]
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


def device_kernels(fn) -> list[str]:
    """Names of the device kernels that one call of ``fn`` runs, as
    ``torch.profiler`` traces them (memory copies and sets left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def scatter_kernels_per_call(paths: dict) -> dict:
    """Device kernels one region-scatter call runs, in each (input,
    accumulator) pair, on the train paths' own windows: the zeroing of the
    accumulator, the scatter and, with a scratch, its cast."""
    by_dtype = {v[2][0][0].dtype: v[2][0] for v in paths.values() if v[2]}
    counts = {}
    for dt, acc in SCATTER_PAIRS:
        d_regs, base, stride, s_rows, _ = by_dtype[dt]
        names = device_kernels(lambda: SCATTER(d_regs, base, stride, s_rows, acc))
        key = f"{str(dt)[6:]} in, {str(acc)[6:]} accumulator"
        print(f"[kernels] region_scatter {key}: {len(names)} device kernels a "
              f"call (torch.profiler): {[n[:60] for n in names]}")
        counts[key] = len(names)
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


def phase_kernels_line(paths: dict):
    """Time each kernel on the inputs the main paths gave it (one request's
    or one step's calls, summed), beside its plain version and its bound.
    ``paths`` maps each path to (launches, ROIAlign calls, region-scatter
    calls, product calls). An entry's top-level numbers are those of the
    first path that runs the kernel (float32 predict for the ROIAlign
    forward, float32 train for the region scatter), the others are under
    the path's name; ``launches`` counts every path, ``launches_by_path``
    each."""
    (_, fwd_plain, fwd_src, fwd_repl), (_, bwd_plain, bwd_src, bwd_repl) = KERNELS
    fwd, bwd, lib, products = {}, {}, {}, {}
    for path, (_, fwd_calls, bwd_calls, product_calls) in paths.items():
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
    n = {name: {path: v[0][name] for path, v in paths.items()}
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
                phase_region_scatter_vs_plain(args.seed))
    print(f"[kernels] worst f32 error against the plain versions: {worst:.2e}")
    paths = {}
    launches, calls = phase_predict(N_REQUESTS, args.seed)
    paths["predict"] = (launches, calls, [], [])
    paths["train"] = phase_train(N_TRAIN_STEPS, args.seed)
    phase_train_gpu_vs_cpu(args.seed)
    launches, calls = phase_predict(N_REQUESTS, args.seed, BF16_SETTINGS)
    paths["bf16_predict"] = (launches, calls, [], [])
    paths["bf16_train"] = phase_train(N_TRAIN_STEPS, args.seed,
                                      BF16_TRAIN_SETTINGS)
    phase_bf16_gpu_vs_cpu(args.seed)
    entries = phase_kernels_line(paths)
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
