#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``maskrcnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure exits non-zero before the result is printed:

1. device: require CUDA, print the torch build and the card; TF32 off for
   matmul and cuDNN, so the card computes in float32 like the CPU;
2. build: compile every hand-written kernel from the sources in this
   checkout with ``nvcc`` (sm_90a);
3. kernels against their plain versions on the card, at the shapes of the
   main path: the ROIAlign forward on an 800×1024 pyramid (C=256) at batch
   1 and 2, 300 ROIs at 7×7 and 100 at 14×14, in the region and the
   pallas window geometry, with ROIs on all five levels, thin boxes and
   windows that run past the end of the buffer; f32 and bf16 features;
4. the slice: ``fpn_mask`` at full width (ResNet-50-FPN, 80 classes,
   800×1024, batch 1, seeded random weights, class scores spread to a
   chosen load that fills every detection slot) serves synthetic requests
   through ``make_predict_fn``; every kernel's launch count is read around
   that run; one request is served again on the CPU (plain versions) and
   must agree;
5. the kernels line: each kernel on the inputs the main path gave it,
   held against its plain version, with both times and its bound.

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

import numpy as np
import torch

from maskrcnn_tpu_torch.bench import (
    passing_pairs,
    percentile,
    predict_config,
    spread_class_scores,
    time_requests,
)
from maskrcnn_tpu_torch.data.synthetic import SyntheticRequests
from maskrcnn_tpu_torch.eval.predict import make_predict_fn
from maskrcnn_tpu_torch.kernels import roi_align_cuda
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN, pyramid_shapes
from maskrcnn_tpu_torch.ops import roi_align as roi_align_ops
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels
from maskrcnn_tpu_torch.utils.device import card_name_and_power_limit

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F32_TOL = 1e-5  # kernel vs plain, max abs / max |plain|: summation order
BF16_TOL = 1e-2  # bf16 features, same measure
SLICE_TOL = 1e-3  # GPU vs CPU request: max abs / max(1, max |CPU|)
N_REQUESTS = 8  # served through the main path, after one warm-up request

# every hand-written kernel of the main path: (wrapper, plain version,
# source, the Pallas kernel it replaces)
KERNELS = [
    (roi_align_cuda.roi_align_fwd, roi_align_cuda.roi_align_region_plain,
     "maskrcnn_tpu_torch/kernels/csrc/roi_align_fwd.cu",
     "maskrcnn_tpu/kernels/roi_align_pallas.py:116"),
]


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, runs: int = 21, calls: int = 10) -> float:
    """Median over ``runs`` of the CUDA-event time per call of ``calls``
    back-to-back calls, after warm-up. Back to back, the launches queue
    ahead of the card, so a run times the kernels and not the Python that
    launches them (events around a single call would time both)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def roi_align_bound(flat, base, stride, by, bx):
    """(bytes ms, operations ms) of one ROIAlign forward on these inputs:
    the rows of the union of this call's windows inside the buffer, the
    geometry and weights read once and the output written once, over the
    memory rate; the two dense contractions' FLOPs over the f32 peak."""
    r, oh, ty = by.shape
    ow, tx = bx.shape[1:]
    s, c = flat.shape
    rows = (base.long()[:, None, None]
            + torch.arange(ty, device=flat.device)[None, :, None] * stride.long()[:, None, None]
            + torch.arange(tx, device=flat.device)[None, None, :]).reshape(-1)
    n_rows = torch.unique(rows[(rows >= 0) & (rows < s)]).numel()
    n_bytes = (n_rows * c * flat.element_size() + 8 * r
               + 4 * (by.numel() + bx.numel()) + 4 * r * oh * ow * c)
    # out = By · W · Bxᵀ: the FLOPs of the cheaper contraction order
    flops = 2 * r * c * min(oh * ty * tx + oh * ow * tx,
                            ow * ty * tx + oh * ow * ty)
    return 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS


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


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port runs on the GPU")
    print(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"{torch.cuda.device_count()} card(s), using "
          f"{torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([roi_align_cuda.nvcc_path(), "--version"],
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
    t0 = time.perf_counter()
    for kernel, *_ in KERNELS:
        kernel.load()
    print(f"[build] {len(KERNELS)} kernel(s) built in "
          f"{time.perf_counter() - t0:.1f} s")
    for kernel, *_ in KERNELS:
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kernel.name}: {line.strip()}")


def phase_kernels_vs_plain(seed: int) -> float:
    """ROIAlign forward against its plain version → worst f32 error."""
    cfg = predict_config("fpn_mask", 1, 800, 1024)
    shapes = pyramid_shapes(cfg, (800, 1024))
    scales = tuple(1.0 / s for s in (4, 8, 16, 32, 64))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    kernel, plain = roi_align_cuda.roi_align_fwd, roi_align_cuda.roi_align_region_plain
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
                err = rel_err(kernel(*args), plain(*args))
                args16 = (flat.bfloat16(),) + args[1:]
                err16 = rel_err(kernel(*args16), plain(*args16))
                torch.cuda.synchronize()
                ms = time_ms(lambda: kernel(*args))
                plain_ms = time_ms(lambda: plain(*args))
                bound = max(roi_align_bound(*args))
                past = int((row_ids[:, -1] + bx.shape[2] > flat.shape[0]).sum())
                print(f"[kernels] roi_align_fwd b{b} R={n} {out}x{out} "
                      f"{geometry} window {by.shape[2]}x{bx.shape[2]}, "
                      f"{past} past the buffer's end: "
                      f"f32 err {err:.2e}, bf16 err {err16:.2e}, "
                      f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                      f"{bound:.4f} ms)")
                if not err <= F32_TOL:
                    fail(f"roi_align_fwd f32 error {err} > {F32_TOL}")
                if not err16 <= BF16_TOL:
                    fail(f"roi_align_fwd bf16 error {err16} > {BF16_TOL}")
                worst = max(worst, err)
    return worst


class Capture:
    """Calls ``fn`` and keeps copies of the arguments of its first ``n``
    calls: the inputs the main path gives a kernel."""

    def __init__(self, fn, n: int):
        self.fn, self.n, self.calls = fn, n, []

    def __call__(self, *args):
        if len(self.calls) < self.n:
            self.calls.append(tuple(a.clone() for a in args))
        return self.fn(*args)


def phase_slice(n_requests: int, seed: int):
    """Serve requests through the port's predict on the card."""
    cfg = predict_config("fpn_mask", 1, 800, 1024)
    t0 = time.perf_counter()
    model = spread_class_scores(MaskRCNN(cfg, seed=seed))
    checksum = sum(float(v.double().abs().sum()) for v in model.state_dict().values())
    predict = make_predict_fn(cfg, model)
    data = SyntheticRequests(cfg, seed=seed)
    requests = [tuple(data.batch(i)) for i in range(n_requests)]
    print(f"[slice] fpn_mask 800x1024 b1, {cfg.model.n_fg_class} classes, "
          f"weights' abs sum {checksum:.6f}, model and {n_requests} requests "
          f"ready in {time.perf_counter() - t0:.1f} s")

    # warm-up request 0, keeping the kernel inputs it makes (2 per request)
    capture = Capture(roi_align_cuda.roi_align_fwd, 2)
    roi_align_ops.roi_align_fwd = capture
    try:
        det0 = predict(*requests[0])
        torch.cuda.synchronize()
    finally:
        roi_align_ops.roi_align_fwd = roi_align_cuda.roi_align_fwd

    for kernel, *_ in KERNELS:
        kernel.launches = 0
    times, dets = time_requests(predict, requests, warmup=0)
    launches = {kernel.name: kernel.launches for kernel, *_ in KERNELS}
    print(f"[slice] launches over {n_requests} requests: {launches}")
    if launches["roi_align_fwd"] != 2 * n_requests:
        fail(f"roi_align_fwd launched {launches['roi_align_fwd']} times, "
             f"expected 2 per request")
    for det in dets:
        for name, value in det._asdict().items():
            if value is not None and value.is_floating_point() and not torch.isfinite(value).all():
                fail(f"non-finite {name}")
        if det.masks.shape != (1, cfg.eval.max_detections, 28, 28):
            fail(f"mask shape {tuple(det.masks.shape)}")
    print(f"[slice] request p50 {percentile(times, 0.5):.3f} ms, max "
          f"{max(times):.3f} ms (CUDA events, {n_requests} requests after 1 "
          f"warm-up); valid detections per request "
          f"{[int(d.valid.sum()) for d in dets]} of {cfg.eval.max_detections}")
    pairs = passing_pairs(cfg, model, predict, requests)
    print(f"[slice] (ROI, class) pairs above score_thresh "
          f"{cfg.eval.score_thresh} per request (untimed rerun): {pairs}")

    # the same request on the CPU, through the same port and weights
    t0 = time.perf_counter()
    cpu_model = MaskRCNN(cfg, device="cpu", seed=seed)
    cpu_model.load_state_dict(model.state_dict())
    ref = make_predict_fn(cfg, cpu_model)(*requests[0])
    print(f"[slice] request 0 on the CPU in {time.perf_counter() - t0:.1f} s, "
          f"{int(ref.valid.sum())} valid detections")
    for name in ("valid", "labels"):
        if not torch.equal(getattr(det0, name).cpu(), getattr(ref, name)):
            fail(f"GPU and CPU {name} differ")
    for name in ("boxes", "scores", "masks"):
        got, want = getattr(det0, name).cpu(), getattr(ref, name)
        err = float((got - want).abs().max())
        print(f"[slice] GPU vs CPU {name}: max abs {err:.3e}")
        if not err <= SLICE_TOL * max(1.0, float(want.abs().max())):
            fail(f"GPU and CPU {name} differ by {err}")
    return launches, capture.calls


def phase_kernels_line(launches, calls):
    """Time each kernel on the inputs the main path gave it (one request's
    calls, summed), beside its plain version and its bound."""
    entries = []
    for kernel, plain, source, replaces in KERNELS:
        ms = plain_ms = bytes_ms = ops_ms = err = rel = 0.0
        for args in calls:
            got, want = kernel(*args), plain(*args)
            call_rel = rel_err(got, want)
            if not call_rel <= F32_TOL:
                fail(f"{kernel.name} on the main path's inputs: error "
                     f"{call_rel} > {F32_TOL}")
            err = max(err, float((got - want).abs().max()))
            rel = max(rel, call_rel)
            call_ms = time_ms(lambda: kernel(*args))
            call_plain = time_ms(lambda: plain(*args))
            b_ms, o_ms = roi_align_bound(*args)
            print(f"[kernels] {kernel.name} main-path call R={args[3].shape[0]} "
                  f"{args[3].shape[1]}x{args[4].shape[1]}: {call_ms:.4f} ms, "
                  f"plain {call_plain:.4f} ms, bound bytes {b_ms:.4f} / "
                  f"operations {o_ms:.4f} ms, error {call_rel:.2e}")
            ms, plain_ms = ms + call_ms, plain_ms + call_plain
            bytes_ms, ops_ms = bytes_ms + b_ms, ops_ms + o_ms
        entries.append({
            "name": kernel.name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kernel.name],
            "max_abs_err": err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,  # no one PyTorch call computes ROIAlign
        })
    return entries


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    phase_device()
    phase_build()
    worst = phase_kernels_vs_plain(args.seed)
    print(f"[kernels] worst f32 error against the plain versions: {worst:.2e}")
    launches, calls = phase_slice(N_REQUESTS, args.seed)
    entries = phase_kernels_line(launches, calls)
    torch.cuda.synchronize()

    print(card_name_and_power_limit())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
