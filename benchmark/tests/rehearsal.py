"""A cell run end to end at a small size, past the harness's look for a
card: on the CPU the program's plain paths, on a card its kernels and
graphs; the window, the traced stretches and the comparison with the
reference."""

from __future__ import annotations

import argparse

from benchmark import run as bench_run

SMALL = {
    "fpn_mask-serve": {"train": {"image_size": [128, 160]},
                       "proposals": {"n_test_pre_nms": 256, "n_test_post_nms": 32},
                       "eval": {"max_detections": 16}},
    "darknet_keypoint-serve": {"train": {"image_size": [256, 320]},
                               "eval": {"max_detections": 8}},
    "fpn_mask-train": {"train": {"image_size": [128, 160]},
                       "proposals": {"n_train_pre_nms": 512, "n_train_post_nms": 64},
                       "sampler": {"n_sample": 32},
                       "anchor_targets": {"n_sample": 64}},
}
SMALL["fpn_mask-train-dp4"] = SMALL["fpn_mask-train"]
PARAMS = {
    "fpn_mask-serve": {"sample": 2, "sample_from": 2, "trace_requests": 2,
                       "eager_requests": 1, "warmup": 1},
    "darknet_keypoint-serve": {"sample": 2, "sample_from": 2, "trace_requests": 2,
                               "eager_requests": 1, "warmup": 1},
    "fpn_mask-train": {"chain": 2, "batches": 3},
    # two ranks of one image each: gloo on the CPU, NCCL on two cards
    "fpn_mask-train-dp4": {"ranks": 2, "global_batch": 2, "batches": 2,
                           "warmup_steps": 2, "eager_steps": 1},
}


def small_run(cell: str, seed: int = 2**31 + 11, trace: int = 0,
              seconds: float = 0.01, device: str = "cpu") -> bench_run.Run:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    run = bench_run.Run(args, device=device, overrides=SMALL[cell])
    run.work["params"].update(PARAMS[cell])
    return run


def rehearse(cell: str, **kw) -> dict:
    run = small_run(cell, **kw)
    line = bench_run.execute(run)
    line["setup_s"] = run.window_open - bench_run.PROCESS_START
    return line
