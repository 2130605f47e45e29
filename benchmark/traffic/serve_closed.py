"""Serving in a closed loop with one client: each request is sent when the
last one's detections are on the host.

Parameters (the workload file's ``params``): ``images``, how many distinct
batch-1 requests the seed makes (served in a seeded order, cycled);
``load``, the chosen load applied to the seed's weights
(:data:`benchmark.data.LOADS`); ``warmup``, requests served before the
window (the first runs eagerly, the second captures the request's CUDA
graph, later ones replay it), and then requests for ``warmup_s`` more
seconds, so that the card's clocks have risen before the window opens;
``sample`` requests, drawn from the seed
among the first ``sample_from``, whose outputs the reference checks;
``trace_requests`` and ``eager_requests``, the requests of the traced
stretches of a ``--trace 1`` run, replayed and uncaptured.

A request's time runs from the moment its uint8 image is handed to the
program's predict function to the moment its detections are on the host,
copied into the client's pinned receiving buffers.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import compare
from benchmark.data import Synthetic
from benchmark.readings import Readings, device_peaks, math_mode
from benchmark.trace import breakdown, record
from benchmark.weights import load_into, make_weights
from benchmark.window import percentile


class HostBuffers:
    """The client's receiving buffers: one pinned host tensor a field of the
    detections, made at the first request and reused, so that every
    request's copy to the host is a transfer and not a first touch of fresh
    pageable memory. On the CPU a copy of each field."""

    def __init__(self):
        self.buffers = None

    def receive(self, det):
        if det.boxes.device.type != "cuda":
            return type(det)(*(None if t is None else t.clone() for t in det))
        if self.buffers is None:
            self.buffers = [None if t is None else
                            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                            for t in det]
        return type(det)(*(None if b is None else b.copy_(t)
                           for b, t in zip(self.buffers, det)))


def keep(det):
    """A received request's own copy, for the comparison."""
    return type(det)(*(None if t is None else t.clone() for t in det))


def make_requests(run, params) -> dict:
    """Image index → (images, img_hw, scale): the seed's batch-1 requests."""
    data = Synthetic(run.reference_config({"train": {"batch_size": 1}}), run.seed)
    return {i: tuple(data.batch(i)[:3]) for i in range(params["images"])}


def plan(run, params):
    """The seed's order of the distinct requests, and the request indices
    whose outputs the reference checks."""
    rng = np.random.default_rng(run.seed)
    order = rng.permutation(params["images"])
    sample = set(rng.choice(params["sample_from"], params["sample"],
                            replace=False).tolist())
    return order, sample


def run(run) -> dict:
    """Serve the cell on the card with one intra-op thread, as a client
    process with few threads: the image's copy into the program's pinned
    buffer then runs on the calling thread and waits on no pool of threads
    that shares the host's cores with other processes. The thread count is
    restored on the way out."""
    threads = torch.get_num_threads()
    if run.device == "cuda":
        torch.set_num_threads(1)
    try:
        return serve(run)
    finally:
        torch.set_num_threads(threads)


def serve(run) -> dict:
    from maskrcnn_tpu_torch.eval.predict import make_predict_fn
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN

    params = run.work["params"]
    pcfg, rcfg = run.program_config(), run.reference_config()
    dev = torch.device(run.device)
    order, sample = plan(run, params)
    requests = make_requests(run, params)
    run.mark("requests")
    model = MaskRCNN(pcfg, device=dev)
    run.mark("model")
    load_into(model, make_weights(rcfg, run.seed, dev, params.get("load")))
    run.mark("weights")
    predict = make_predict_fn(pcfg, model)
    to_host = HostBuffers().receive
    for i in range(params["warmup"]):
        to_host(predict(*requests[order[i % len(order)]]))
        run.mark(f"request {i}")
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < params.get("warmup_s", 0):
        to_host(predict(*requests[order[i % len(order)]]))
        i += 1

    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's scans in the window
    t_open = run.open_window()
    latencies, served, failed = [], {}, 0
    i = 0
    while True:
        img = int(order[i % len(order)])
        t0 = time.perf_counter()
        out = to_host(predict(*requests[img]))
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if not torch.isfinite(out.scores).all():
            failed += 1
        if i in sample:
            served[i] = (img, keep(out))
        i += 1
        if t1 - t_open >= run.seconds:
            break
    window_s = t1 - t_open
    run.window_closed()
    gc.unfreeze()

    ms = [t * 1e3 for t in latencies]
    readings = result_breakdown = None
    if run.trace:
        reqs = [requests[int(order[j % len(order)])]
                for j in range(params["trace_requests"])]

        def graphed():
            for req in reqs:
                to_host(predict(*req))

        def eager():
            for req in reqs[:params["eager_requests"]]:
                to_host(predict.eager(*req))

        graphed_trace = record(graphed, len(reqs))
        eager_trace = record(eager, params["eager_requests"])
        readings = Readings(
            run.name, run.config, params, device_peaks(), math_mode(run.config), window_s,
            len(latencies), run.config["model_flops"]["request"],
            run.reserved_peak, graphed_trace, eager_trace,
            {"request_ms_p95": percentile(ms, 95)})
        result_breakdown = breakdown(graphed_trace)

    del predict, model
    compare.free_device()
    t_check = time.perf_counter()
    numbers, counted = check(run, rcfg, requests, served)
    ok, rows, beside = compare.verdict(numbers, run.work["limits"])
    counted.update(beside, seconds=time.perf_counter() - t_check)
    return {"correct": ok and failed == 0, "attempted": len(latencies),
            "failed": failed, "compared": rows, "readings": readings,
            "breakdown": result_breakdown, "checked": counted,
            "end_to_end": {"request_ms_p50": percentile(ms, 50)}}


def reference_model(run, rcfg):
    from benchmark.reference.maskrcnn import MaskRCNN
    model = MaskRCNN(rcfg, device=run.device)
    load_into(model, make_weights(rcfg, run.seed, torch.device(run.device),
                                  run.work["params"].get("load")))
    return model


def check(run, rcfg, requests, served) -> dict:
    model = reference_model(run, rcfg)
    try:
        return compare.serve_numbers(rcfg, model, requests, served)
    finally:
        del model
