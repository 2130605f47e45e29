"""The spanned stretch of a ``--trace 1`` run: the program's own tracer
(``maskrcnn_tpu_torch/utils/tracing.py``: host spans, stage events captured
into the replayed graphs, work counters) over the cell's traced requests or
calls. Read by the per-layer metrics ``*_graph_ms.*``,
``predict_host_ms.serve``, ``idle_in_predict_ms.serve`` and ``*_fill.*``.

A reader is handed the run's :class:`benchmark.readings.Readings`, which
holds neither the program nor the seed, and by then the traffic has freed
the program. So the first of these readers rebuilds the cell's program as
its traffic built it (configuration, overrides, seed, weights, and the same
requests or batches in the same order) from the :class:`benchmark.run.Run`
that calls the readers, runs the stretch once, and keeps the result for
the others. It runs after every other reading and after the comparison, so
it moves no number read before it. The window and every other stretch ran
with tracing off.

- **Serving** (``serve_closed``): tracing on, ``warmup`` requests make the
  traced graph (eager, capture, replay), and requests for ``warmup_s`` more
  seconds raise the card's clocks, as before the window; then the
  ``trace_requests`` requests, each received into the client's pinned
  buffers, profiler off: that pass gives the summary. Then the same requests through
  :func:`benchmark.trace.record` (an untraced pass, then a profiled one):
  the profiled pass carries the ``predict`` spans on the profiler's clock,
  and the device's idle time inside them is the idle time the program's
  own host path leaves (the rest is the client's).
- **Training** (``train_chain``): tracing on, a first call of K makes the
  traced graph (an eager step, the capture, replays); then ``trace_chains``
  calls, each fetched by its last loss: that pass gives the summary.

Nothing is read (every reader gives None) on the CPU, or from a program
without the tracer: then there is nothing of the program's to read.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from benchmark import compare
from benchmark.trace import record
from benchmark.weights import load_into, make_weights
from benchmark.window import union_length

_last = {"readings": None, "result": None}


def _calling_run(readings):
    """The run whose readers are reading ``readings``: ``per_layer(run,
    readings)`` in ``benchmark/run.py`` calls each reader with them."""
    frame = sys._getframe(1)
    while frame is not None:
        run = frame.f_locals.get("run")
        if (frame.f_locals.get("readings") is readings and run is not None
                and hasattr(run, "work") and hasattr(run, "seed")):
            return run
        frame = frame.f_back
    return None


def result(readings) -> dict | None:
    """The stretch's result for this run, made at the first call."""
    if _last["readings"] is not readings:
        _last["readings"], _last["result"] = readings, _stretch(readings)
    return _last["result"]


def _stretch(readings) -> dict | None:
    try:
        from maskrcnn_tpu_torch.utils import tracing  # noqa: F401
    except ImportError:
        return None
    run = _calling_run(readings)
    if run is None or run.device != "cuda" or not torch.cuda.is_available():
        return None
    kind = run.work["traffic"]
    out = serve(run) if kind == "serve_closed" else train(run) if kind == "train_chain" else None
    if out is not None:
        # the untraced stretch's wall a unit beside the spanned pass's
        g = readings.graphed
        out["untraced_ms_per_unit"] = 1e3 * g.untraced_wall_s / g.units if g else None
        out["window_ms_per_unit"] = 1e3 * readings.window_s / readings.units
        print(f"benchmark: spans {json.dumps(out)}", file=sys.stderr)
    return out


def _sync(run):
    if run.device == "cuda":
        torch.cuda.synchronize()


def serve(run) -> dict:
    """The serving stretch (the module's docstring) → {summary, the spanned
    pass's ms a request, idle ms a request inside ``predict``}."""
    from maskrcnn_tpu_torch.eval.predict import make_predict_fn
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.utils import tracing

    from benchmark.traffic import serve_closed

    params = run.work["params"]
    dev = torch.device(run.device)
    order, _ = serve_closed.plan(run, params)
    requests = serve_closed.make_requests(run, params)
    model = MaskRCNN(run.program_config(), device=dev)
    load_into(model, make_weights(run.reference_config(), run.seed, dev, params.get("load")))
    predict = make_predict_fn(run.program_config(), model)
    to_host = serve_closed.HostBuffers().receive
    reqs = [requests[int(order[j % len(order)])] for j in range(params["trace_requests"])]

    def requests_pass():
        for req in reqs:
            to_host(predict(*req))

    tracing.reset()
    tracing.enable()
    try:
        for j in range(params["warmup"]):
            to_host(predict(*reqs[j % len(reqs)]))
        t_warm = time.perf_counter()
        while time.perf_counter() - t_warm < params.get("warmup_s", 0):
            requests_pass()
        _sync(run)
        tracing.reset()
        t0 = time.perf_counter()
        requests_pass()
        _sync(run)
        spanned_ms = 1e3 * (time.perf_counter() - t0) / len(reqs)
        summary = tracing.summary()
        tracing.reset()
        trace = record(requests_pass, len(reqs))
    finally:
        tracing.disable()
        tracing.reset()
    del predict, model
    compare.free_device()
    names = set(summary["spans_ms"])
    busy_us = union_length((s, e) for name, s, e in trace.device if name not in names)
    return {"summary": summary, "spanned_ms_per_unit": spanned_ms,
            "idle_in_predict_ms": idle_within(trace, "predict", names),
            "profiled_ms_per_unit": 1e3 * trace.wall_s / trace.units,
            "profiled_busy_ms_per_unit": busy_us / 1e3 / trace.units}


def idle_within(trace, span: str, span_names) -> float | None:
    """Device-idle ms a unit inside the host's ``span`` spans of a profiled
    stretch: each span's length less the union of the device's intervals
    clipped to it. The profiler's device-side copies of the program's
    spans (annotations over the kernels they launched) are not activity."""
    device = [(s, e) for name, s, e in trace.device if name not in span_names]
    spans = [(s, e) for name, s, e in trace.host if name == span]
    if not spans or not device:
        return None
    idle_us = 0.0
    for s0, e0 in spans:
        inside = [(max(s, s0), min(e, e0)) for s, e in device if s < e0 and e > s0]
        idle_us += (e0 - s0) - union_length(inside)
    return idle_us / 1e3 / trace.units


def train(run) -> dict:
    """The training stretch (the module's docstring) → {summary, the
    spanned pass's ms a step}."""
    from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN
    from maskrcnn_tpu_torch.train.state import create_train_state
    from maskrcnn_tpu_torch.train.step import make_train_step
    from maskrcnn_tpu_torch.utils import tracing

    from benchmark.traffic import train_chain

    params = run.work["params"]
    k = params["chain"]
    dev = torch.device(run.device)
    stacks, _ = train_chain.feeds(run, params)
    pcfg = run.program_config()
    model = MaskRCNN(pcfg, device=dev)
    load_into(model, make_weights(run.reference_config(), run.seed, dev))
    state = create_train_state(pcfg, model, seed=train_chain.generator_seed(run.seed))
    chained = make_train_step(pcfg, chain=k)
    tracing.reset()
    tracing.enable()
    try:
        chained(state, stacks[0])["loss"][-1].item()
        tracing.reset()
        t0 = time.perf_counter()
        for j in range(params["trace_chains"]):
            chained(state, stacks[(j + 1) % len(stacks)])["loss"][-1].item()
        spanned_ms = 1e3 * (time.perf_counter() - t0) / (params["trace_chains"] * k)
        summary = tracing.summary()
    finally:
        tracing.disable()
        tracing.reset()
    del chained, state, model
    compare.free_device()
    return {"summary": summary, "spanned_ms_per_unit": spanned_ms}


def stage_ms(readings, stage: str) -> float | None:
    """A stage's median device ms a request or step, read from the events
    captured into the replayed graph."""
    out = result(readings)
    if out is None or out["summary"]["stage_kinds"] != ["graph"]:
        return None
    return out["summary"]["stages_ms"].get(stage)


def fill(readings, useful: str, slots: str) -> float | None:
    """Useful slots over slots computed, from two of the program's
    counters."""
    out = result(readings)
    if out is None:
        return None
    counters = out["summary"]["counters"]
    if not counters.get(slots):
        return None
    return counters.get(useful, 0) / counters[slots]
