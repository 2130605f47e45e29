"""The spanned stretch (``benchmark/spans.py``) at a small size on the CPU:
each cell's stretch rebuilds its program, traces it with the program's own
tracer and summarises it; the readers give nothing on the CPU or from a
program without the tracer; the idle time inside the ``predict`` spans is
each span less the device's intervals clipped to it."""

import sys

import pytest

from benchmark import spans
from benchmark.tests.rehearsal import rehearse, small_run
from benchmark.trace import Trace

SERVE_STAGES = ["backbone", "proposals", "box_head", "detections", "mask_head"]
TRAIN_STAGES = ["forward", "proposals", "targets", "heads", "backward", "optimizer"]


@pytest.mark.parametrize("cell", ["fpn_mask-serve", "darknet_keypoint-serve"])
def test_serve_stretch_summarises_the_traced_requests(cell):
    run = small_run(cell, trace=1)
    out = spans.serve(run)
    s = out["summary"]
    n = run.work["params"]["trace_requests"]
    assert list(s["stages_ms"]) == SERVE_STAGES and s["stage_kinds"] == ["host"]
    assert s["units"] == n and s["spans_ms"]["predict"]["n"] == n
    assert s["counters"]["detection_slots"] == n * run.overrides["eval"]["max_detections"]
    assert 0 < s["counters"]["proposals_kept"] <= s["counters"]["proposal_slots"]
    assert out["spanned_ms_per_unit"] > 0
    assert out["idle_in_predict_ms"] is None  # no device activity on the CPU


def test_train_stretch_summarises_the_traced_steps():
    run = small_run("fpn_mask-train", trace=1)
    out = spans.train(run)
    s = out["summary"]
    params = run.work["params"]
    assert list(s["stages_ms"]) == TRAIN_STAGES
    assert s["units"] == params["trace_chains"] * params["chain"]
    assert 0 < s["counters"]["mask_rois_pos"] <= s["counters"]["mask_roi_slots"]


def test_readers_give_nothing_on_the_cpu():
    line = rehearse("fpn_mask-serve", trace=1)
    assert line["correct"]
    assert not {"backbone_graph_ms.serve", "predict_host_ms.serve",
                "detection_fill.serve"} & set(line["metrics"])


def test_readers_give_nothing_without_the_programs_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "maskrcnn_tpu_torch.utils.tracing", None)
    readings = object()
    assert spans.result(readings) is None
    assert spans.stage_ms(readings, "backbone") is None
    assert spans.fill(readings, "detections_valid", "detection_slots") is None


def test_idle_within_clips_the_device_to_each_span():
    trace = Trace(
        device=[("k1", 0, 30), ("k2", 20, 50), ("predict", 0, 200), ("k3", 150, 260)],
        host=[("predict", 10, 110), ("predict", 140, 240), ("aten::copy_", 0, 300)],
        kernels=[], wall_s=0.0, units=2, untraced_wall_s=0.0)
    # span 1: 100 µs, busy 10–50; span 2: 100 µs, busy 150–240
    assert spans.idle_within(trace, "predict", {"predict"}) == pytest.approx(
        ((100 - 40) + (100 - 90)) / 1e3 / 2)
