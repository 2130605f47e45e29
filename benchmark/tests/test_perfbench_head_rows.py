"""``head_row_share.serve``: the rows pass 2's head runs on over the
detection slots, read from the program's counters in the spanned stretch.
At the viewer's own slots (100, one class keeping 10) the stretch counts 11
rows a request; the reader gives that share, and gives nothing on the CPU,
without the program's tracer, or from a program that does not count the
head's rows."""

import argparse
import sys

from benchmark import run as bench_run
from benchmark import spans
from benchmark.tests.rehearsal import PARAMS, rehearse

READ = bench_run.load_reader("head_row_share.serve")


def _stretch(counters):
    return {"summary": {"counters": counters}}


def test_viewer_stretch_counts_eleven_head_rows_a_request(monkeypatch):
    cell = "darknet_keypoint-serve"
    args = argparse.Namespace(workload=cell, seed=2**31 + 7, seconds=0.01, trace=1)
    run = bench_run.Run(args, device="cpu",
                        overrides={"train": {"image_size": [256, 320]}})
    run.work["params"].update(PARAMS[cell])
    out = spans.serve(run)
    n = run.work["params"]["trace_requests"]
    counters = out["summary"]["counters"]
    assert counters["detection_slots"] == n * 100
    assert counters["head_rows"] == n * 11
    readings = object()
    monkeypatch.setattr(spans, "result", lambda r: out if r is readings else None)
    assert READ(readings) == 0.11


def test_reader_gives_nothing_from_a_program_without_the_counter(monkeypatch):
    readings = object()
    monkeypatch.setattr(spans, "result", lambda r: _stretch({"detection_slots": 100}))
    assert READ(readings) is None
    monkeypatch.setattr(spans, "result", lambda r: _stretch(
        {"detection_slots": 100, "head_rows": 100}))
    assert READ(readings) == 1.0


def test_reader_gives_nothing_on_the_cpu():
    line = rehearse("darknet_keypoint-serve", trace=1)
    assert line["correct"]
    assert "head_row_share.serve" not in line["metrics"]


def test_reader_gives_nothing_without_the_programs_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "maskrcnn_tpu_torch.utils.tracing", None)
    assert READ(object()) is None
