"""The port's tracer (``maskrcnn_tpu_torch/utils/tracing.py``) on the CPU.

Off, it records nothing and opens no ``record_function``. On, spans nest
with their parents and their request or step ids, counters add up across
calls, a stage recorder gives each request's or step's stage ms (host
time on the CPU), and a request or a train step traced gives the same
results, bit for bit, as one untraced, with the five serving or six
training stages in order. Under ``torch.profiler`` the program's spans
appear among the profiler's events with the same nesting. The card's side
(stage events captured into the graphs, counters in replays) is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step, stack_batches  # noqa: E402
from maskrcnn_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(1)

SERVE_STAGES = ["backbone", "proposals", "box_head", "detections", "mask_head"]
TRAIN_STAGES = ["forward", "proposals", "targets", "heads", "backward", "optimizer"]


@pytest.fixture
def tracer():
    tracing.disable()
    tracing.reset()
    yield tracing.TRACER
    tracing.disable()
    tracing.reset()


def _serve_cfg(preset):
    """b1 128×160 requests with 8 detection slots."""
    base = cfg_lib.PRESETS[preset]()
    return cfg_lib._rep(base, train=dict(batch_size=1, image_size=(128, 160)),
                        proposals=dict(n_test_pre_nms=128, n_test_post_nms=16),
                        eval=dict(max_detections=8))


@pytest.fixture(scope="module", params=["tiny_test", "darknet_keypoint"])
def served(request):
    cfg = _serve_cfg(request.param)
    model = MaskRCNN(cfg, device="cpu", seed=0)
    req = tuple(SyntheticRequests(cfg, seed=1).batch(0))[:3]
    return cfg, make_predict_fn(cfg, model), req


def _train_cfg(accum=1):
    return cfg_lib._rep(cfg_lib.tiny_test(),
                        train=dict(batch_size=2, image_size=(128, 160),
                                   grad_accum_steps=accum),
                        proposals=dict(n_train_pre_nms=256, n_train_post_nms=32),
                        sampler=dict(n_sample=16))


def _same(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g, w), name


def test_off_records_nothing_and_opens_no_record_function(tracer, served, monkeypatch):
    def refuse(name, args=None):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, predict, req = served
    predict(*req)
    predict.eager(*req)
    assert tracing.span("predict", 0) is tracing.NOOP
    assert tracing.stages("cpu") is tracing.NOOP
    tracing.count("proposals_kept", torch.ones(3))
    assert tracing.summary() == {"units": 0, "stages_ms": {}, "stage_kinds": [],
                                 "spans_ms": {}, "counters": {}, "counters_per_unit": {}}
    assert tracer.spans == [] and tracer.readings == [] and tracer.pending == []


def test_spans_nest_with_parents_and_unit_ids(tracer):
    tracing.enable()
    with tracing.span("call", 7):
        with tracing.span("call.a"):
            with tracing.span("step", 9):
                pass
        with tracing.span("call.b"):
            pass
    with tracing.span("alone"):
        pass
    spans = {s.name: s for s in tracer.spans}
    assert [s.name for s in sorted(tracer.spans)] == ["call", "call.a", "step", "call.b",
                                                       "alone"]
    assert spans["call"].parent == -1 and spans["alone"].parent == -1
    assert spans["call.a"].parent == spans["call.b"].parent == spans["call"].id
    assert spans["step"].parent == spans["call.a"].id
    assert {n: s.unit for n, s in spans.items()} == {
        "call": 7, "call.a": 7, "step": 9, "call.b": 7, "alone": None}
    outer, inner = spans["call"], spans["step"]
    assert outer.start_ns <= spans["call.a"].start_ns <= inner.start_ns
    assert inner.end_ns <= spans["call.a"].end_ns <= spans["call.b"].start_ns
    assert spans["call.b"].end_ns <= outer.end_ns <= spans["alone"].start_ns


def test_counters_add_up_across_calls(tracer):
    tracing.enable()
    for i in range(3):
        with tracing.span("request", i), tracing.stages("cpu"):
            tracing.stage("work")
            tracing.count("kept", torch.tensor([True, False, True]))
            tracing.count("slots", 3, "cpu")
            tracing.count("ints", torch.arange(i + 1))
    s = tracing.summary()
    assert s["counters"] == {"kept": 6, "slots": 9, "ints": 0 + 1 + 3}
    assert s["counters_per_unit"] == {"kept": 2.0, "slots": 3.0, "ints": 4 / 3}
    assert s["units"] == 3
    tracing.reset()
    tracing.count("slots", 5, "cpu")
    assert tracing.summary()["counters"] == {"slots": 5}


def test_stage_ms_summed_a_unit_and_spans_by_percentile(tracer, monkeypatch):
    """Host stages on a fake clock: a stage repeated in one unit is summed,
    the median is over units; a span's p50 and p95 interpolate."""
    clock = iter(range(0, 10**9, 10**6))  # 1 ms a reading
    monkeypatch.setattr(tracing.time, "perf_counter_ns", lambda: next(clock))
    tracing.enable()
    for unit, repeats in ((0, 1), (1, 2), (2, 1)):
        with tracing.span("request", unit):
            with tracing.stages("cpu"):
                for _ in range(repeats):
                    tracing.stage("a")
                    tracing.stage("b")
    s = tracing.summary()
    assert s["stage_kinds"] == ["host"] and s["units"] == 3
    assert s["stages_ms"] == {"a": 1.0, "b": 1.0}  # units read 1, 2, 1 ms
    req = s["spans_ms"]["request"]
    assert req["n"] == 3 and req["p50"] == 4.0  # 4, 6 and 4 ms
    assert req["p95"] == pytest.approx(np.percentile([4.0, 6.0, 4.0], 95))


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys(q):
    values = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6]
    assert tracing.percentile(values, q) == pytest.approx(np.percentile(values, q))


def test_traced_request_equals_untraced_and_marks_five_stages(tracer, served):
    cfg, predict, req = served
    plain = predict(*req)
    tracing.enable()
    traced = predict(*req)
    eager = predict.eager(*req)
    tracing.disable()
    _same(traced, plain)
    _same(eager, plain)
    s = tracing.summary()
    assert list(s["stages_ms"]) == SERVE_STAGES and s["stage_kinds"] == ["host"]
    assert all(v > 0 for v in s["stages_ms"].values())
    assert s["units"] == 2  # two calls, two request ids
    assert {n: v["n"] for n, v in s["spans_ms"].items()} == {"predict": 1,
                                                              "predict.eager": 1}
    d, r = cfg.eval.max_detections, cfg.proposals.n_test_post_nms
    c = s["counters"]
    assert c["detection_slots"] == 2 * d and c["proposal_slots"] == 2 * r
    assert c["detections_valid"] == 2 * int(plain.valid.sum())
    assert 0 < c["proposals_kept"] <= 2 * r
    assert c["detections_valid"] <= c["nms_candidates"] <= 2 * r * cfg.model.n_fg_class


def _fresh_state(cfg):
    return create_train_state(cfg, MaskRCNN(cfg, device="cpu", seed=0), seed=5)


@pytest.mark.parametrize("accum", [1, 2])
def test_traced_train_step_takes_the_same_step_and_marks_six_stages(tracer, accum):
    cfg = _train_cfg(accum)
    batch = SyntheticDetectionData(cfg, seed=0).batch(0)
    runs = []
    for on in (False, True):
        state = _fresh_state(cfg)
        (tracing.enable if on else tracing.disable)()
        metrics = make_train_step(cfg)(state, batch)
        runs.append((metrics, dict(state.model.named_parameters())))
    tracing.disable()
    (m0, p0), (m1, p1) = runs
    assert {k: v.tolist() for k, v in m0.items()} == {k: v.tolist() for k, v in m1.items()}
    for name, p in p0.items():
        assert torch.equal(p, p1[name]), name
    s = tracing.summary()
    assert list(s["stages_ms"]) == TRAIN_STAGES and s["units"] == 1
    n_pos_cap = int(round(cfg.sampler.n_sample * cfg.sampler.pos_ratio))
    c = s["counters"]
    assert c["mask_roi_slots"] == n_pos_cap * cfg.train.batch_size
    assert c["mask_rois_pos"] == int(m1["n_pos_rois"])
    assert c["proposal_slots"] == cfg.proposals.n_train_post_nms * cfg.train.batch_size
    assert {"train_call", "train.stage", "train.draws", "train.step"} == set(s["spans_ms"])


def test_chained_steps_on_the_cpu_are_units_of_their_own(tracer):
    cfg = _train_cfg()
    data = SyntheticDetectionData(cfg, seed=0)
    state = _fresh_state(cfg)
    tracing.enable()
    make_train_step(cfg, chain=2)(state, stack_batches([data.batch(0), data.batch(1)]))
    s = tracing.summary()
    assert s["units"] == 2 and list(s["stages_ms"]) == TRAIN_STAGES
    assert sorted(sp.unit for sp in tracer.spans if sp.name == "train_call") == [0, 1]
    assert s["counters_per_unit"]["proposal_slots"] == 2 * cfg.proposals.n_train_post_nms


def test_spans_appear_under_the_profiler_with_their_nesting(tracer):
    from torch.profiler import ProfilerActivity, profile

    cfg = _train_cfg()
    state = _fresh_state(cfg)
    step = make_train_step(cfg)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, SyntheticDetectionData(cfg, seed=0).batch(0))
    names = {"train_call", "train.stage", "train.draws", "train.step"}
    events = [e for e in prof.events() if e.name in names]
    assert {e.name for e in events} == names

    def enclosing(e):
        p = e.cpu_parent
        while p is not None and p.name not in names:
            p = p.cpu_parent
        return None if p is None else p.name

    assert {e.name: enclosing(e) for e in events} == {
        "train_call": None, "train.stage": "train_call", "train.draws": "train_call",
        "train.step": "train_call"}
    mine = {s.name: s for s in tracer.spans}
    parents = {s.name: mine[n].name for s in tracer.spans
               for n in mine if mine[n].id == s.parent}
    assert parents == {"train.stage": "train_call", "train.draws": "train_call",
                       "train.step": "train_call"}


def test_bench_traced_summarises_only_the_traced_calls(tracer, served):
    from maskrcnn_tpu_torch.bench import traced

    _, predict, req = served
    s = traced(predict, [req], [req, req])
    assert s["units"] == 2 and s["spans_ms"]["predict"]["n"] == 2
    assert list(s["stages_ms"]) == SERVE_STAGES
    assert not tracing.is_on() and tracer.spans == []
