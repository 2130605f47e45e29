"""cuDNN's timed choice of convolution engines
(``maskrcnn_tpu_torch/models/layers.py:tuned_convolutions``) on the CPU.

The scope turns ``torch.backends.cudnn.benchmark`` on for the eager passes
that come before a capture (an eager request, an eager train step), and
sets it back afterwards, also when the body raises; it caps how many
candidates cuDNN times (``benchmark_limit``, restored too) and touches no
other cuDNN flag. With tracing on, the port's ``Conv2d``/``ConvTranspose2d``
count each forward problem the first time it runs: ``conv_problems_tuned``
inside the scope, ``conv_problems_untuned`` outside (the tracer keeps the
problems it has seen across resets, as cuDNN keeps its engines; the
fixture forgets them, so each test starts from a process that has seen
none). The card's side (the timed engines in a replayed graph, float32
error) is in ``tests/test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.layers import (  # noqa: E402
    BENCHMARK_LIMIT,
    Conv2d,
    ConvTranspose2d,
    tuned_convolutions,
)
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils import tracing  # noqa: E402

torch.set_num_threads(1)

CUDNN_FLAGS = ("enabled", "deterministic", "allow_tf32", "benchmark_limit")


@pytest.fixture
def tracer():
    tracing.disable()
    tracing.reset()
    tracing.TRACER.seen.clear()
    yield tracing.TRACER
    tracing.disable()
    tracing.reset()
    tracing.TRACER.seen.clear()


@pytest.fixture(scope="module", params=["tiny_test", "darknet_keypoint"])
def served(request):
    """b1 128×160 requests with 8 detection slots."""
    cfg = cfg_lib._rep(cfg_lib.PRESETS[request.param](),
                       train=dict(batch_size=1, image_size=(128, 160)),
                       proposals=dict(n_test_pre_nms=128, n_test_post_nms=16),
                       eval=dict(max_detections=8))
    model = MaskRCNN(cfg, device="cpu", seed=0)
    req = tuple(SyntheticRequests(cfg, seed=1).batch(0))[:3]
    return model, make_predict_fn(cfg, model), req


def _convs(model):
    return [m for m in model.modules() if isinstance(m, (Conv2d, ConvTranspose2d))]


class Spy:
    """Forward hooks on every convolution of a model: the benchmark flag
    each call saw, and each call's problem, keyed here from the module's
    own settings and its input."""

    def __init__(self, model, raise_at=None):
        self.flags, self.problems, self.raise_at = [], set(), raise_at
        self.handles = [m.register_forward_hook(self.hook) for m in _convs(model)]

    def hook(self, module, inputs, output):
        x = inputs[0]
        self.flags.append(torch.backends.cudnn.benchmark)
        self.problems.add((type(module).__name__, tuple(x.shape), tuple(module.weight.shape),
                           module.stride, module.padding, module.dilation, module.groups,
                           getattr(module, "output_padding", None),
                           x.is_contiguous(memory_format=torch.channels_last)))
        if len(self.flags) == self.raise_at:
            raise RuntimeError("planted in a convolution's forward")

    def remove(self):
        for h in self.handles:
            h.remove()


@pytest.mark.parametrize("before", [False, True])
def test_a_request_runs_its_convolutions_under_the_scope_and_restores_the_flag(
        served, before):
    model, predict, req = served
    torch.backends.cudnn.benchmark = before
    spy = Spy(model)
    try:
        predict(*req)
    finally:
        spy.remove()
        after = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = False
    assert spy.flags and all(spy.flags), spy.flags
    assert after is before


def test_the_flag_is_restored_when_the_body_raises(served):
    model, predict, req = served
    torch.backends.cudnn.benchmark = False
    spy = Spy(model, raise_at=3)
    try:
        with pytest.raises(RuntimeError, match="planted"):
            predict(*req)
    finally:
        spy.remove()
    assert spy.flags == [True] * 3
    assert torch.backends.cudnn.benchmark is False
    with pytest.raises(ValueError), tuned_convolutions():
        raise ValueError
    assert torch.backends.cudnn.benchmark is False


def test_the_scope_caps_the_search_and_sets_no_other_cudnn_flag():
    cudnn = torch.backends.cudnn
    saved = {name: getattr(cudnn, name) for name in CUDNN_FLAGS + ("benchmark",)}
    try:
        # away from the defaults, so that a scope that reset them would show
        cudnn.deterministic, cudnn.allow_tf32, cudnn.benchmark_limit = True, False, 7
        before = {name: getattr(cudnn, name) for name in CUDNN_FLAGS}
        with tuned_convolutions():
            inside = {name: getattr(cudnn, name) for name in CUDNN_FLAGS}
            assert cudnn.benchmark is True
        assert inside == {**before, "benchmark_limit": BENCHMARK_LIMIT}
        assert {name: getattr(cudnn, name) for name in CUDNN_FLAGS} == before
        assert cudnn.benchmark is False
    finally:
        for name, value in saved.items():
            setattr(cudnn, name, value)


def test_the_first_request_counts_each_problem_once_as_tuned(tracer, served):
    model, predict, req = served
    tracing.enable()
    spy = Spy(model)
    try:
        predict(*req)
        first = dict(tracing.summary()["counters"])
        predict(*req)
        second = dict(tracing.summary()["counters"])
        tracing.reset()
        predict(*req)
        after_reset = tracing.summary()["counters"]
    finally:
        spy.remove()
    assert first["conv_problems_tuned"] == len(spy.problems) > 0
    assert "conv_problems_untuned" not in first
    assert second["conv_problems_tuned"] == first["conv_problems_tuned"]
    assert "conv_problems_untuned" not in second
    assert not {"conv_problems_tuned", "conv_problems_untuned"} & set(after_reset)


def test_a_convolution_run_outside_the_scope_counts_as_untuned(tracer, served):
    model, predict, req = served
    tracing.enable()
    spy = Spy(model)
    try:
        with torch.inference_mode():
            model.extract(torch.as_tensor(req[0]))
        outside = dict(tracing.summary()["counters"])
        predict(*req)  # the backbone's problems were seen: only the rest
        both = tracing.summary()["counters"]
    finally:
        spy.remove()
    backbone = outside["conv_problems_untuned"]
    assert backbone > 0 and "conv_problems_tuned" not in outside
    assert both["conv_problems_untuned"] == backbone
    assert both["conv_problems_tuned"] == len(spy.problems) - backbone


def test_with_tracing_off_nothing_is_counted(tracer, served):
    model, predict, req = served
    predict(*req)
    with torch.inference_mode():
        model.extract(torch.as_tensor(req[0]))
    assert tracer.seen == set()
    tracing.enable()
    assert not {"conv_problems_tuned", "conv_problems_untuned"} & set(
        tracing.summary()["counters"])


def test_an_eager_train_step_tunes_its_convolutions(tracer):
    cfg = cfg_lib._rep(cfg_lib.tiny_test(),
                       train=dict(batch_size=2, image_size=(128, 160)),
                       proposals=dict(n_train_pre_nms=256, n_train_post_nms=32),
                       sampler=dict(n_sample=16))
    model = MaskRCNN(cfg, device="cpu", seed=0)
    state = create_train_state(cfg, model, seed=1)
    step = make_train_step(cfg)
    batch = SyntheticDetectionData(cfg).batch(0)
    tracing.enable()
    spy = Spy(model)
    try:
        step(state, batch)
        first = dict(tracing.summary()["counters"])
        step(state, batch)
        second = tracing.summary()["counters"]
    finally:
        spy.remove()
    assert spy.flags and all(spy.flags)
    assert torch.backends.cudnn.benchmark is False
    assert first["conv_problems_tuned"] == len(spy.problems) > 0
    assert "conv_problems_untuned" not in first
    assert second["conv_problems_tuned"] == first["conv_problems_tuned"]
