"""The port bench's self-validation (``maskrcnn_tpu_torch/bench.py``), the
counterpart of the JAX bench's ``_static_flops`` and ``_validate``.

- ``step_flops`` on one ``tiny_test`` step (128×160, batch 2): positive and
  the same on two batches; within ``JAX_RATIO`` of the JAX package's own
  count of its jitted step, XLA:CPU's cost analysis taken as the root
  ``bench.py:_static_flops`` takes it (the port's count is 1.097 of it: the
  two frameworks lower the same model to other ops); with
  ``grad_accum_steps=2`` within ``ACCUM_RTOL`` of the count at 1 (the card
  runs every micro-batch). The hand kernels' wrappers add nothing: NMS's
  plain version sweeps as often as its boxes need, one ``bmm`` a sweep.
- ``validate`` with each check tripped by an input made to trip it, and a
  healthy record that carries neither ``suspect`` nor ``suspect_reason``.
- The peak table: the H100 in each math mode, ``None`` for an unknown card
  (and then no MFU key); ``--grad-accum``'s default; ``main()`` without a
  GPU exits non-zero.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    init_model,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import bench  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.kernels import nms_greedy  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils import peaks  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_RATIO = (0.85, 1.15)  # port count over XLA's, measured 1.097
ACCUM_RTOL = 1e-5
H100 = "NVIDIA H100 80GB HBM3"


def _count(batch_index: int, **train) -> int:
    cfg = tcfg._rep(tcfg.tiny_test(), train=train)
    state = create_train_state(cfg, MaskRCNN(cfg, seed=0, device="cpu"))
    batch = SyntheticDetectionData(cfg, seed=0).batch(batch_index)
    return bench.step_flops(make_train_step(cfg), state, batch)


@pytest.fixture(scope="module")
def tiny_count():
    return _count(0)


def test_count_is_positive_and_the_same_on_two_batches(tiny_count):
    assert tiny_count > 0
    assert _count(1) == tiny_count


def test_count_against_jax_cost_analysis(tiny_count):
    """The JAX bench's own count: XLA's cost analysis of the compiled step,
    through the root ``bench.py:_static_flops``."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", ROOT / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    cfg = jcfg.tiny_test()
    model, variables = init_model(cfg, jax.random.key(0))
    batch = jax.tree.map(jnp.asarray, JaxData(cfg).batch(0))
    state = jax_create_train_state(cfg, variables, jax.random.key(1))
    xla = jax_bench._static_flops(jax_make_train_step(cfg, model), state, batch)
    assert xla is not None and xla > 0
    ratio = tiny_count / xla
    assert JAX_RATIO[0] <= ratio <= JAX_RATIO[1], (tiny_count, xla, ratio)


@pytest.mark.parametrize("batch_index", [0, 3])
def test_grad_accum_counts_every_micro_batch(tiny_count, batch_index):
    accum = _count(batch_index, grad_accum_steps=2)
    assert abs(accum - tiny_count) <= ACCUM_RTOL * tiny_count, (accum, tiny_count)


def test_the_hand_kernels_add_no_count():
    """NMS's wrapper on CPU tensors runs its plain Jacobi sweeps, a ``bmm``
    each, which ``FlopCounterMode`` counts and the step's count leaves out."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 100, (2, 64, 2)).astype(np.float32)
    boxes = torch.as_tensor(np.concatenate([xy, xy + 20], axis=-1))
    valid = torch.ones((2, 64), dtype=torch.bool)
    plain = FlopCounterMode(display=False)
    with plain:
        want = nms_greedy(boxes, valid, 0.5, 64)
    assert plain.get_total_flops() > 0
    counter = bench._StepFlops(display=False)
    with counter:
        got = nms_greedy(boxes, valid, 0.5, 64)
    assert counter.get_total_flops() == 0
    assert torch.equal(got, want)


def _validated(flops=1e12, peak=peaks.H100_SXM.float32, chained=100.0,
               p50=100.0, expected=None) -> dict:
    record = {}
    bench.validate(record, flops, peak, chained, p50, expected)
    return record


def test_a_healthy_record_is_not_suspect():
    record = _validated(expected=100.0)
    assert "suspect" not in record and "suspect_reason" not in record
    assert record["step_flops"] == 1e12
    assert record["implied_tflops_per_sec"] == pytest.approx(10.0)
    assert record["implied_mfu"] == pytest.approx(10e12 / 67e12)
    assert record["expected_step_ms"] == 100.0


@pytest.mark.parametrize("case, kwargs, words", [
    # 1e12 FLOP in 20 ms is 50 TFLOP/s: 0.75 of float32's 67
    ("mfu", dict(chained=20.0, p50=20.0), "implied MFU"),
    ("clock-above", dict(chained=100.0, p50=201.0), "disagrees"),
    ("clock-below", dict(chained=100.0, p50=49.0), "disagrees"),
    ("slow", dict(chained=151.0, p50=151.0, expected=100.0), "exceeds 1.5x"),
])
def test_each_check_trips(case, kwargs, words):
    record = _validated(**kwargs)
    assert record["suspect"] is True
    assert words in record["suspect_reason"], record["suspect_reason"]
    assert ";" not in record["suspect_reason"]  # that check alone


def test_the_clock_bound_is_inclusive():
    assert "suspect" not in _validated(chained=100.0, p50=200.0)
    assert "suspect" not in _validated(chained=100.0, p50=50.0)
    assert "suspect" not in _validated(chained=150.0, p50=150.0, expected=100.0)


def test_predict_gets_the_slow_check_only():
    record = {}
    bench.validate(record, None, None, 40.0, 40.0, 20.0)
    assert record["expected_step_ms"] == 20.0 and record["suspect"] is True
    assert "step_flops" not in record and "implied_mfu" not in record


@pytest.mark.parametrize("math, want", [("float32", 67e12), ("tf32", 494.7e12),
                                        ("bfloat16", 989.4e12)])
def test_h100_peaks(math, want):
    assert peaks.peak_flops(H100, math) == want
    assert peaks.card_peaks(H100).hbm_bytes_per_s == 3.35e12


def test_an_unknown_card_has_no_peak_and_no_mfu():
    assert peaks.peak_flops("NVIDIA A100-SXM4-80GB", "bfloat16") is None
    assert peaks.card_peaks("TPU v5 lite") is None
    record = _validated(peak=peaks.peak_flops("NVIDIA A100-SXM4-80GB", "float32"))
    assert "implied_mfu" not in record and "implied_tflops_per_sec" in record
    with pytest.raises(ValueError):
        peaks.peak_flops(H100, "float16")


def test_math_mode_follows_dtype_and_tf32(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert peaks.math_mode("float32") == "float32"
    assert peaks.math_mode("bfloat16") == "bfloat16"
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert peaks.math_mode("float32") == "tf32"


@pytest.mark.parametrize("batch, want", [(32, 4), (8, 1), (2, 1)])
def test_grad_accum_default(batch, want):
    assert bench.grad_accum_default(batch) == want
    args = bench.parse_args(["--mode", "train", "--preset", "tiny_test"])
    assert bench.bench_config(args, batch).train.grad_accum_steps == want


def test_expected_times_only_for_the_recorded_settings():
    def expected(*argv, mode="train"):
        args = bench.parse_args(["--mode", mode, *argv])
        batch = args.batch or (1 if mode == "predict" else
                               tcfg.PRESETS[args.preset]().train.batch_size)
        return bench.expected_step_ms(args, bench.bench_config(args, batch), mode)

    assert expected() == bench.EXPECTED_STEP_MS[
        ("fpn_mask", 800, 1024, 2, "float32", "train", 1)]
    assert expected("--dtype", "bfloat16") is not None
    assert expected("--preset", "darknet_keypoint") is not None
    assert expected(mode="predict") is not None
    for other in (["--grad-accum", "1"], ["--remat"], ["--roi-align", "gather"],
                  ["--roi-align-acc", "bfloat16"], ["--momentum-dtype", "bfloat16"],
                  ["--set", "model.freeze_bn=False"], ["--height", "512"]):
        assert expected(*other) is None, other


def test_main_without_a_gpu_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--mode", "train", "--preset", "tiny_test"])
    assert exc.value.code not in (0, None)


def test_chip_smoke_bounds_read_the_peak_table():
    """The kernels' bounds in ``chip_smoke.py`` and the MFU read one table."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert "from maskrcnn_tpu_torch.utils.peaks import H100_SXM" in text
    assert "3.35e12" not in text and "67e12" not in text
