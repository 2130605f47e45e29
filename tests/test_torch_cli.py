"""The port's train and evaluate CLIs, its checkpoints and its step-pure data
stream, on the CPU.

``fpn_mask`` at full width cut to 128×160, batch 2, 3 classes
(``--set model.n_fg_class=3`` over the default COCO label file), 1000/256
train and 1000/100 test proposals, 64 sampled ROIs, 16 detections. One run of 4 steps (a snapshot at 2, an evaluation at 4),
one resumed from its step-2 checkpoint, and ``cli.evaluate`` on its step-4
checkpoint, all in this process:

- the resumed run's losses, parameters, buffers and momentum equal the
  uninterrupted run's bit for bit (same stream position, optimizer state,
  sampler generator);
- ``cli.evaluate --weight`` gives the in-run report and the same detections
  exactly (a spy on the evaluator's predict records them: random weights at
  this size score 0.0 AP, so the report alone would not tell).

``--steps-per-dispatch``, the last JAX option the port lacked, is held in
``tests/test_torch_chain.py``.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.cli import evaluate as eval_cli  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.data.prefetch import Prefetcher  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.eval import evaluator  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.checkpoint import (  # noqa: E402
    latest_checkpoint,
    load_params_only,
    restore_checkpoint,
    save_checkpoint,
)
from maskrcnn_tpu_torch.train.state import MomentumSGD, create_train_state  # noqa: E402
from maskrcnn_tpu_torch.utils.metrics import MetricLogger  # noqa: E402

torch.set_num_threads(1)

SIZE = ["--image-size", "128x160", "--batch-size", "2"]
BUDGETS = dict(proposals=dict(n_train_pre_nms=1000, n_train_post_nms=256,
                              n_test_pre_nms=1000, n_test_post_nms=100),
               sampler=dict(n_sample=64), eval=dict(max_detections=16))
SETS = ["--set", "model.n_fg_class=3"] + [
    a for sec, kv in BUDGETS.items() for k, v in kv.items()
    for a in ("--set", f"{sec}.{k}={v}")]
EVAL_SETS = ["--set", "train.image_size=128x160", "--set", "train.batch_size=2"]
COMMON = ["--device", "cpu", "--eval-batches", "1", "--log-every", "1",
          "--snapshot-every", "2", "--iterations", "4", "--eval-every", "4",
          *SIZE, *SETS]


def _rows(out):
    with open(out / "log.jsonl") as f:
        return [json.loads(line) for line in f]


class PredictSpy:
    """Wraps the evaluator's ``make_predict_fn``: records every predict's
    detections."""

    def __init__(self):
        self.dets = []
        self.make = evaluator.make_predict_fn

    def __call__(self, *args, **kwargs):
        predict = self.make(*args, **kwargs)

        def spied(*a):
            det = predict(*a)
            self.dets.append({k: v.clone() for k, v in det._asdict().items()
                              if v is not None})
            return det

        return spied


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    mp = pytest.MonkeyPatch()
    try:
        spies = {}
        for name in ("a", "b", "evaluate"):
            spies[name] = PredictSpy()
            mp.setattr(evaluator, "make_predict_fn", spies[name])
            if name == "a":
                train_cli.main(["--out", str(root / "a"), *COMMON])
            elif name == "b":
                (root / "b" / "checkpoints").mkdir(parents=True)
                shutil.copy(root / "a" / "checkpoints" / "step_00000002.pt",
                            root / "b" / "checkpoints")
                train_cli.main(["--out", str(root / "b"), "--resume", *COMMON])
            else:
                report = eval_cli.main([
                    "--device", "cpu", "--n-batches", "1", "--out",
                    str(root / "report.json"), "--weight",
                    str(root / "a" / "checkpoints" / "step_00000004.pt"),
                    *SETS, *EVAL_SETS])
            mp.setattr(evaluator, "make_predict_fn", spies[name].make)
    finally:
        mp.undo()
    return root, spies, report


def test_run_writes_logs_checkpoints_and_a_validation_row(runs):
    root, _, _ = runs
    rows = _rows(root / "a")
    train_rows = [r for r in rows if "main/loss" in r]
    assert [r["iteration"] for r in train_rows] == [1, 2, 3, 4]
    for r in train_rows:
        assert np.isfinite(r["main/loss"]) and r["lr"] == pytest.approx(1e-3)
        assert 0.0 <= r["main/prefetch_starved"] <= 1.0
    val = [r for r in rows if "validation/main/map" in r]
    assert len(val) == 1 and val[0]["iteration"] == 4
    assert "validation/main/coco/map" in val[0]
    assert sorted(p.name for p in (root / "a" / "checkpoints").iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]
    args = json.loads((root / "a" / "args.json").read_text())
    assert args["config"]["model"]["n_fg_class"] == 3
    assert args["config"]["train"]["image_size"] == [128, 160]


def test_resume_is_bit_exact(runs):
    root, _, _ = runs
    a = {r["iteration"]: r for r in _rows(root / "a") if "main/loss" in r}
    b = {r["iteration"]: r for r in _rows(root / "b") if "main/loss" in r}
    assert sorted(b) == [3, 4]
    for it in (3, 4):
        for k, v in a[it].items():
            if k.startswith("main/") and k != "main/prefetch_starved":
                assert b[it][k] == v, (it, k)
    ca = torch.load(root / "a" / "checkpoints" / "step_00000004.pt", weights_only=False)
    cb = torch.load(root / "b" / "checkpoints" / "step_00000004.pt", weights_only=False)
    assert ca["step"] == cb["step"] == 4
    assert ca["model"].keys() == cb["model"].keys()
    for k in ca["model"]:
        assert torch.equal(ca["model"][k], cb["model"][k]), k
    sa, sb = ca["optimizer"]["state"], cb["optimizer"]["state"]
    assert len(sa) > 100 and sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]), k
    assert torch.equal(ca["generator"], cb["generator"])


def test_evaluate_reproduces_the_in_run_report(runs):
    root, spies, report = runs
    val = [r for r in _rows(root / "a") if "validation/main/map" in r][0]
    in_run = {k[len("validation/main/"):]: v for k, v in val.items()
              if k.startswith("validation/main/")}
    assert report == in_run
    assert json.loads((root / "report.json").read_text()) == report
    got, want = spies["evaluate"].dets, spies["a"].dets
    assert len(got) == len(want) == 1
    assert int(want[0]["valid"].sum()) > 0
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k


def _small_state(momentum_dtype=None, freeze_bn=False):
    cfg = tcfg._rep(tcfg.fpn_mask(), model=dict(n_fg_class=3, freeze_bn=freeze_bn),
                    train=dict(batch_size=2, image_size=(128, 160),
                               momentum_dtype=momentum_dtype), **BUDGETS)
    return cfg, create_train_state(cfg, MaskRCNN(cfg, device="cpu", seed=0), seed=1)


def _advance(state, seed: int):
    """Give every part of ``state`` a value a fresh state lacks: random
    gradients through one optimizer step (momentum buffers), moved BN
    running statistics, a step count and generator draws."""
    gen = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    state.optimizer.step()
    with torch.no_grad():
        for name, buf in state.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(torch.rand(buf.shape, generator=gen))
    torch.rand(5, generator=state.generator)
    state.step = 7


@pytest.mark.parametrize("momentum_dtype", [None, "bfloat16"])
def test_checkpoint_round_trip_is_exact(momentum_dtype, tmp_path):
    _, state = _small_state(momentum_dtype)
    _advance(state, 0)
    path = save_checkpoint(str(tmp_path), state)
    assert path.endswith("step_00000007.pt")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000007.pt"]
    _, fresh = _small_state(momentum_dtype)
    restore_checkpoint(path, fresh)
    assert fresh.step == 7
    want, got = state.model.state_dict(), fresh.model.state_dict()
    assert sum(k.endswith("running_mean") for k in want) > 50
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert isinstance(fresh.optimizer, MomentumSGD)
    for p_want, p_got in zip(state.model.parameters(), fresh.model.parameters()):
        b_want = state.optimizer.state[p_want]["momentum_buffer"]
        b_got = fresh.optimizer.state[p_got]["momentum_buffer"]
        assert b_got.dtype == b_want.dtype == (
            torch.bfloat16 if momentum_dtype else torch.float32)
        assert torch.equal(b_got, b_want)
    assert torch.equal(fresh.generator.get_state(), state.generator.get_state())
    # the restored optimizer takes the same next step
    for st in (state, fresh):
        for p in st.model.parameters():
            p.grad = torch.ones_like(p)
        st.optimizer.step()
    for p_want, p_got in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p_got, p_want)


def test_latest_checkpoint_and_params_only(tmp_path):
    assert latest_checkpoint(str(tmp_path / "absent")) is None
    cfg, state = _small_state(freeze_bn=True)
    with torch.no_grad():
        next(state.model.parameters()).add_(1.0)
    for step in (900, 10_000, 20):
        save_checkpoint(str(tmp_path), state, step)
    (tmp_path / "step_00099999.pt.tmp").write_bytes(b"")
    (tmp_path / "notes.txt").write_text("x")
    assert latest_checkpoint(str(tmp_path)).endswith("step_00010000.pt")
    # a step already on disk is left as it is
    assert save_checkpoint(str(tmp_path), state, 20).endswith("step_00000020.pt")

    _, fresh = _small_state(freeze_bn=True)
    gen_before = fresh.generator.get_state()
    load_params_only(latest_checkpoint(str(tmp_path)), fresh)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.step == 0 and fresh.optimizer.state_dict()["state"] == {}
    assert torch.equal(fresh.generator.get_state(), gen_before)


def test_iter_from_is_step_pure_and_matches_jax():
    cfg = tcfg._rep(tcfg.fpn_mask(), model=dict(n_fg_class=3),
                    train=dict(batch_size=2, image_size=(64, 96)))
    jdata = JaxData(jcfg._rep(jcfg.fpn_mask(), model=dict(n_fg_class=3),
                              train=dict(batch_size=2, image_size=(64, 96))),
                    seed=5)
    data = SyntheticDetectionData(cfg, seed=5)
    stream, jstream = data.iter_from(3), jdata.iter_from(3)
    for i in (3, 4, 5):
        got, want = next(stream), next(jstream)
        for name, value in got._asdict().items():
            np.testing.assert_array_equal(value, getattr(want, name), err_msg=name)
            np.testing.assert_array_equal(value, getattr(data.batch(i), name))
    first = next(iter(data))
    np.testing.assert_array_equal(first.images, data.batch(0).images)


def test_prefetcher_counts_and_surfaces_errors():
    def items():
        yield from range(3)
        raise ValueError("loader broke")

    pf = Prefetcher(items(), size=2)
    assert [next(pf) for _ in range(3)] == [0, 1, 2]
    assert pf.served == 3 and 0 <= pf.starved <= 3
    with pytest.raises(ValueError, match="loader broke"):
        next(pf)


def test_metric_logger_rows(tmp_path, capsys):
    log = MetricLogger(str(tmp_path), print_every=2)
    log.log(1, {"loss": 2.0}, n_images=2, lr=0.1)
    log.log(2, {"loss": 1.5}, n_images=2, lr=0.1)
    log.log_validation(2, {"map": 0.25, "coco/map": 0.1, "note": "skip"})
    log.close()
    rows = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2, 2]
    assert rows[1]["main/loss"] == 1.5 and rows[1]["lr"] == 0.1
    assert rows[2]["validation/main/map"] == 0.25
    assert rows[2]["validation/main/coco/map"] == 0.1
    assert "validation/main/note" not in rows[2]
    assert "main/loss" in capsys.readouterr().out
