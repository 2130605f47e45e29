"""The train and evaluate CLIs on the ``light_head`` preset, on the CPU.

``--preset light_head`` at full width (C4 backbone, the 490-channel thin
map, the 2048-wide box layer, 14×14 masks) cut to 128×160, batch 2, 3
classes, 256/64 train and 256/32 test proposals, 16 sampled ROIs an image,
8 detections. One run of 4 steps (a snapshot at 2, an evaluation at 4),
one resumed from its step-2 checkpoint, and ``cli.evaluate --preset
light_head`` on its step-4 checkpoint, all in this process, as
``test_torch_cli.py`` holds ``fpn_mask`` (``c4_res5``, whose res5 runs on
every ROI, costs the CPU several times more; ``chip_smoke.py`` runs the
CLIs on both presets on the card): the resumed steps equal the
uninterrupted ones bit for bit, and ``cli.evaluate`` gives the in-run
report and the same detections, whose 14×14 masks are what the evaluator
pasted.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_cli import PredictSpy, _rows  # noqa: E402
from maskrcnn_tpu_torch.cli import evaluate as eval_cli  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.eval import evaluator  # noqa: E402

torch.set_num_threads(1)

SIZE = ["--image-size", "128x160", "--batch-size", "2"]
BUDGETS = dict(proposals=dict(n_train_pre_nms=256, n_train_post_nms=64,
                              n_test_pre_nms=256, n_test_post_nms=32),
               sampler=dict(n_sample=16), eval=dict(max_detections=8))
SETS = ["--preset", "light_head", "--set", "model.n_fg_class=3"] + [
    a for sec, kv in BUDGETS.items() for k, v in kv.items()
    for a in ("--set", f"{sec}.{k}={v}")]
EVAL_SETS = ["--set", "train.image_size=128x160", "--set", "train.batch_size=2"]
COMMON = ["--device", "cpu", "--eval-batches", "1", "--log-every", "1",
          "--snapshot-every", "2", "--iterations", "4", "--eval-every", "4",
          *SIZE, *SETS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("c4_cli")
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


def test_light_head_run_trains_and_resumes_bit_exactly(runs):
    root, _, _ = runs
    a = {r["iteration"]: r for r in _rows(root / "a") if "main/loss" in r}
    b = {r["iteration"]: r for r in _rows(root / "b") if "main/loss" in r}
    assert sorted(a) == [1, 2, 3, 4] and sorted(b) == [3, 4]
    for r in a.values():
        assert np.isfinite(r["main/loss"]) and r["main/roi_cls_loss"] > 0
    for it in (3, 4):
        for k, v in a[it].items():
            if k.startswith("main/") and k != "main/prefetch_starved":
                assert b[it][k] == v, (it, k)
    ca = torch.load(root / "a" / "checkpoints" / "step_00000004.pt", weights_only=False)
    cb = torch.load(root / "b" / "checkpoints" / "step_00000004.pt", weights_only=False)
    assert ca["model"]["head.fc.weight"].shape == (2048, 7 * 7 * 490)
    for k in ca["model"]:
        assert torch.equal(ca["model"][k], cb["model"][k]), k
    args = json.loads((root / "a" / "args.json").read_text())
    assert args["config"]["model"]["backbone"] == "c4"
    assert args["config"]["model"]["head"] == "light"


def test_light_head_evaluate_reproduces_the_in_run_report(runs):
    root, spies, report = runs
    val = [r for r in _rows(root / "a") if "validation/main/map" in r]
    assert len(val) == 1 and val[0]["iteration"] == 4
    in_run = {k[len("validation/main/"):]: v for k, v in val[0].items()
              if k.startswith("validation/main/")}
    assert report == in_run
    got, want = spies["evaluate"].dets, spies["a"].dets
    assert len(got) == len(want) == 1
    assert int(want[0]["valid"].sum()) > 0
    assert want[0]["masks"].shape == (2, 8, 14, 14)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
