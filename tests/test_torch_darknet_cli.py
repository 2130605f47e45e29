"""The port's CLIs with the Darknet presets, on the CPU.

- ``cli.train --preset darknet_keypoint --dataset depth --depth-manifest``
  on a seeded manifest of 48×64 depth frames (``data/depth_synthetic.py``)
  at 128×160, batch 2, 256 train proposals and 64 sampled ROIs an image
  (the CPU's budget): 4 steps with snapshots at 2 and 4 and an OKS
  evaluation of 1 held-out batch at 4; the run resumed from step 2 gives
  the losses of steps 3 and 4 within 5e-5 relative; the in-run report
  equals ``evaluate_keypoint_dataset`` on the step-4 checkpoint and the
  held-out stream. That stream is a second loader on the same manifest,
  seed + 999, augmented as the training one is (jitter and flips), as in
  the JAX CLI (``ROADMAP.md`` §C); the LR's epoch is the manifest's length.
- ``--dataset depth`` is accepted now and needs ``--depth-manifest``.
- ``cli.train --preset tiny_test`` on the synthetic stream (2 steps, 3
  classes without a label file), ``cli.evaluate`` on its checkpoint (the
  in-run report again), and ``cli.demo`` writing ``--n`` overlays from it.
"""

import itertools
import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from maskrcnn_tpu_torch.cli import demo as demo_cli  # noqa: E402
from maskrcnn_tpu_torch.cli import evaluate as eval_cli  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.data.depth import DepthKeypointDataset  # noqa: E402
from maskrcnn_tpu_torch.data.depth_synthetic import write_depth  # noqa: E402
from maskrcnn_tpu_torch.eval import evaluator  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from test_torch_coco_cli import _in_run_report, _rows  # noqa: E402

torch.set_num_threads(1)

RESUME_RTOL = 5e-5
N_FRAMES = 8
SEED = 3
BUDGET = ["--set", "proposals.n_train_post_nms=256", "--set",
          "sampler.n_sample=64"]
TRAIN = ["--device", "cpu", "--image-size", "128x160", "--batch-size", "2",
         "--log-every", "1", "--seed", str(SEED)]


class EvalBatches:
    """Wraps ``evaluate_keypoint_dataset``: keeps the batches it scores."""

    def __init__(self):
        self.real, self.batches = evaluator.evaluate_keypoint_dataset, []

    def __call__(self, cfg, model, batches, n_batches, **kwargs):
        taken = list(itertools.islice(batches, n_batches))
        self.batches.extend(taken)
        return self.real(cfg, model, iter(taken), n_batches, **kwargs)


@pytest.fixture(scope="module")
def depth_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("darknet_cli")
    manifest = write_depth(str(root / "frames"), N_FRAMES, (48, 64), seed=4)
    args = [*TRAIN, "--preset", "darknet_keypoint", "--dataset", "depth",
            "--depth-manifest", manifest, "--iterations", "4",
            "--snapshot-every", "2", *BUDGET]
    mp = pytest.MonkeyPatch()
    spy = EvalBatches()
    try:
        mp.setattr(evaluator, "evaluate_keypoint_dataset", spy)
        train_cli.main(["--out", str(root / "a"), "--eval-every", "4",
                        "--eval-batches", "1", *args])
    finally:
        mp.undo()
    (root / "b" / "checkpoints").mkdir(parents=True)
    shutil.copy(root / "a" / "checkpoints" / "step_00000002.pt",
                root / "b" / "checkpoints")
    train_cli.main(["--out", str(root / "b"), "--resume", *args])
    return root, manifest, spy.batches


def _config():
    cfg, _ = train_cli.build_config(
        "darknet_keypoint", None, BUDGET[1::2],
        dict(image_size=(128, 160), batch_size=2, iterations=4))
    return cfg


def test_depth_run_resumes_within_tolerance(depth_runs):
    root = depth_runs[0]
    steps = {d: {r["iteration"]: r for r in _rows(root / d) if "main/loss" in r}
             for d in ("a", "b")}
    assert sorted(steps["a"]) == [1, 2, 3, 4] and sorted(steps["b"]) == [3, 4]
    for it in (3, 4):
        for k, v in steps["a"][it].items():
            if k.endswith("loss"):
                assert np.isfinite(v), (it, k)
                assert abs(steps["b"][it][k] - v) <= RESUME_RTOL * abs(v), (it, k)
    assert all(7.0 < steps["a"][it]["main/mask_loss"] < 9.0 for it in (1, 2))
    args = json.loads((root / "a" / "args.json").read_text())
    assert args["config"]["train"]["epoch_size"] == N_FRAMES
    assert args["config"]["model"]["n_fg_class"] == 1
    assert args["config"]["model"]["backbone"] == "darknet"


def test_in_run_report_equals_direct_evaluation(depth_runs):
    root, manifest, _ = depth_runs
    cfg = _config()
    model = MaskRCNN(cfg, device="cpu")
    model.load_state_dict(torch.load(root / "a" / "checkpoints" /
                                     "step_00000004.pt", weights_only=False)["model"])
    held_out = DepthKeypointDataset(cfg, manifest, seed=SEED + 999)
    report = evaluator.evaluate_keypoint_dataset(cfg, model, iter(held_out), 1)
    assert set(report) == {"ap", "ap50", "ap75"}
    assert report == _in_run_report(root / "a")


def test_in_run_evaluation_reads_augmented_frames_as_jax_does(depth_runs):
    """The held-out loader keeps its default augmentation (``augment=True``:
    jitter and flips), as the JAX CLI's does: its first batch is the
    augmented one, not the plain one."""
    _, manifest, batches = depth_runs
    cfg = _config()
    assert len(batches) == 1
    augmented = next(iter(DepthKeypointDataset(cfg, manifest, seed=SEED + 999)))
    plain = next(iter(DepthKeypointDataset(cfg, manifest, seed=SEED + 999,
                                           augment=False)))
    for name, want in augmented._asdict().items():
        if want is not None:
            np.testing.assert_array_equal(getattr(batches[0], name), want)
    assert not np.array_equal(batches[0].images, plain.images)


def test_dataset_depth_is_accepted_and_needs_its_manifest(tmp_path, capsys):
    """``--dataset depth`` runs (it exited naming ROADMAP A.4 before) and
    asks for the manifest it reads."""
    args = train_cli.parse_args(["--dataset", "depth", "--depth-manifest",
                                 str(tmp_path / "list.txt"), "--device", "cpu"])
    assert args.dataset == "depth"
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args(["--dataset", "depth", "--device", "cpu"])
    assert e.value.code == 2
    assert "--depth-manifest" in capsys.readouterr().err


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_cli")
    train_cli.main(["--out", str(root / "a"), *TRAIN, "--preset", "tiny_test",
                    "--iterations", "2", "--snapshot-every", "2",
                    "--eval-every", "2", "--eval-batches", "1"])
    return root


def test_tiny_test_trains_three_classes_and_evaluates_as_in_run(tiny_run):
    args = json.loads((tiny_run / "a" / "args.json").read_text())
    assert args["config"]["model"]["n_fg_class"] == 3
    report = eval_cli.main([
        "--device", "cpu", "--preset", "tiny_test", "--n-batches", "1",
        "--seed", str(SEED), "--weight",
        str(tiny_run / "a" / "checkpoints" / "step_00000002.pt")])
    assert report == _in_run_report(tiny_run / "a")
    assert "map" in report and "coco/map" in report


def test_demo_writes_its_overlays_from_a_checkpoint(tiny_run, tmp_path):
    paths = demo_cli.main([
        "--device", "cpu", "--preset", "tiny_test", "--n", "3",
        "--score-thresh", "0.0", "--out", str(tmp_path / "demo"),
        "--weight", str(tiny_run / "a" / "checkpoints" / "step_00000002.pt")])
    assert [p.split("/")[-1] for p in paths] == [
        "demo_000.png", "demo_001.png", "demo_002.png"]
    for p in paths:
        img = cv2.imread(p)
        assert img.shape == (128, 160, 3) and img.dtype == np.uint8
