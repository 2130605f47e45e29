"""The train CLI under ``--data-parallel``: two gloo processes on the CPU
through ``python -m torch.distributed.run --standalone --nproc_per_node 2``.

``tiny_test`` at 128×160, global batch 2 (one image a rank), 4 steps with
snapshots at 2 and 4 and an in-run evaluation at 4, warm-started
(``--weight``) from a checkpoint whose RPN shared conv is zeroed, so the two
ranks and the 1-process run (``cli.train`` in this process, same flags
without ``--data-parallel``) propose and sample the same ROIs
(``tests/test_torch_parallel_step.py``). Checked:

- the 2-rank log equals the 1-process log, step by step: the ROI counts
  equal, each loss term within 1e-4 relative (measured 2.7e-7 over the 4
  steps: the two runs' float32 sums differ, and Darknet's BatchNorms pass
  the difference on), one validation row, written once;
- rank 0 alone writes ``args.json``, the log and the checkpoints; its step-4
  parameters lie within 1e-4 of the 1-process run's largest weight change
  (measured 3.1e-7);
- ``--resume`` from the 2-rank run's step-2 checkpoint gives its steps 3
  and 4 again, every rank restoring the same state (within 1e-6; measured
  equal);
- from COCO data, ``train.epoch_size`` is the whole split's image count
  (each rank reads half of it), and a ``{"stop": true}`` command read by
  rank 0 stops both ranks at the first logging boundary.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.data.coco_synthetic import write_coco  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
PARAM_SHARE = 1e-4
RESUME_RTOL = 1e-6
COMMON = ["--preset", "tiny_test", "--device", "cpu", "--iterations", "4",
          "--snapshot-every", "2", "--log-every", "1", "--eval-every", "4",
          "--eval-batches", "1"]
COCO_SIZES = [(96, 128), (128, 96), (100, 120), (120, 90), (90, 100)]


def torchrun(args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "maskrcnn_tpu_torch.cli.train",
         "--data-parallel", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _rows(out: Path) -> dict:
    rows = [json.loads(line) for line in open(out / "log.jsonl")]
    return {r["iteration"]: r for r in rows if "main/loss" in r}


def _losses(row) -> dict:
    return {k: v for k, v in row.items() if k.endswith("loss")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    cfg = cfg_lib.tiny_test()
    model = MaskRCNN(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.rpn_head.conv.weight.zero_()
        model.rpn_head.conv.bias.zero_()
    quiet = save_checkpoint(str(root / "quiet"), create_train_state(cfg, model))
    common = [*COMMON, "--weight", quiet]
    train_cli.main(["--out", str(root / "single"), *common])
    dp_out = torchrun(["--out", str(root / "dp"), *common], root)
    (root / "resumed" / "checkpoints").mkdir(parents=True)
    shutil.copy(root / "dp" / "checkpoints" / "step_00000002.pt",
                root / "resumed" / "checkpoints")
    torchrun(["--out", str(root / "resumed"), "--resume", *common], root)
    return root, dp_out


def test_dp_log_matches_one_process(runs):
    root, _ = runs
    single, dp = _rows(root / "single"), _rows(root / "dp")
    assert sorted(dp) == sorted(single) == [1, 2, 3, 4]
    for it in dp:
        assert dp[it]["main/n_valid_rois"] == single[it]["main/n_valid_rois"]
        assert dp[it]["main/n_pos_rois"] == single[it]["main/n_pos_rois"]
        for k, v in _losses(single[it]).items():
            assert abs(dp[it][k] - v) <= LOSS_RTOL * abs(v), (it, k, dp[it][k], v)
    lines = [json.loads(line) for line in open(root / "dp" / "log.jsonl")]
    assert len(lines) == 5  # four step rows and one validation row, once
    assert sum("validation/main/map" in r for r in lines) == 1


def test_rank_zero_writes_the_run_once(runs):
    root, out = runs
    assert sorted(os.listdir(root / "dp" / "checkpoints")) == [
        "step_00000002.pt", "step_00000004.pt"]
    assert out.count("saved ") == 2 and out.count("[eval @4]") == 1
    assert out.count("[dp] rank 0 of 2") == out.count("[dp] rank 1 of 2") == 1
    args = json.loads((root / "dp" / "args.json").read_text())
    assert args["cli"]["data_parallel"] and args["config"]["train"]["batch_size"] == 2


def test_dp_checkpoint_matches_one_process(runs):
    root, _ = runs
    start = torch.load(root / "quiet" / "step_00000000.pt", weights_only=False)["model"]
    got = torch.load(root / "dp" / "checkpoints" / "step_00000004.pt",
                     weights_only=False)
    want = torch.load(root / "single" / "checkpoints" / "step_00000004.pt",
                      weights_only=False)
    assert got["step"] == want["step"] == 4
    moved = max(float((want["model"][k] - start[k]).abs().max()) for k in start)
    assert moved > 0
    for k, v in want["model"].items():
        assert float((got["model"][k] - v).abs().max()) <= PARAM_SHARE * moved, k


def test_dp_resume_repeats_the_run(runs):
    root, _ = runs
    dp, resumed = _rows(root / "dp"), _rows(root / "resumed")
    assert sorted(resumed) == [3, 4]
    for it in (3, 4):
        for k, v in _losses(dp[it]).items():
            assert abs(resumed[it][k] - v) <= RESUME_RTOL * abs(v), (it, k)


def test_dp_coco_epoch_is_the_whole_split_and_stop_reaches_every_rank(tmp_path):
    write_coco(str(tmp_path / "coco"), "val", COCO_SIZES, seed=2)
    out = tmp_path / "run"
    out.mkdir()
    (out / "commands.json").write_text(json.dumps({"stop": True}))
    stdout = torchrun(["--out", str(out), "--preset", "tiny_test", "--device",
                       "cpu", "--dataset", "coco", "--coco-root",
                       str(tmp_path / "coco"), "--coco-split", "val",
                       "--iterations", "5", "--log-every", "1"], tmp_path)
    args = json.loads((out / "args.json").read_text())
    assert args["config"]["train"]["epoch_size"] == len(COCO_SIZES)
    assert stdout.count("[commands] stop at 1") == 2
    assert os.listdir(out / "checkpoints") == ["step_00000001.pt"]
    assert (out / "commands.json.done").exists()
    assert sorted(_rows(out)) == [1]


def test_data_parallel_without_torchrun_names_the_command(capsys, monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args(["--data-parallel", "--device", "cpu"])
    assert e.value.code == 2
    assert "torchrun --nproc_per_node N" in capsys.readouterr().err
