"""The port's CLIs with the keypoint preset on a COCO-format directory, on
the CPU: ``cli.train --preset fpn_keypoint --dataset coco --buckets
128x160,160x128`` (one class, no label file) for 2 steps and an
evaluation, then ``cli.evaluate --dump-results`` on its checkpoint: the
in-run OKS report, and a keypoint results file with 17 × 3 numbers a
detection under the file's person category. The runner and budgets are
``tests/test_torch_coco_cli.py``'s.
"""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from maskrcnn_tpu_torch.data.coco_synthetic import write_coco  # noqa: E402
from test_torch_coco_cli import _in_run_report, _rows, _run  # noqa: E402

torch.set_num_threads(1)

SIZES = [(96, 128), (128, 96), (100, 120), (120, 90)]


@pytest.fixture(scope="module")
def keypoint_runs(tmp_path_factory):
    data = tmp_path_factory.mktemp("kp_cli_data")
    write_coco(str(data), "val", SIZES, seed=6)
    root = tmp_path_factory.mktemp("kp_cli")
    return root, _run(root, str(data), "fpn_keypoint", 2, None)


def test_keypoint_run_reports_oks_and_evaluate_reproduces_it(keypoint_runs):
    root, out = keypoint_runs
    assert out["report"] == _in_run_report(root / "a")
    assert set(out["report"]) == {"ap", "ap50", "ap75"}
    args = json.loads((root / "a" / "args.json").read_text())
    assert args["config"]["model"]["n_fg_class"] == 1
    rows = [r for r in _rows(root / "a") if "main/mask_loss" in r]
    assert len(rows) == 2 and all(7.5 < r["main/mask_loss"] < 8.6 for r in rows)
    # the evaluation's two batches come first, then the export's
    got, want = out["spies"]["evaluate"].dets[:2], out["spies"]["a"].dets
    assert len(want) == 2 and len(out["spies"]["evaluate"].dets) == 2 + 2
    assert "heatmaps" in want[0]
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_keypoint_dump_has_17_keypoints_a_detection(keypoint_runs):
    _, out = keypoint_runs
    results = out["results"]
    assert len(results) >= len(SIZES)
    for e in results:
        assert e["category_id"] == 1 and len(e["keypoints"]) == 17 * 3
        assert all(0.0 <= v <= 1.0 for v in e["keypoints"][2::3])


def test_keypoint_preset_keeps_its_class_without_a_label_file():
    """The COCO label file sets 80 classes for the mask presets only: the
    keypoint head keeps its preset's one class, as the JAX CLI does."""
    from maskrcnn_tpu_torch.cli import train as train_cli

    cfg, names = train_cli.build_config("fpn_keypoint", None, [])
    assert cfg.model.n_fg_class == 1 and names is None
    cfg, names = train_cli.build_config(
        "fpn_mask", None, ["model.head=fpn_keypoint", "model.n_fg_class=1"])
    assert cfg.model.n_fg_class == 1 and names is None
    cfg, names = train_cli.build_config("fpn_mask", None, [])
    assert cfg.model.n_fg_class == 80 and len(names) == 80


def test_preset_help_names_both_heads(capsys):
    from maskrcnn_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit):
        train_cli.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "mask head (fpn_mask)" in text and "keypoint head (fpn_keypoint)" in text
