"""The port's CLIs on a COCO-format directory, on the CPU: train → resume →
evaluate → ``--dump-results``, with two buckets.

A directory from the port's seeded writer (PNG images, landscape and
portrait, polygon and RLE masks, a crowd annotation, sparse category ids,
a ``person_keypoints`` file) feeds ``cli.train --dataset coco --buckets
128x160,160x128`` at full width, batch 2, with the budgets of
``tests/test_torch_cli.py``:

- ``fpn_mask`` (the file's 3 categories): 3 steps with snapshots at 2 and
  3 and an evaluation at 3; the run resumed from step 2 gives the same
  losses bit for bit; the steps ran at both bucket shapes;
  ``cli.evaluate --dump-results`` on the step-3 checkpoint gives the in-run
  report and the same detections exactly, and a results file whose every
  ``segm`` decodes (``rle_decode``) to a mask of its image's original size,
  with the file's category ids and boxes inside the original images;
- ``fpn_keypoint`` (``tests/test_torch_keypoint_cli.py``, with this
  file's runner);
- options that must come with others (``--coco-root``, well-formed
  ``--buckets``, ``--dataset coco`` for ``--dump-results``) exit naming
  what is missing.
"""

import json
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from maskrcnn_tpu_torch.cli import evaluate as eval_cli  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.data.coco import rle_decode  # noqa: E402
from maskrcnn_tpu_torch.data.coco_synthetic import CATEGORIES, write_coco  # noqa: E402
from maskrcnn_tpu_torch.eval import evaluator  # noqa: E402
from maskrcnn_tpu_torch.train import step as step_mod  # noqa: E402
from test_torch_cli import PredictSpy  # noqa: E402

torch.set_num_threads(1)

SIZES = [(96, 128), (128, 96), (100, 120), (120, 90), (96, 120), (120, 100)]
BUCKETS = "128x160,160x128"
SETS = [a for kv in ("proposals.n_train_pre_nms=1000",
                     "proposals.n_train_post_nms=256",
                     "proposals.n_test_pre_nms=1000",
                     "proposals.n_test_post_nms=100", "sampler.n_sample=64",
                     "eval.max_detections=16", "train.batch_size=2")
        for a in ("--set", kv)]


def _rows(out):
    with open(out / "log.jsonl") as f:
        return [json.loads(line) for line in f]


def _in_run_report(out):
    val = [r for r in _rows(out) if any(k.startswith("validation/") for k in r)]
    assert len(val) == 1
    return {k[len("validation/main/"):]: v for k, v in val[0].items()
            if k.startswith("validation/main/")}


class StepShapes:
    """Records the image size of every train step the CLI builds."""

    def __init__(self):
        self.sizes, self.make = [], step_mod.make_train_step

    def __call__(self, cfg, image_size=None):
        self.sizes.append(tuple(image_size))
        return self.make(cfg, image_size)


def _run(root, coco_root, preset, iterations, snapshot, extra=()):
    data = ["--dataset", "coco", "--coco-root", coco_root, "--coco-split", "val",
            "--buckets", BUCKETS]
    mp = pytest.MonkeyPatch()
    spies, out = {}, {}
    try:
        for name in ("a", "b", "evaluate"):
            if name == "b" and snapshot is None:
                continue
            spies[name] = PredictSpy()
            shapes = StepShapes()
            mp.setattr(evaluator, "make_predict_fn", spies[name])
            mp.setattr(step_mod, "make_train_step", shapes)
            common = ["--device", "cpu", "--preset", preset, *data, *SETS]
            evals = iterations if name == "a" else 0  # the resumed run: none
            train = [*common, "--iterations", str(iterations), "--log-every", "1",
                     "--eval-every", str(evals), "--eval-batches", "2",
                     "--eval-split", "val", "--snapshot-every",
                     str(snapshot or iterations), *extra]
            if name == "a":
                train_cli.main(["--out", str(root / "a"), *train])
            elif name == "b":
                (root / "b" / "checkpoints").mkdir(parents=True)
                shutil.copy(root / "a" / "checkpoints" / f"step_{snapshot:08d}.pt",
                            root / "b" / "checkpoints")
                train_cli.main(["--out", str(root / "b"), "--resume", *train])
            else:
                out["report"] = eval_cli.main([
                    *common, "--n-batches", "2", *extra, "--weight",
                    str(root / "a" / "checkpoints" / f"step_{iterations:08d}.pt"),
                    "--dump-results", str(root / "results.json")])
            out[f"shapes_{name}"] = shapes.sizes
            mp.undo()
    finally:
        mp.undo()
    out["spies"] = spies
    out["results"] = json.loads((root / "results.json").read_text())
    return out


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_cli_data")
    write_coco(str(root), "val", SIZES, seed=5)
    return str(root)


@pytest.fixture(scope="module")
def mask_runs(tmp_path_factory, coco_root):
    root = tmp_path_factory.mktemp("coco_cli_mask")
    out = _run(root, coco_root, "fpn_mask", 3, 2,
               extra=["--set", "model.n_fg_class=3"])
    return root, out


def test_coco_run_trains_at_both_buckets_and_resumes_bit_exact(mask_runs):
    root, out = mask_runs
    assert set(out["shapes_a"]) == {(128, 160), (160, 128)}
    a = {r["iteration"]: r for r in _rows(root / "a") if "main/loss" in r}
    b = {r["iteration"]: r for r in _rows(root / "b") if "main/loss" in r}
    assert sorted(a) == [1, 2, 3] and sorted(b) == [3]
    for it in (3,):
        for k, v in a[it].items():
            if k.startswith("main/") and k not in ("main/prefetch_starved",
                                                  "main/padding_waste"):
                assert b[it][k] == v, (it, k)
    assert all(0.0 < r["main/padding_waste"] < 0.5 for r in a.values())
    args = json.loads((root / "a" / "args.json").read_text())
    assert args["config"]["train"]["epoch_size"] == len(SIZES)
    assert args["config"]["train"]["image_buckets"] == [[128, 160], [160, 128]]


def test_coco_evaluate_reproduces_the_in_run_report(mask_runs):
    root, out = mask_runs
    report = out["report"]
    assert report == _in_run_report(root / "a")
    # the file's category names label the per-class entries
    assert {f"ap/{n}" for n in CATEGORIES.values()} >= {
        k for k in report if k.startswith("ap/")}
    # the evaluation's two batches come first, then the export's
    got, want = out["spies"]["evaluate"].dets[:2], out["spies"]["a"].dets
    assert len(want) == 2 and len(out["spies"]["evaluate"].dets) == 2 + 3
    assert int(want[0]["valid"].sum()) > 0
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_coco_dump_is_in_original_coordinates_and_ids(mask_runs, coco_root):
    _, out = mask_runs
    with open(f"{coco_root}/annotations/instances_val.json") as f:
        images = {im["id"]: im for im in json.load(f)["images"]}
    results = out["results"]
    assert len(results) > len(SIZES) and {e["image_id"] for e in results} == set(images)
    for e in results:
        im = images[e["image_id"]]
        assert e["category_id"] in CATEGORIES
        mask = rle_decode(e["segmentation"])
        assert mask.shape == (im["height"], im["width"])
        x, y, w, h = e["bbox"]
        assert x >= -0.01 and y >= -0.01
        assert x + w <= im["width"] + 0.5 and y + h <= im["height"] + 0.5
        if mask.any():  # a mask lies inside its box
            ys, xs = np.nonzero(mask)
            assert xs.min() >= np.floor(x) - 1 and ys.min() >= np.floor(y) - 1
            assert xs.max() <= np.ceil(x + w) and ys.max() <= np.ceil(y + h)


@pytest.mark.parametrize("cli, argv, missing", [
    ("train", ["--dataset", "coco"], "--coco-root"),
    ("train", ["--buckets", "800x1024;1024x800"], "--buckets"),
    ("evaluate", ["--dataset", "coco"], "--coco-root"),
    ("evaluate", ["--dump-results", "out.json"], "--dataset coco"),
])
def test_coco_options_name_what_they_need(cli, argv, missing, capsys):
    main = train_cli.parse_args if cli == "train" else eval_cli.main
    with pytest.raises(SystemExit) as e:
        main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert missing in capsys.readouterr().err
