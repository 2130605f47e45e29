"""The viewer, the drawing code and the two offline tools of the port
against the JAX package's, on the CPU.

- ``utils/vis.py``: ``vis_keypoints`` (the 17- and the 20-keypoint
  skeleton) and ``vis_detections`` give JAX's uint8 arrays exactly.
- ``cli/viewer.py``: ``Viewer.infer_frame`` on a generated depth frame
  gives JAX's keypoints, boxes and scores from the same weights (JAX's
  viewer's own random init, carried over by the weight bridge, with the
  class-score layer scaled so that detections pass the ``visualize``
  preset's 0.7), boxes and scores within 1e-3 of max(1, max |JAX|),
  keypoints within 1e-3 of the box size; ``run_image`` writes
  ``<stem>_keypoints.png`` and, with ``--benchmark``, prints the EMA frame
  rate; camera mode without ``pyrealsense2`` exits naming it.
- ``tools/score_dump.py``: the scores of JAX's tool on the same results
  file and annotations, to 1e-12.
- ``tools/bench_loader.py``: runs with 1 and 2 workers on a tiny generated
  directory and prints a rate for each.
"""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from maskrcnn_tpu.utils import vis as jax_vis  # noqa: E402
from maskrcnn_tpu_torch.cli import viewer as viewer_cli  # noqa: E402
from maskrcnn_tpu_torch.data.coco import rle_decode  # noqa: E402
from maskrcnn_tpu_torch.data.coco_synthetic import write_coco  # noqa: E402
from maskrcnn_tpu_torch.data.depth_synthetic import write_depth  # noqa: E402
from maskrcnn_tpu_torch.eval.export import rle_encode  # noqa: E402
from maskrcnn_tpu_torch.tools import bench_loader, score_dump  # noqa: E402
from maskrcnn_tpu_torch.utils import vis  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-3


def _jax_module(rel):
    """A script of the JAX package's ``cli/`` or ``tools/``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + rel.replace("/", "_")[:-3], ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [17, 20])
def test_vis_keypoints_draws_as_jax(k):
    rng = np.random.default_rng(k)
    img = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    kps = np.stack([rng.uniform(0, 96, k), rng.uniform(0, 128, k),
                    rng.uniform(0, 1, k)], axis=1).astype(np.float32)
    got = vis.vis_keypoints(img, kps, thresh=0.3)
    want = jax_vis.vis_keypoints(img, kps, thresh=0.3)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)
    names = vis.DEPTH_KEYPOINT_NAMES if k == 20 else vis.COCO_KEYPOINT_NAMES
    assert vis.kp_connections(names) == jax_vis.kp_connections(names)


def test_vis_detections_draws_as_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    boxes = np.array([[10, 12, 60, 90], [30, 5, 80, 50], [0, 0, 20, 20]], np.float32)
    labels = np.array([0, 2, 1], np.int32)
    scores = np.array([0.9, 0.6, 0.3], np.float32)
    masks = rng.uniform(size=(3, 96, 128)) < 0.3
    for m in (masks, None):
        got = vis.vis_detections(img, boxes, labels, scores, m,
                                 label_names=["a", "b", "c"])
        want = jax_vis.vis_detections(img, boxes, labels, scores, m,
                                      label_names=["a", "b", "c"])
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vis._colormap(7), jax_vis._colormap(7))


@pytest.fixture(scope="module")
def viewers(tmp_path_factory):
    """JAX's viewer and the port's, on the same (JAX-initialised) weights,
    with the class-score layer scaled by 32 and the foreground's bias raised
    by 2 in both."""
    frames = tmp_path_factory.mktemp("viewer")
    write_depth(str(frames), 1, (120, 160), seed=11)
    args = SimpleNamespace(weight=None, file=None, image=None, n_keypoints=20,
                           thresh=0.2, no_display=True, benchmark=0,
                           device="cpu")
    jv = _jax_module("cli/viewer.py").Viewer(args)
    variables = jax.tree.map(lambda x: np.array(x), jv.variables)
    score = variables["params"]["head"]["box"]["score"]
    score["kernel"] *= 32.0
    score["bias"][1] += 2.0
    jv.variables = variables
    pv = viewer_cli.Viewer(args)
    load_flax_variables(pv.model, variables)
    return jv, pv, frames / "frame_0000.npz"


def test_viewer_infers_a_frame_as_jax(viewers):
    jv, pv, frame = viewers
    img = viewer_cli.normalize_depth(np.load(frame)["depth"])
    np.testing.assert_array_equal(
        img, _jax_module("cli/viewer.py").normalize_depth(np.load(frame)["depth"]))
    assert pv.cfg.eval.score_thresh == 0.7 and pv.cfg.model.backbone == "darknet"
    kps, boxes, scores = pv.infer_frame(img)
    want_kps, want_boxes, want_scores = jv.infer_frame(img)
    assert len(want_boxes) >= 1
    assert kps.shape == want_kps.shape == (len(want_boxes), 20, 3)
    for got, want in ((boxes, want_boxes), (scores, want_scores)):
        assert np.abs(got - want).max() <= TOL * max(1.0, float(np.abs(want).max()))
    size = (want_boxes[:, 2:] - want_boxes[:, :2]).max(axis=1)
    assert float((np.abs(kps[..., :2] - want_kps[..., :2]).max(axis=(1, 2))
                  / size).max()) <= TOL
    assert np.abs(kps[..., 2] - want_kps[..., 2]).max() <= TOL


def test_viewer_writes_its_image_and_frame_rate(viewers, capsys):
    _, pv, frame = viewers
    pv.args.benchmark = 3
    try:
        out = pv.run_image(str(frame))
    finally:
        pv.args.benchmark = 0
    assert out == str(frame)[:-4] + "_keypoints.png"
    img = cv2.imread(out)
    assert img.shape == (120, 160, 3)
    text = capsys.readouterr().out
    assert "wrote" in text and "fps(EMA) over 3 frames:" in text
    assert pv.fps_ema > 0
    assert viewer_cli.crop_16_9_to_4_3(np.zeros((360, 640))).shape == (360, 480)


def test_camera_mode_without_pyrealsense_exits_naming_it(viewers, monkeypatch):
    _, pv, _ = viewers
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(SystemExit, match="pyrealsense2"):
        pv.run_camera()


def _results(instances, seed):
    """A segm results file: each ground truth's box, shifted by up to 3 pixels, with
    a random score, and a false positive an image."""
    rng = np.random.default_rng(seed)
    info = {im["id"]: im for im in instances["images"]}
    out = []
    for a in instances["annotations"]:
        im = info[a["image_id"]]
        x, y, w, h = (int(v) for v in a["bbox"])
        m = np.zeros((im["height"], im["width"]), bool)
        dy, dx = rng.integers(-3, 4, 2)
        m[max(y + dy, 0):y + dy + h, max(x + dx, 0):x + dx + w] = True
        rle = rle_encode(m)
        out.append({"image_id": a["image_id"], "category_id": a["category_id"],
                    "segmentation": rle, "score": float(rng.uniform(0.3, 1))})
    for im in instances["images"]:
        m = np.zeros((im["height"], im["width"]), bool)
        m[:10, :10] = True
        out.append({"image_id": im["id"],
                    "category_id": instances["categories"][0]["id"],
                    "segmentation": rle_encode(m), "score": 0.5})
    return out


def test_score_dump_scores_as_jax(tmp_path, monkeypatch):
    sizes = [(96, 128), (128, 96), (100, 120), (120, 90)]
    write_coco(str(tmp_path), "val", sizes, seed=2)
    ann = tmp_path / "annotations" / "instances_val.json"
    instances = json.loads(ann.read_text())
    results = _results(instances, seed=3)
    assert rle_decode(results[0]["segmentation"]).shape == (96, 128)
    (tmp_path / "results.json").write_text(json.dumps(results))
    got = score_dump.main(["--ann", str(ann), "--results",
                           str(tmp_path / "results.json"),
                           "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", [
        "score_dump.py", "--ann", str(ann), "--results",
        str(tmp_path / "results.json"), "--out", str(tmp_path / "jax.json")])
    _jax_module("tools/score_dump.py").main()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()).keys() == want.keys()
    assert 0.0 < want["AP"] < 1.0 and 0.0 < want["AP75"] < want["AP50"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-12, (k, got[k], v)


def test_bench_loader_prints_a_rate_per_worker_count(tmp_path, capsys):
    lines = bench_loader.main([
        "--images", "6", "--size", "96x128", "--objects", "2", "--batches", "2",
        "--batch-size", "2", "--image-size", "128x160", "--workers", "1,2",
        "--root", str(tmp_path)])
    assert [ln["n_workers"] for ln in lines] == [1, 2]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == lines
    for ln in lines:
        assert ln["metric"] == "host_loader_images_per_sec" and ln["value"] > 0
        assert ln["bucket"] == "128x160" and ln["batch_ms"] > 0
    assert (tmp_path / "annotations" / "instances_train.json").exists()
