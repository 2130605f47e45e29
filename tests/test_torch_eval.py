"""The port's evaluation path against the JAX package's, on the CPU.

- The copied scorers (VOC mask AP, COCO mask AP) give JAX's numbers on
  seeded random masks, empty per-image arrays included.
- ``paste_masks`` and ``crop_to_full_mask`` (torch, no cv2) against JAX's
  (``cv2.resize``): boxes across the canvas edge, under 28 px, of sub-pixel
  and zero extent, float and uint8 crops. Against cv2's reference arithmetic
  (``cv2.setUseOptimized(False)``) no pixel differs. cv2's optimized path
  rounds its two-row interpolation otherwise (within ~1.5e-6 of the exact
  value), so a pixel may flip where the value lies within a rounding of
  0.5: each differing pixel must lie within 1e-5 of 0.5, at most 1 in 10⁵
  pasted pixels (seen: at most 7 in 1.07e6, on uint8 noise).
- ``evaluate_dataset`` on the same fixed detections (``make_predict_fn``
  replaced in both evaluators): jittered GT boxes with GT crops as mask
  probabilities, plus false positives. Every report field within 1e-6, and
  ``map > 0``.
- ``evaluate_dataset`` end to end: one JAX random init carried into the
  port, the class-score layer scaled by 8 in both (``spread_class_scores``:
  otherwise no detection clears the threshold), ``fpn_mask`` at 128×160
  with 3 classes, 256/32 proposals and 16 detections, on the images of two
  ``SyntheticDetectionData`` batches labelled with every other detection
  of JAX's own predict (random weights find none of the objects, and every
  score would be 0.0). Every field within 1e-3: the detections match within
  1e-4 (``tests/test_torch_predict.py``), and a pasted pixel whose mask
  probability lies within that of 0.5 may flip.
- ``eval.mask_levels="refined"``: the port's predict against JAX's, as
  ``tests/test_torch_predict.py`` holds the default ``"pass1"``.
"""

from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.eval import coco_eval as jax_coco  # noqa: E402
from maskrcnn_tpu.eval import detection_eval as jax_voc  # noqa: E402
from maskrcnn_tpu.eval import evaluator as jax_evaluator  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.eval.postprocess import paste_masks as jax_paste_masks  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.eval import coco_eval, detection_eval, evaluator  # noqa: E402
from maskrcnn_tpu_torch.eval.postprocess import paste_masks  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)

FLIP_BAND = 1e-5  # a differing pixel's value lies within this of 0.5
FLIP_SHARE = 1e-5  # differing pixels per pasted pixel, at most
REPORT_TOL = 1e-6  # same detections: the same arithmetic on the same masks
E2E_TOL = 1e-3  # the same weights through two frameworks' predicts
HW = (128, 160)
B = 2


# ---------------------------------------------------------------- scorers

def _random_eval_inputs(seed: int, case: str):
    rng = np.random.RandomState(seed)
    h, w, n_class = 24, 32, 4
    preds, plabels, pscores, gts, glabels = [], [], [], [], []
    for i in range(6):
        n_gt = 0 if case == "empty_gt" and i % 2 else rng.randint(0, 5)
        n_pred = 0 if case == "empty_pred" and i % 2 else rng.randint(0, 9)
        gt = rng.rand(n_gt, h, w) < 0.3
        # predictions: noisy copies of GTs and random blobs
        pred = rng.rand(n_pred, h, w) < 0.3
        for k in range(min(n_pred, n_gt)):
            pred[k] = gt[k] ^ (rng.rand(h, w) < rng.uniform(0, 0.3))
        gl = rng.randint(0, n_class, n_gt)
        pl = np.concatenate([gl[:n_pred], rng.randint(0, n_class, max(n_pred - n_gt, 0))])
        preds.append(pred)
        plabels.append(pl.astype(np.int32))
        pscores.append(rng.rand(n_pred).astype(np.float32))
        gts.append(gt)
        glabels.append(gl.astype(np.int32))
    if case == "all_empty":
        preds = [np.zeros((0, h, w), bool)] * 3
        plabels = [np.zeros(0, np.int32)] * 3
        pscores = [np.zeros(0, np.float32)] * 3
        gts, glabels = preds, plabels
    return preds, plabels, pscores, gts, glabels, n_class


def _equal_with_nans(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal_with_nans(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("case", ["random", "empty_pred", "empty_gt", "all_empty"])
@pytest.mark.parametrize("scorer", ["voc", "voc_coco_style", "coco"])
def test_copied_scorers_match_jax(scorer, case):
    args = _random_eval_inputs(3, case)
    if scorer == "voc":
        got = detection_eval.eval_instance_segmentation_voc(*args)
        want = jax_voc.eval_instance_segmentation_voc(*args)
    elif scorer == "voc_coco_style":
        got = detection_eval.eval_instance_segmentation_coco_style(*args)
        want = jax_voc.eval_instance_segmentation_coco_style(*args)
    else:
        got = coco_eval.evaluate_coco(*args)
        want = jax_coco.evaluate_coco(*args)
    _equal_with_nans(got, want)
    if case == "random":
        assert float(got["map"] if "map" in got else got["AP"]) > 0


# ---------------------------------------------------------------- pasting

def _boxes(rng, kind: str, d: int, hw):
    h, w = hw
    if kind == "edge":  # across every side of the canvas
        y0, x0 = rng.uniform(-60, h - 10, d), rng.uniform(-60, w - 10, d)
        bh, bw = rng.uniform(20, 160, d), rng.uniform(20, 160, d)
    elif kind == "small":  # under 28 px, upsampled by less than one
        y0, x0 = rng.uniform(0, h - 30, d), rng.uniform(0, w - 30, d)
        bh, bw = rng.uniform(1.5, 27.5, d), rng.uniform(1.5, 27.5, d)
    elif kind == "subpixel":  # sub-pixel extents, some exactly zero
        y0, x0 = rng.uniform(0, h - 2, d), rng.uniform(0, w - 2, d)
        bh, bw = rng.uniform(0, 0.9, d), rng.uniform(0, 0.9, d)
        # integer starts and no size: zero extent
        y0[::4], bh[::4] = np.floor(y0[::4]), 0.0
        x0[1::4], bw[1::4] = np.floor(x0[1::4]), 0.0
    else:  # large: down- and upsampled
        y0, x0 = rng.uniform(-20, h / 2, d), rng.uniform(-20, w / 2, d)
        bh, bw = rng.uniform(28, 400, d), rng.uniform(28, 400, d)
    return np.stack([y0, x0, y0 + bh, x0 + bw], 1).astype(np.float32)


def _flips(got, want, near):
    """Differing pixels, and whether each lies within FLIP_BAND of 0.5."""
    diff = got != want
    return int(diff.sum()), bool((~diff | near).all())


def _content(rng, content: str, d: int):
    """Mask contents: a mask head's (sigmoid of smooth logits, 28²), the
    data's (binary uint8 crops, 112²), or uniform noise of either type."""
    if content == "sigmoid28":
        logits = torch.from_numpy(rng.randn(d, 1, 7, 7).astype(np.float32) * 4)
        return torch.sigmoid(torch.nn.functional.interpolate(
            logits, size=(28, 28), mode="bilinear", align_corners=False))[:, 0].numpy()
    if content == "binary_uint8_112":
        yy, xx = np.mgrid[:112, :112] / 112.0
        c = rng.uniform(0.2, 0.8, (d, 2, 1, 1))
        r = rng.uniform(0.2, 0.5, (d, 1, 1))
        inside = (yy - c[:, 0]) ** 2 + (xx - c[:, 1]) ** 2 <= r ** 2
        inside[::3] = True  # rectangles fill their crop
        return np.where(inside, 255, 0).astype(np.uint8)
    if content == "noise28":
        return rng.rand(d, 28, 28).astype(np.float32)
    return (rng.rand(d, 112, 112) * 255 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("kind", ["edge", "small", "subpixel", "large"])
@pytest.mark.parametrize("content", ["sigmoid28", "binary_uint8_112", "noise28",
                                     "noise_uint8_112"])
def test_paste_matches_cv2(kind, content):
    """uint8 contents go through ``crop_to_full_mask``, float ones through
    ``paste_masks``. Exact against cv2's reference arithmetic; against its
    optimized path, differing pixels lie within ``FLIP_BAND`` of 0.5 and
    at most ``FLIP_SHARE`` of the pasted pixels differ. Seen: 1 pixel in
    1.07e6 (large boxes, binary crops) and none in the other mask-like
    cases; uint8 noise, whose values crowd 0.5, 5 and 7 in 1.07e6."""
    rng = np.random.RandomState(["edge", "small", "subpixel", "large"].index(kind))
    hw = (150, 210)
    d = 40
    boxes = _boxes(rng, kind, d, hw)
    valid = rng.rand(d) < 0.85
    masks = _content(rng, content, d)
    t = [torch.from_numpy(x) for x in (boxes, masks, valid)]
    if masks.dtype == np.uint8:
        jax_fn = lambda: jax_evaluator.crop_to_full_mask(masks, boxes, valid, hw)  # noqa: E731
        got = evaluator.crop_to_full_mask(t[1], t[0], t[2], hw).numpy()
        probs = t[1].float() / 255.0
    else:
        jax_fn = lambda: jax_paste_masks(boxes, masks, valid, hw)  # noqa: E731
        got = paste_masks(*t, hw).numpy()
        probs = t[1]
    want = jax_fn()
    cv2.setUseOptimized(False)
    try:
        exact = jax_fn()
    finally:
        cv2.setUseOptimized(True)
    lo, hi = (paste_masks(t[0], probs, t[2], hw, threshold=0.5 + s * FLIP_BAND).numpy()
              for s in (-1, 1))
    assert got.dtype == bool and got.shape == want.shape == (valid.sum(), *hw)
    assert got.any()
    np.testing.assert_array_equal(got, exact)
    n_diff, in_band = _flips(got, want, lo & ~hi)
    assert in_band
    assert n_diff <= FLIP_SHARE * got.size, n_diff
    if kind == "subpixel":  # zero-extent boxes paste empty canvases
        ext = np.ceil(boxes[valid, 2:]) - np.floor(boxes[valid, :2])
        assert not got[(ext <= 0).any(axis=1)].any()
        assert (ext <= 0).any(axis=1).sum() > 3


def test_paste_keeps_the_device_and_handles_no_detections():
    out = paste_masks(torch.zeros(3, 4), torch.zeros(3, 28, 28),
                      torch.zeros(3, dtype=torch.bool), (40, 50))
    assert out.shape == (0, 40, 50) and out.dtype == torch.bool
    assert jax_paste_masks(np.zeros((3, 4), np.float32),
                           np.zeros((3, 28, 28), np.float32),
                           np.zeros(3, bool), (40, 50)).shape == (0, 40, 50)


# ------------------------------------------------- evaluate_dataset, fixed

class _Det(NamedTuple):
    boxes: np.ndarray
    scores: np.ndarray
    labels: np.ndarray
    valid: np.ndarray
    masks: np.ndarray
    heatmaps: None = None


def _fixed_detections(batch, seed: int, d: int = 12) -> _Det:
    """Per image: each GT with a jittered box and its crop (112², as float
    probabilities) as the mask, then false positives, in ``d`` slots."""
    rng = np.random.RandomState(seed)
    b, g = batch.gt_valid.shape
    s = batch.gt_masks.shape[-1]
    boxes = np.zeros((b, d, 4), np.float32)
    scores = np.zeros((b, d), np.float32)
    labels = np.zeros((b, d), np.int32)
    valid = np.zeros((b, d), bool)
    masks = np.zeros((b, d, s, s), np.float32)
    for i in range(b):
        k = 0
        for j in np.where(batch.gt_valid[i])[0][: d - 3]:
            box = batch.gt_boxes[i, j]
            size = np.tile(box[2:] - box[:2], 2)
            boxes[i, k] = box + rng.uniform(-0.06, 0.06, 4) * size
            masks[i, k] = batch.gt_masks[i, j] / 255.0
            # a few take the wrong class
            labels[i, k] = batch.gt_labels[i, j] if rng.rand() < 0.8 else (
                (batch.gt_labels[i, j] + 1) % 3)
            scores[i, k] = rng.uniform(0.3, 1.0)
            valid[i, k] = True
            k += 1
        for _ in range(3):  # false positives
            y0, x0 = rng.uniform(0, HW[0] - 30), rng.uniform(0, HW[1] - 30)
            boxes[i, k] = [y0, x0, y0 + rng.uniform(8, 60), x0 + rng.uniform(8, 60)]
            masks[i, k] = rng.rand(s, s)
            labels[i, k] = rng.randint(0, 3)
            scores[i, k] = rng.uniform(0.05, 0.9)
            valid[i, k] = True
            k += 1
    return _Det(boxes, scores, labels, valid, masks)


def _cfg(lib, **evals):
    return lib._rep(
        lib.fpn_mask(), model=dict(n_fg_class=3),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
        eval=dict(max_detections=16, **evals),
        train=dict(batch_size=B, image_size=HW))


def test_evaluate_dataset_on_fixed_detections_matches_jax(monkeypatch):
    data = SyntheticDetectionData(_cfg(tcfg), seed=4)
    dets = [_fixed_detections(data.batch(i), seed=i) for i in range(3)]

    def port_factory(cfg, model, image_size=None):
        it = iter(dets)

        def predict(images, img_hw, scale):
            return _Det(*(None if v is None else torch.from_numpy(v)
                          for v in next(it)))

        return predict

    def jax_factory(cfg, model, image_size=None):
        it = iter(dets)
        return lambda variables, images, img_hw, scale: next(it)

    monkeypatch.setattr(evaluator, "make_predict_fn", port_factory)
    monkeypatch.setattr(jax_evaluator, "make_predict_fn", jax_factory)
    names = ["circle", "square", "tri"]
    got = evaluator.evaluate_dataset(_cfg(tcfg), None, iter(data), 3, names)
    want = jax_evaluator.evaluate_dataset(
        _cfg(jcfg), None, None, iter(JaxData(_cfg(jcfg), seed=4)), 3, names)
    assert got.keys() == want.keys()
    assert {"map", "coco/map", "coco/ar100", "ap/circle"} <= set(got)
    for k in want:
        assert abs(got[k] - want[k]) <= REPORT_TOL, (k, got[k], want[k])
    assert got["map"] > 0.2 and got["coco/map"] > 0


# --------------------------------------------------- end to end, and refined

def _spread(variables, scale: float = 8.0):
    """``spread_class_scores`` on the flax tree: scale the class-score
    layer's kernel."""
    box = variables["params"]["head"]["box"]
    box["score"]["kernel"] = box["score"]["kernel"] * scale
    return variables


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMaskRCNN(_cfg(jcfg))
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy, method=JaxMaskRCNN.init_forward))
    variables = jax.tree.map(np.array, jax.device_get(init(jax.random.key(1))))
    variables = _spread(jax.tree.map(np.array, variables))
    model = MaskRCNN(_cfg(tcfg), device="cpu", seed=0)
    load_flax_variables(model, variables)
    return jmodel, variables, model


class _Batch(NamedTuple):
    images: np.ndarray
    img_hw: np.ndarray
    scale: np.ndarray
    gt_boxes: np.ndarray
    gt_labels: np.ndarray
    gt_valid: np.ndarray
    gt_masks: np.ndarray


def _batches_labelled_by(det, batch) -> _Batch:
    """The batch's images with every other valid detection of ``det`` as its
    GT (box, label, the mask thresholded into a uint8 crop): random weights
    find none of the synthetic objects, so the scores would all be 0.0."""
    keep = det.valid & (np.cumsum(det.valid, axis=1) % 2 == 1)
    return _Batch(batch.images, batch.img_hw, batch.scale, det.boxes,
                  det.labels, keep,
                  np.where(det.masks >= 0.5, 255, 0).astype(np.uint8))


def test_evaluate_dataset_end_to_end_matches_jax(models):
    jmodel, variables, model = models
    jax_predict = jax_make_predict_fn(_cfg(jcfg), jmodel)
    data = SyntheticDetectionData(_cfg(tcfg), seed=2)
    batches = []
    for i in range(2):
        b = data.batch(i)
        det = jax.tree.map(np.asarray, jax_predict(variables, b.images, b.img_hw,
                                                   b.scale))
        batches.append(_batches_labelled_by(det, b))
    assert min(int(b.gt_valid.sum()) for b in batches) >= 8
    want = jax_evaluator.evaluate_dataset(
        _cfg(jcfg), jmodel, variables, iter(batches), 2,
        predict_cache={HW: jax_predict})
    got = evaluator.evaluate_dataset(_cfg(tcfg), model, iter(batches), 2)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= E2E_TOL, (k, got[k], want[k])
    assert 0.2 < got["map"] < 1.0 and 0.05 < got["coco/map"] < 1.0


def test_refined_mask_levels_match_jax(models):
    jmodel, variables, model = models
    req = SyntheticDetectionData(_cfg(tcfg), seed=0).batch(1)
    cfg_j = _cfg(jcfg, mask_levels="refined")
    want = jax.tree.map(np.asarray, jax_make_predict_fn(cfg_j, jmodel)(
        variables, req.images, req.img_hw, req.scale))
    got = make_predict_fn(_cfg(tcfg, mask_levels="refined"), model)(
        req.images, req.img_hw, req.scale)
    pass1 = make_predict_fn(_cfg(tcfg), model)(req.images, req.img_hw, req.scale)
    assert want.valid.sum() > 8
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    for name in ("boxes", "scores", "masks"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert float(np.abs(g - w).max()) <= 1e-4 * max(float(np.abs(w).max()), 1.0), name
    # refined pools some detections at another level than pass 1
    assert not torch.equal(got.masks, pass1.masks)
