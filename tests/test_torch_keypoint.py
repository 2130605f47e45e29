"""The port's keypoint head and its targets, loss, predict, decoding and OKS
evaluation against the JAX package's, on the CPU.

- ``FPNKeypointHead`` (8 convs of 256, 17 keypoints, 56² heatmaps) under
  weights converted from a flax init, in both ``kp_upsample`` modes, f32,
  within 1e-4 of max |JAX|. ``"half_pixel"`` is ``jax.image.resize``
  against ``F.interpolate(align_corners=False)``: at ×2 the edge taps agree
  (JAX renormalises the tap that falls outside, PyTorch clamps the
  coordinate), which this test proves rather than assumes.
- ``keypoint_targets`` exact; ``keypoint_ce_loss`` within 1e-5 relative.
- Two-pass predict of ``fpn_keypoint`` at 128×160 with 256/32 proposals
  and 16 detections, from one JAX init (class scores spread ×8 in both, or
  no detection would clear the threshold): equal ``valid``/``labels``;
  boxes, scores and heatmaps within 1e-4 of max(1, max |JAX|).
- ``decode_keypoints`` and the copied OKS scorer equal JAX's.
- ``evaluate_keypoint_dataset`` against JAX's at a nonzero OKS AP: random
  weights find nothing, so each image is labelled with every other of
  JAX's own keypoint detections; every field within 1e-6.
"""

from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.eval import evaluator as jax_evaluator  # noqa: E402
from maskrcnn_tpu.eval import keypoint_eval as jax_kp_eval  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.eval.postprocess import decode_keypoints as jax_decode  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu.models.heads import FPNKeypointHead as JaxKeypointHead  # noqa: E402
from maskrcnn_tpu.targets import ProposalTargets as JaxTargets  # noqa: E402
from maskrcnn_tpu.targets import keypoint_targets as jax_keypoint_targets  # noqa: E402
from maskrcnn_tpu.train import losses as jax_losses  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.eval import evaluator, keypoint_eval  # noqa: E402
from maskrcnn_tpu_torch.eval.postprocess import decode_keypoints  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.heads.fpn_heads import FPNKeypointHead  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.targets.proposal_targets import (  # noqa: E402
    ProposalTargets,
    keypoint_targets,
)
from maskrcnn_tpu_torch.train import losses  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    export_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)

HEAD_TOL = 1e-4  # of max |JAX|: 8 convs, a transposed conv, a resize
PREDICT_TOL = 1e-4  # of max(1, max |JAX|), as tests/test_torch_predict.py
LOSS_RTOL = 1e-5
REPORT_TOL = 1e-6
HW = (128, 160)
B = 2
K = 17


def _numpy(tree):
    return jax.tree.map(lambda x: np.array(x), jax.device_get(tree))


# ------------------------------------------------------------------- head

@pytest.mark.parametrize("upsample", ["half_pixel", "align_corners"])
def test_keypoint_head_matches_jax(upsample):
    rng = np.random.RandomState(0)
    pooled_box = rng.randn(5, 7, 7, 256).astype(np.float32)
    pooled_mask = rng.randn(5, 14, 14, 256).astype(np.float32)
    jhead = JaxKeypointHead(2, K, 8, upsample=upsample)
    variables = _numpy(jhead.init(jax.random.key(3), pooled_box, pooled_mask))
    want = [np.asarray(x) for x in jhead.apply(variables, pooled_box, pooled_mask)]
    head = FPNKeypointHead(2, K, 8, upsample=upsample)
    head.load_state_dict(convert_flax_variables(variables, head), strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(pooled_box), torch.from_numpy(pooled_mask))
    assert got[2].shape == (5, 56, 56, K) and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        err = float(np.abs(g.numpy() - w).max())
        assert err <= HEAD_TOL * float(np.abs(w).max()), (upsample, err)
    # the converter's inverse gives the flax tree back
    back = export_flax_variables(head, variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_half_pixel_upsample_edges_equal_jax_resize():
    """At ×2 the first and last output rows are the edge input rows in both
    (no extrapolation), the interior the 1/4–3/4 blend."""
    from torch.nn import functional as F

    x = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 56, 56, 3), method="linear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy()[:, 0, 0], x[:, 0, 0], atol=1e-6)


# ------------------------------------------------------- targets and loss

def _sample(rng, b=2, n=24, g=5):
    """ROIs jittered around GT boxes; each GT's keypoints spread over its
    box and a margin, with all three visibilities."""
    gy, gx = rng.uniform(-5, 80, (b, g)), rng.uniform(-5, 100, (b, g))
    gh, gw = rng.uniform(0.5, 50, (b, g)), rng.uniform(0.5, 50, (b, g))
    assign = rng.randint(0, g, (b, n)).astype(np.int32)
    pick = lambda x: np.take_along_axis(x, assign, 1)  # noqa: E731
    y0 = pick(gy) + rng.uniform(-5, 5, (b, n))
    x0 = pick(gx) + rng.uniform(-5, 5, (b, n))
    rois = np.stack([y0, x0, y0 + pick(gh) * rng.uniform(0.7, 1.3, (b, n)),
                     x0 + pick(gw) * rng.uniform(0.7, 1.3, (b, n))],
                    -1).astype(np.float32)
    kps = np.zeros((b, g, K, 3), np.float32)
    kps[..., 0] = gy[..., None] + gh[..., None] * rng.uniform(-0.2, 1.2, (b, g, K))
    kps[..., 1] = gx[..., None] + gw[..., None] * rng.uniform(-0.2, 1.2, (b, g, K))
    kps[..., 2] = rng.randint(0, 3, (b, g, K))
    zeros = np.zeros((b, n), np.int32)
    fields = dict(rois=rois, levels=zeros, labels=zeros,
                  locs=np.zeros((b, n, 4), np.float32), assignment=assign,
                  is_pos=np.ones((b, n), bool), valid=np.ones((b, n), bool))
    return fields, kps


def test_keypoint_targets_exact():
    fields, kps = _sample(np.random.RandomState(2))
    want = np.asarray(jax_keypoint_targets(
        JaxTargets(**{k: jnp.asarray(v) for k, v in fields.items()}),
        jnp.asarray(kps), mask_size=56))
    tfields = {k: torch.from_numpy(v) for k, v in fields.items()}
    tfields["assignment"] = tfields["assignment"].long()
    got = keypoint_targets(ProposalTargets(**tfields), torch.from_numpy(kps),
                           mask_size=56)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).mean() > 0.1 and (want == -1).mean() > 0.1


def test_keypoint_ce_loss_matches_jax():
    rng = np.random.RandomState(3)
    heat = rng.randn(12, 56, 56, K).astype(np.float32) * 2
    labels = rng.randint(-1, 56 * 56, (12, K)).astype(np.int32)
    is_pos = rng.rand(12) < 0.7
    want = float(jax_losses.keypoint_ce_loss(
        jnp.asarray(heat), jnp.asarray(labels), jnp.asarray(is_pos)))
    got = float(losses.keypoint_ce_loss(torch.from_numpy(heat),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(is_pos)))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    none = losses.keypoint_ce_loss(torch.from_numpy(heat),
                                   torch.from_numpy(labels),
                                   torch.zeros(12, dtype=torch.bool))
    assert float(none) == 0.0


# ------------------------------------------------------ predict and decode

def _cfg(lib):
    return lib._rep(
        lib.fpn_keypoint(),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
        eval=dict(max_detections=16), train=dict(batch_size=B, image_size=HW))


@pytest.fixture(scope="module")
def models():
    jmodel = JaxMaskRCNN(_cfg(jcfg))
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy, method=JaxMaskRCNN.init_forward))
    variables = _numpy(init(jax.random.key(5)))
    box = variables["params"]["head"]["box"]
    box["score"]["kernel"] = box["score"]["kernel"] * 8.0  # spread_class_scores
    model = load_flax_variables(MaskRCNN(_cfg(tcfg), device="cpu", seed=0),
                                variables)
    jax_predict = jax_make_predict_fn(_cfg(jcfg), jmodel)
    batches = [SyntheticDetectionData(_cfg(tcfg), seed=6).batch(i) for i in range(2)]
    jdets = [jax.tree.map(np.asarray, jax_predict(variables, b.images, b.img_hw,
                                                  b.scale)) for b in batches]
    return jmodel, variables, model, jax_predict, batches, jdets


def test_predict_heatmaps_match_jax(models):
    _, _, model, _, batches, jdets = models
    b, want = batches[0], jdets[0]
    got = make_predict_fn(_cfg(tcfg), model)(b.images, b.img_hw, b.scale)
    assert got.masks is None and want.masks is None
    assert got.heatmaps.shape == (B, 16, 56, 56, K)
    assert int(want.valid.sum()) >= 12
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    for name in ("boxes", "scores", "heatmaps"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        err = float(np.abs(g - w).max())
        assert err <= PREDICT_TOL * max(float(np.abs(w).max()), 1.0), (name, err)


def test_decode_keypoints_equals_jax():
    rng = np.random.RandomState(4)
    boxes = rng.uniform(0, 100, (9, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    boxes[3, 2:] = boxes[3, :2]  # an empty box
    heat = rng.randn(9, 56, 56, K).astype(np.float32)
    valid = rng.rand(9) < 0.7
    valid[3] = True
    got, want = decode_keypoints(boxes, heat, valid), jax_decode(boxes, heat, valid)
    assert got.dtype == want.dtype and got.shape == (valid.sum(), K, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        decode_keypoints(boxes, heat, np.zeros(9, bool)),
        jax_decode(boxes, heat, np.zeros(9, bool)))


def test_copied_oks_scorer_equals_jax():
    rng = np.random.RandomState(5)
    preds, scores, gts, areas = [], [], [], []
    for i in range(5):
        gt = rng.uniform(0, 100, (rng.randint(0, 4), K, 3))
        gt[..., 2] = rng.randint(0, 3, gt.shape[:2])
        n = rng.randint(0, 5)
        pred = rng.uniform(0, 100, (n, K, 3))
        pred[: len(gt)][..., :2] = gt[:n, :, :2] + rng.randn(min(n, len(gt)), K, 2) * 3
        preds.append(pred)
        scores.append(rng.rand(n))
        gts.append(gt)
        areas.append(rng.uniform(100, 3000, len(gt)))
    want = jax_kp_eval.eval_keypoints_oks_ap(preds, scores, gts, areas)
    got = keypoint_eval.eval_keypoints_oks_ap(preds, scores, gts, areas)
    assert got == want and want["ap"] > 0
    assert keypoint_eval.pck(preds, gts, [np.zeros((len(g), 4)) + [0, 0, 50, 50]
                                          for g in gts]) == jax_kp_eval.pck(
        preds, gts, [np.zeros((len(g), 4)) + [0, 0, 50, 50] for g in gts])
    np.testing.assert_array_equal(keypoint_eval.keypoint_sigmas(20),
                                  jax_kp_eval.keypoint_sigmas(20))


class _Batch(NamedTuple):
    images: np.ndarray
    img_hw: np.ndarray
    scale: np.ndarray
    gt_boxes: np.ndarray
    gt_labels: np.ndarray
    gt_valid: np.ndarray
    gt_keypoints: np.ndarray


def _labelled_by(det, batch) -> _Batch:
    """The batch's images with every other valid detection of ``det`` as a
    GT person: its box, and its decoded keypoints, all visible."""
    keep = det.valid & (np.cumsum(det.valid, axis=1) % 2 == 1)
    kps = np.stack([jax_decode(det.boxes[i], det.heatmaps[i],
                               np.ones(det.valid.shape[1], bool))
                    for i in range(det.valid.shape[0])]).astype(np.float32)
    kps[..., 2] = 2.0
    return _Batch(batch.images, batch.img_hw, batch.scale, det.boxes,
                  det.labels, keep, kps)


def test_evaluate_keypoint_dataset_matches_jax(models):
    jmodel, variables, model, jax_predict, batches, jdets = models
    labelled = [_labelled_by(d, b) for d, b in zip(jdets, batches)]
    assert min(int(b.gt_valid.sum()) for b in labelled) >= 6
    want = jax_evaluator.evaluate_keypoint_dataset(
        _cfg(jcfg), jmodel, variables, iter(labelled), 2,
        predict_cache={HW: jax_predict})
    got = evaluator.evaluate_keypoint_dataset(_cfg(tcfg), model, iter(labelled), 2)
    assert got.keys() == want.keys() == {"ap", "ap50", "ap75"}
    for k in want:
        assert abs(got[k] - want[k]) <= REPORT_TOL, (k, got[k], want[k])
    assert 0.2 < got["ap"] < 1.0
