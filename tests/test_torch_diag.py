"""The checkpoint diagnostic (``tools/diag_checkpoint.py``) on the CPU.

``tiny_test`` at its own 128×160, batch 2: one JAX random init, its class-
score layer scaled by 32 (``bench.py:spread_class_scores``, so detections
pass the 0.05 threshold), carried into the port by the weight bridge and
saved as a port checkpoint, which the tool loads. Its stages against the
same stages computed with the JAX package's functions on the same weights
and batch:

2. proposals at the test budgets (JAX's ``model.apply`` and
   ``generate_proposals``, ``box_iou``): the same valid counts, each GT's
   best proposal IoU within 1e-4;
3. the box head's softmax (JAX's ``head_box``): the top foreground
   probability, the mean background probability and the five strongest
   ROIs' probabilities within 1e-4, the same count above 0.05;
4. predict (JAX's ``make_predict_fn``): the same detection counts, their
   scores, sorted, within 1e-4 of max(1, max |JAX|).

Stage 1, the train-path loss, comes from the port's train step (held
against JAX's in ``tests/test_torch_darknet_step.py``; JAX's would draw its
sampler priorities from another generator, so its loss is not the same
number): here it equals that step taken directly on a copy of the model,
and the tool leaves the loaded weights as they were. (The train CLI's
``--profile-dir``: ``tests/test_torch_profile.py``.)
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu.models import anchors_for as jax_anchors_for  # noqa: E402
from maskrcnn_tpu.models import generate_proposals as jax_proposals  # noqa: E402
from maskrcnn_tpu.models.maskrcnn import backbone_geometry, pyramid_shapes  # noqa: E402
from maskrcnn_tpu.ops.boxes import box_iou as jax_box_iou  # noqa: E402
from maskrcnn_tpu.train import init_model  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.tools import diag_checkpoint  # noqa: E402
from maskrcnn_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
SPREAD = 32.0
ARGS = ["--preset", "tiny_test", "--image-size", "128x160", "--batch", "2",
        "--seed", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = jcfg.tiny_test()
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = jax.tree.map(np.array, jax.device_get(variables))
    variables["params"]["head"]["box"]["score"]["kernel"] *= SPREAD
    model = load_flax_variables(MaskRCNN(tcfg.tiny_test(), device="cpu", seed=0),
                                variables)
    ckpt = save_checkpoint(str(tmp_path_factory.mktemp("diag")),
                           create_train_state(tcfg.tiny_test(), model))
    stages = diag_checkpoint.main(["--weight", ckpt, *ARGS])
    batch = SyntheticDetectionData(tcfg.tiny_test()).batch(0)
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, model=model,
                stages=stages, batch=batch)


def _jax_rpn(run):
    cfg, jmodel, variables, batch = (run[k] for k in ("cfg", "jmodel", "variables",
                                                       "batch"))
    feat_strides, _ = backbone_geometry(cfg)
    shapes = pyramid_shapes(cfg, cfg.train.image_size)
    anchors = jnp.asarray(jax_anchors_for(cfg, shapes, feat_strides))
    features, locs, scores = jmodel.apply(variables, jnp.asarray(batch.images), False)
    props = jax_proposals(
        locs, scores, anchors, jnp.asarray(batch.scale), jnp.asarray(batch.img_hw),
        n_pre=cfg.proposals.n_test_pre_nms, n_post=cfg.proposals.n_test_post_nms,
        nms_thresh=cfg.proposals.nms_thresh, min_size=cfg.proposals.min_size,
        n_levels=len(shapes))
    return features, props


def test_stage_2_proposals_match_jax(run):
    batch = run["batch"]
    _, props = _jax_rpn(run)
    for i, got in enumerate(run["stages"]["proposals"]):
        valid = np.asarray(props.valid[i])
        gt = jnp.asarray(batch.gt_boxes[i][batch.gt_valid[i]])
        iou = np.asarray(jax_box_iou(gt, props.rois[i])) * valid[None]
        assert got["valid"] == int(valid.sum()) and got["n_gt"] == len(gt)
        np.testing.assert_allclose(got["best_iou"], iou.max(axis=1), atol=TOL)


def test_stage_3_box_head_matches_jax(run):
    features, props = _jax_rpn(run)
    b, r = props.rois.shape[:2]
    _, scores = run["jmodel"].apply(
        run["variables"], features, props.rois.reshape(b * r, 4),
        jnp.repeat(jnp.arange(b, dtype=jnp.int32), r), props.levels.reshape(b * r),
        method=JaxMaskRCNN.head_box)
    probs = np.asarray(jax.nn.softmax(scores, axis=-1)).reshape(b, r, -1)
    for i, got in enumerate(run["stages"]["box"]):
        p = probs[i][np.asarray(props.valid[i])]
        best = p[:, 1:].max(axis=1)
        assert got["over_0.05"] == int((best > 0.05).sum())
        np.testing.assert_allclose(got["max_fg"], best.max(), atol=TOL)
        np.testing.assert_allclose(got["mean_bg"], p[:, 0].mean(), atol=TOL)
        np.testing.assert_allclose([t[2] for t in got["top"]],
                                   np.sort(best)[::-1][:5], atol=TOL)


def test_stage_4_detections_match_jax(run):
    cfg, batch = run["cfg"], run["batch"]
    det = jax.device_get(jax_make_predict_fn(cfg, run["jmodel"])(
        run["variables"], batch.images, batch.img_hw, batch.scale))
    for i, got in enumerate(run["stages"]["detections"]):
        valid = det.valid[i]
        assert got["n"] == int(valid.sum()) > 0
        want = np.sort(det.scores[i][valid])[::-1][:len(got["top"])]
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose([t["score"] for t in got["top"]], want,
                                   atol=TOL * scale)
        assert all(0.0 <= t["best_iou"] <= 1.0 for t in got["top"])


def test_stage_1_is_the_train_step_and_leaves_the_weights(run):
    cfg = tcfg.tiny_test()
    model = copy.deepcopy(run["model"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert diag_checkpoint.diagnose(cfg, model, run["batch"]) == run["stages"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    state = create_train_state(cfg, model, seed=1)
    want = {k: float(v) for k, v in make_train_step(cfg)(state, run["batch"]).items()}
    assert run["stages"]["loss"] == want
    assert all(np.isfinite(v) for v in want.values())


def test_report_prints_every_stage(run):
    text = diag_checkpoint.report(run["stages"])
    for tag in ("[1] train loss", "[2] img 1:", "[3] img 1:", "[4] img 1:"):
        assert tag in text
