"""The port's slice as a whole: ``fpn_mask`` two-pass predict against the JAX
package on the CPU.

``fpn_mask`` cut to 128×128, 3 classes, 256/32 proposals and 16 detections,
with one JAX random init carried into the port by the weight bridge.

- Stage-wise, strict: JAX's RPN outputs through the port's
  ``generate_proposals`` select the same ROIs; JAX's detections and
  features through the port's pass 2 give the same masks.
- End to end: equal ``valid``/``labels`` and boxes, scores and masks within
  1e-4 at this seed. The two frameworks differ in the last bits of every
  convolution, so a float near-tie could flip an order at another seed; the
  stage-wise checks are the strict oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu.models import anchors_for as jax_anchors_for  # noqa: E402
from maskrcnn_tpu.models import generate_proposals as jax_proposals  # noqa: E402
from maskrcnn_tpu.models.maskrcnn import backbone_geometry, pyramid_shapes  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.bench import passing_pairs  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticRequests  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import (  # noqa: E402
    backbone_geometry as port_backbone_geometry,
    pyramid_shapes as port_pyramid_shapes,
)
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals  # noqa: E402
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (128, 128)
B = 2


def _cfg(lib, **model):
    return lib._rep(
        lib.fpn_mask(), model=dict(n_fg_class=3, **model),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
        eval=dict(max_detections=16),
        train=dict(batch_size=B, image_size=HW),
    )


@pytest.fixture(scope="module")
def slice_run():
    """Both packages' models, the request, and JAX's predict output."""
    cfg = _cfg(jcfg)
    jmodel = JaxMaskRCNN(cfg)
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy,
                                         method=JaxMaskRCNN.init_forward))
    variables = jax.tree.map(np.asarray, jax.device_get(init(jax.random.key(0))))
    model = MaskRCNN(_cfg(tcfg), device="cpu", seed=0)
    load_flax_variables(model, variables)
    req = SyntheticRequests(_cfg(tcfg), seed=0).batch(0)
    want = jax_make_predict_fn(cfg, jmodel)(variables, req.images, req.img_hw,
                                           req.scale)
    want = jax.tree.map(np.array, want)  # writable copies
    return cfg, jmodel, variables, model, req, want


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1.0), err


def test_synthetic_requests_match_jax():
    for index in (0, 3):
        want = SyntheticDetectionData(_cfg(jcfg), seed=1).batch(index)
        got = SyntheticRequests(_cfg(tcfg), seed=1).batch(index)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.img_hw, want.img_hw)
        np.testing.assert_array_equal(got.scale, want.scale)


def test_proposals_select_the_same_rois(slice_run):
    cfg, jmodel, variables, _, req, _ = slice_run
    _, locs, scores = jmodel.apply(variables, jnp.asarray(req.images), False)
    shapes = pyramid_shapes(cfg, HW)
    strides = backbone_geometry(cfg)[0]
    np.testing.assert_array_equal(anchors_for(cfg, shapes, strides),
                                  jax_anchors_for(cfg, shapes, strides))
    anchors = jax_anchors_for(cfg, shapes, strides)
    kw = dict(n_pre=256, n_post=32, nms_thresh=0.7, min_size=16.0, n_levels=5)
    want = jax.tree.map(np.asarray, jax_proposals(
        locs, scores, jnp.asarray(anchors), jnp.asarray(req.scale),
        jnp.asarray(req.img_hw), **kw))
    got = generate_proposals(
        torch.tensor(np.asarray(locs)), torch.tensor(np.asarray(scores)),
        torch.from_numpy(anchors), torch.from_numpy(req.scale),
        torch.from_numpy(req.img_hw), **kw)
    assert want.valid.sum() > 8
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.levels.numpy(), want.levels)
    # same ROI in every slot: distinct candidates differ by whole pixels
    np.testing.assert_allclose(got.rois.numpy(), want.rois, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-6,
                               atol=1e-7)


def test_pass2_masks_from_jax_detections(slice_run):
    _, jmodel, variables, model, req, want = slice_run
    features, _, _ = jmodel.apply(variables, jnp.asarray(req.images), False)
    d = want.boxes.shape[1]
    boxes = want.boxes.reshape(B * d, 4)
    labels = want.labels.reshape(B * d)
    bi = np.repeat(np.arange(B, dtype=np.int32), d)
    levels = np.random.RandomState(0).randint(0, 5, B * d).astype(np.int32)
    j_logits = jmodel.apply(
        variables, features, jnp.asarray(boxes), jnp.asarray(bi),
        jnp.asarray(levels), jnp.asarray(labels), method=JaxMaskRCNN.head_mask)
    with torch.no_grad():
        logits = model.head_mask(
            [torch.tensor(np.asarray(f)) for f in features],
            torch.from_numpy(boxes), torch.from_numpy(bi),
            torch.from_numpy(levels), torch.from_numpy(labels))
    _close(torch.sigmoid(logits).numpy(), jax.nn.sigmoid(j_logits))


def test_predict_end_to_end_matches_jax(slice_run):
    _, _, _, model, req, want = slice_run
    predict = make_predict_fn(_cfg(tcfg), model)
    got = predict(req.images, req.img_hw, req.scale)
    assert want.valid.sum() > 4
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    assert got.labels.dtype == torch.int32 and got.valid.dtype == torch.bool
    _close(got.boxes.numpy(), want.boxes)
    _close(got.scores.numpy(), want.scores)
    assert got.masks.shape == want.masks.shape == (B, 16, 28, 28)
    _close(got.masks.numpy(), want.masks)
    assert got.heatmaps is None and want.heatmaps is None


def test_passing_pairs_counts_pass1_scores(slice_run):
    """The benchmark's load figure: the pass-1 (ROI, class) pairs whose
    class score clears ``score_thresh``, counted from a direct pass 1."""
    _, _, _, model, req, _ = slice_run
    cfg = _cfg(tcfg)
    shapes = port_pyramid_shapes(cfg, HW)
    anchors = anchors_for(cfg, shapes, port_backbone_geometry(cfg)[0])
    with torch.no_grad():
        features, locs, scores = model(torch.from_numpy(req.images))
        props = generate_proposals(
            locs, scores, torch.from_numpy(anchors), torch.from_numpy(req.scale),
            torch.from_numpy(req.img_hw), n_pre=256, n_post=32, nms_thresh=0.7,
            min_size=16.0, n_levels=5)
        bi = torch.arange(B, dtype=torch.int32).repeat_interleave(32)
        _, logits = model.head_box(features, props.rois.reshape(-1, 4), bi,
                                   props.levels.reshape(-1))
    want = int((torch.softmax(logits, -1)[:, 1:] > cfg.eval.score_thresh).sum())
    got = passing_pairs(cfg, model, make_predict_fn(cfg, model),
                        [(req.images, req.img_hw, req.scale)] * 2)
    assert want > 0 and got == [want, want]


def test_pallas_geometry_pool_matches_jax_region(slice_run):
    """``roi_align="pallas"`` pools in the TPU kernel's window geometry; on
    ROIs inside the exact span it equals JAX's region form."""
    cfg, jmodel, variables, _, req, want = slice_run
    features, _, _ = jmodel.apply(variables, jnp.asarray(req.images), False)
    model = MaskRCNN(_cfg(tcfg, roi_align="pallas"), device="cpu")
    d = want.boxes.shape[1]
    boxes = want.boxes.reshape(B * d, 4)
    bi = np.repeat(np.arange(B, dtype=np.int32), d)
    # the level map bounds every span within the exact window
    levels = map_rois_to_fpn_levels(torch.from_numpy(boxes)).numpy()
    for size in (7, 14):
        j = jmodel.apply(variables, features, jnp.asarray(boxes),
                         jnp.asarray(bi), jnp.asarray(levels), (size, size),
                         method=JaxMaskRCNN.pool)
        got = model.pool([torch.tensor(np.asarray(f)) for f in features],
                         torch.from_numpy(boxes), torch.from_numpy(bi),
                         torch.from_numpy(levels), (size, size))
        _close(got.numpy(), j)
