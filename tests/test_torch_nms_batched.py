"""NMS over a batch in one call: the port's ``generate_proposals`` handles
the batch written out (JAX ``vmap``s ``per_image``) with one ``nms_padded``
call of B problems, and ``make_predict_fn`` runs every image's per-class
NMS in one call of (B, n_fg) problems.

- Batched proposals equal the per-image loop they replace bit for bit on
  the CPU, and JAX's ``generate_proposals`` within the tolerances of
  ``tests/test_torch_predict.py``, at B=3 with a different ``img_hw`` and
  ``scale`` for each image and one image with fewer finite scores than
  ``n_post``; the ``fast`` preset's 2000/1000 train budgets at 128×128
  (4092 anchors) and the ``parity`` preset's serving budgets.
- ``parity`` predict at b2 (``fpn_mask``'s code path, cut to 128×128 and 3
  classes) against JAX's, with two NMS calls in all.
- The kernel's walk, transcribed (``nms_keep_bitmask_plain``), equals the
  Jacobi spec up to each problem's ``n_out``-th kept box at P=3, where the
  problems stop at different steps (``nms_work``'s ``steps``).
"""

import dataclasses

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
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticRequests  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.kernels import nms_cuda  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.models.rpn import (  # noqa: E402
    Proposals,
    generate_proposals,
    top_k_stable,
)
from maskrcnn_tpu_torch.ops import nms as nms_mod  # noqa: E402
from maskrcnn_tpu_torch.ops.boxes import clip_boxes, loc2bbox  # noqa: E402
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)

HW = (128, 128)


def per_image_proposals(locs, scores, anchors, scale, img_hw, n_pre, n_post,
                        nms_thresh, min_size, n_levels):
    """The loop the batched ``generate_proposals`` replaced: one image and
    one ``nms_padded`` call at a time."""
    fg = torch.softmax(scores, dim=-1)[..., 1]
    out = []
    for i in range(locs.shape[0]):
        boxes = clip_boxes(loc2bbox(anchors, locs[i]), (img_hw[i, 0], img_hw[i, 1]))
        ms = min_size * scale[i]
        ok = ((boxes[:, 2] - boxes[:, 0]) >= ms) & ((boxes[:, 3] - boxes[:, 1]) >= ms)
        masked = torch.where(ok, fg[i], torch.full_like(fg[i], -float("inf")))
        top_scores, top_idx = top_k_stable(masked, min(n_pre, boxes.shape[0]))
        top_boxes = boxes[top_idx]
        idx, valid = nms_mod.nms_padded(top_boxes, top_scores, nms_thresh,
                                        n_post, torch.isfinite(top_scores))
        idx = idx.long()
        rois = top_boxes[idx]
        roi_scores = torch.where(valid, top_scores[idx], torch.zeros_like(rois[:, 0]))
        levels = torch.where(valid, map_rois_to_fpn_levels(rois, 0, n_levels - 1),
                             torch.zeros_like(valid, dtype=torch.int32))
        out.append((rois, levels, valid, roi_scores))
    return Proposals(*(torch.stack(t) for t in zip(*out)))


class Spy:
    """Stands in for ``nms_greedy`` in ``ops.nms``: records each call's
    (P, N) and runs the CPU's plain version."""

    def __init__(self):
        self.shapes = []

    def __call__(self, boxes_s, valid_s, iou_thresh, n_out):
        self.shapes.append(tuple(valid_s.shape))
        return nms_cuda.nms_keep_plain(boxes_s, valid_s, iou_thresh, n_out)


def _rpn_inputs(cfg, b, seed):
    shapes = pyramid_shapes(cfg, HW)
    anchors = jax_anchors_for(cfg, shapes, backbone_geometry(cfg)[0])
    rng = np.random.default_rng(seed)
    a = anchors.shape[0]
    locs = (rng.normal(size=(b, a, 4)) * 0.2).astype(np.float32)
    scores = rng.normal(size=(b, a, 2)).astype(np.float32)
    scale = np.array([1.0, 0.8, 3.0][:b], np.float32)
    img_hw = np.array([[128, 128], [100, 120], [56, 72]][:b], np.float32)
    return anchors, locs, scores, scale, img_hw


@pytest.mark.parametrize("preset,train", [("fast", True), ("parity", False)])
def test_batched_proposals_equal_the_loop_and_jax(preset, train, monkeypatch):
    cfg = getattr(jcfg, preset)()
    assert (dataclasses.asdict(getattr(tcfg, preset)().proposals)
            == dataclasses.asdict(cfg.proposals))
    p = cfg.proposals
    n_pre, n_post = ((p.n_train_pre_nms, p.n_train_post_nms) if train
                     else (p.n_test_pre_nms, p.n_test_post_nms))
    if preset == "fast":
        assert (n_pre, n_post) == (2000, 1000)
    anchors, locs, scores, scale, img_hw = _rpn_inputs(cfg, 3, 5)
    assert anchors.shape[0] == 4092
    kw = dict(n_pre=n_pre, n_post=n_post, nms_thresh=p.nms_thresh,
              min_size=p.min_size, n_levels=5)
    args = [torch.from_numpy(x) for x in (locs, scores, anchors, scale, img_hw)]
    spy = Spy()
    monkeypatch.setattr(nms_mod, "nms_greedy", spy)
    got = generate_proposals(*args, **kw)
    assert spy.shapes == [(3, min(n_pre, anchors.shape[0]))]
    loop = per_image_proposals(*args, **kw)
    assert len(spy.shapes) == 4
    for name, g, w in zip(Proposals._fields, got, loop):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    counts = got.valid.sum(dim=1).tolist()
    assert counts[0] > counts[2] > 0 and counts[2] < n_post, counts
    assert not got.valid[2, counts[2]:].any()

    want = jax.tree.map(np.asarray, jax_proposals(
        *(jnp.asarray(x) for x in (locs, scores, anchors, scale, img_hw)), **kw))
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.levels.numpy(), want.levels)
    np.testing.assert_allclose(got.rois.numpy(), want.rois, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-6,
                               atol=1e-7)


def _predict_cfg(lib):
    return lib._rep(
        lib.parity(), model=dict(n_fg_class=3),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
        eval=dict(max_detections=16),
        train=dict(batch_size=2, image_size=HW),
    )


def test_parity_predict_at_b2_runs_two_nms_calls_and_matches_jax(monkeypatch):
    """One RPN call of (2, 256) and one per-class call of (2·3, 32)
    problems; detections equal JAX's as in ``test_torch_predict.py``."""
    cfg = _predict_cfg(jcfg)
    jmodel = JaxMaskRCNN(cfg)
    dummy = jnp.zeros((2, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy, method=JaxMaskRCNN.init_forward))
    variables = jax.tree.map(np.asarray, jax.device_get(init(jax.random.key(1))))
    model = MaskRCNN(_predict_cfg(tcfg), device="cpu", seed=0)
    load_flax_variables(model, variables)
    req = SyntheticRequests(_predict_cfg(tcfg), seed=2).batch(0)
    want = jax.tree.map(np.asarray, jax_make_predict_fn(cfg, jmodel)(
        variables, req.images, req.img_hw, req.scale))
    spy = Spy()
    monkeypatch.setattr(nms_mod, "nms_greedy", spy)
    got = make_predict_fn(_predict_cfg(tcfg), model)(req.images, req.img_hw,
                                                     req.scale)
    assert spy.shapes == [(2, 256), (2 * 3, 32)]
    assert want.valid.sum() > 4
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    for name in ("boxes", "scores", "masks"):
        g, w = getattr(got, name).numpy(), getattr(want, name)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0), name


def _problem(rng, n, side, size):
    yx = rng.uniform(0, side, (n, 2))
    hw = rng.uniform(*size, (n, 2))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def test_walk_equals_jacobi_when_problems_stop_at_different_steps():
    """Three problems of 300 boxes, n_out 100: sparse boxes keep almost
    every box and stop in the second step, denser ones later, the densest
    never (fewer than 100 kept)."""
    rng = np.random.RandomState(13)
    n, n_out = 300, 100
    boxes = np.stack([_problem(rng, n, 2000.0, (8.0, 40.0)),
                      _problem(rng, n, 300.0, (30.0, 80.0)),
                      _problem(rng, n, 100.0, (40.0, 100.0))])
    valid = rng.rand(3, n) > 0.1
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    full = nms_cuda.nms_keep_plain(b, v, 0.5, n_out)
    walk = nms_cuda.nms_keep_bitmask_plain(b, v, 0.5, n_out)
    prefix = torch.cumsum(full.long(), -1) <= n_out
    assert torch.equal(walk, full & prefix)
    work = nms_cuda.nms_work(full, n_out)
    assert work["steps"] == [2, 3, 5]
    assert work["max_steps"] == 5
    assert walk.sum(-1).tolist()[:2] == [n_out, n_out]
    assert int(walk[2].sum()) == int(full[2].sum()) < n_out
