"""Port box ops, anchors, FPN levels and NMS against the JAX package and the
numpy goldens (tests/golden.py). Same numpy inputs through both sides."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import golden  # noqa: E402
from maskrcnn_tpu import ops as jops  # noqa: E402
from maskrcnn_tpu_torch.ops import anchors as tanchors  # noqa: E402
from maskrcnn_tpu_torch.ops.boxes import box_iou, clip_boxes, loc2bbox  # noqa: E402
from maskrcnn_tpu_torch.ops.levels import map_rois_to_fpn_levels  # noqa: E402
from maskrcnn_tpu_torch.ops.nms import nms_padded  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)


def _boxes(rng, n, span=200.0):
    yx = rng.uniform(0, span, (n, 2))
    hw = rng.uniform(1, span / 2, (n, 2))
    return np.concatenate([yx, yx + hw], 1).astype(np.float32)


def test_loc2bbox_matches_jax_and_golden():
    rng = np.random.RandomState(0)
    src = _boxes(rng, 64)
    loc = (rng.randn(64, 4) * 0.3).astype(np.float32)
    got = loc2bbox(torch.from_numpy(src), torch.from_numpy(loc)).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.loc2bbox(src, loc)),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, golden.loc2bbox(src, loc), rtol=1e-6,
                               atol=1e-4)
    # the log-size clamp: huge offsets decode like the JAX bound
    big = np.array([[0, 0, 10.0, 30.0]], np.float32)
    far = np.array([[0.0, 0.0, 50.0, -50.0]], np.float32)
    np.testing.assert_allclose(
        loc2bbox(torch.from_numpy(big), torch.from_numpy(far)).numpy(),
        np.asarray(jops.loc2bbox(big, far)), rtol=1e-6)


def test_clip_and_iou_match_jax_and_golden():
    rng = np.random.RandomState(1)
    a = _boxes(rng, 40, 300.0) - 50.0
    b = _boxes(rng, 30, 300.0)
    a[3] = a[3, [2, 3, 0, 1]]  # a degenerate (inverted) box
    got = clip_boxes(torch.from_numpy(a), (128.0, 160.0)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.clip_boxes(a, (128.0, 160.0))))
    iou = box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(iou, np.asarray(jops.box_iou(a, b)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(iou, golden.box_iou(a, b), rtol=1e-6, atol=1e-7)


def test_anchors_and_levels_match_jax_and_golden():
    from maskrcnn_tpu.ops import multilevel_anchors as jax_anchors

    shapes = [(32, 40), (16, 20), (8, 10), (4, 5), (2, 3)]
    strides = [4, 8, 16, 32, 64]
    scales = [2.0, 4.0, 8.0, 16.0, 32.0]
    for g, w in zip(tanchors.multilevel_anchors(shapes, strides, scales),
                    jax_anchors(shapes, strides, scales)):
        np.testing.assert_array_equal(g, w)

    rng = np.random.RandomState(2)
    rois = _boxes(rng, 200, 900.0)
    rois[:5] = 0.0  # degenerate: level 0
    got = map_rois_to_fpn_levels(torch.from_numpy(rois)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.map_rois_to_fpn_levels(rois)))
    np.testing.assert_array_equal(got, golden.map_rois_to_fpn_levels(rois))
    assert got.dtype == np.int32


def _nms_case(rng, n):
    boxes = _boxes(rng, n, 400.0)
    # clusters of near-duplicates so suppression chains form
    boxes[n // 2:] = boxes[: n - n // 2] + rng.uniform(-3, 3, (n - n // 2, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[::7] = scores[1]  # exact ties, broken by input order
    valid = rng.rand(n) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("n,n_out,thresh", [(300, 100, 0.3), (5000, 300, 0.7)])
def test_nms_padded_indices_equal_jax(n, n_out, thresh):
    """N=5000 takes JAX's chunked branch; any exact greedy NMS gives the
    same indices and validity."""
    rng = np.random.RandomState(n)
    boxes, scores, valid = _nms_case(rng, n)
    want_i, want_v = jops.nms_padded(jnp.asarray(boxes), jnp.asarray(scores),
                                     thresh, n_out, jnp.asarray(valid))
    got_i, got_v = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                              thresh, n_out, torch.from_numpy(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32


def test_nms_padded_matches_golden_and_batches():
    rng = np.random.RandomState(5)
    boxes, scores, _ = _nms_case(rng, 60)
    keep = golden.greedy_nms(boxes, scores, 0.5)
    idx, ok = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, 80)
    np.testing.assert_array_equal(idx.numpy()[ok.numpy()], keep)
    # leading dims batch independent problems (per-class NMS)
    sc2 = rng.uniform(0, 1, (3, 60)).astype(np.float32)
    bidx, bok = nms_padded(torch.from_numpy(boxes)[None].expand(3, -1, -1),
                           torch.from_numpy(sc2), 0.5, 80)
    for c in range(3):
        i1, o1 = nms_padded(torch.from_numpy(boxes), torch.from_numpy(sc2[c]), 0.5, 80)
        np.testing.assert_array_equal(bidx[c].numpy(), i1.numpy())
        np.testing.assert_array_equal(bok[c].numpy(), o1.numpy())
