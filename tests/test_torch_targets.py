"""The port's target samplers against the JAX package on the CPU.

``anchor_targets``, ``proposal_targets`` and ``mask_targets`` get the same
numpy inputs in both packages. The JAX samplers draw their random
priorities from per-image keys; the test draws the same numbers with
``jax.random`` along the same splits (``k1, k2 = split(k)``, then
``uniform(k1, shape)`` for the positives and ``uniform(k2, shape)`` for the
negatives) and hands them to the port. Labels, slots and validity must be
equal; loc targets within 1e-5 (float32 ``log`` and divisions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu.ops import bbox2loc as jax_bbox2loc  # noqa: E402
from maskrcnn_tpu.ops.anchors import multilevel_anchors  # noqa: E402
from maskrcnn_tpu.targets import anchor_targets as jax_anchor_targets  # noqa: E402
from maskrcnn_tpu.targets import mask_targets as jax_mask_targets  # noqa: E402
from maskrcnn_tpu.targets import proposal_targets as jax_proposal_targets  # noqa: E402
from maskrcnn_tpu.targets.proposal_targets import (  # noqa: E402
    ProposalTargets as JaxProposalTargets,
)
from maskrcnn_tpu_torch.ops.boxes import bbox2loc  # noqa: E402
from maskrcnn_tpu_torch.targets.anchor_targets import (  # noqa: E402
    anchor_targets,
    keep_top_random,
)
from maskrcnn_tpu_torch.targets.proposal_targets import (  # noqa: E402
    ProposalTargets,
    mask_targets,
    proposal_targets,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

LOC_TOL = 1e-5


def _draws(keys, n):
    """Per-image (pos_u, neg_u), each (B, n): what a JAX sampler draws from
    each key of the (B,) key batch."""
    pos, neg = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(k1, (n,))))
        neg.append(np.asarray(jax.random.uniform(k2, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def _boxes(rng, shape, lo=0.0, hi=120.0, min_size=6.0, max_size=60.0):
    yx = rng.uniform(lo, hi, shape + (2,))
    hw = rng.uniform(min_size, max_size, shape + (2,))
    return np.concatenate([yx, yx + hw], -1).astype(np.float32)


def _scene(seed, b=3, g=8, r=96, n_valid=(5, 1, 0)):
    """GT boxes with ``n_valid`` real ones per image, and proposals of which
    a third are jittered copies of GT boxes (positives), the rest random."""
    rng = np.random.RandomState(seed)
    gt = _boxes(rng, (b, g), min_size=20.0)
    gt_valid = np.zeros((b, g), bool)
    for i, n in enumerate(n_valid):
        gt_valid[i, :n] = True
    gt_labels = rng.randint(0, 3, (b, g)).astype(np.int32)
    rois = _boxes(rng, (b, r))
    near = gt[:, rng.randint(0, g, r // 3)] + rng.uniform(-3, 3, (b, r // 3, 4))
    rois[:, : r // 3] = near.astype(np.float32)
    roi_valid = rng.rand(b, r) < 0.9
    roi_levels = rng.randint(0, 5, (b, r)).astype(np.int32)
    return gt, gt_valid, gt_labels, rois, roi_valid, roi_levels


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_bbox2loc_matches_jax():
    rng = np.random.RandomState(0)
    src, dst = _boxes(rng, (50,)), _boxes(rng, (50,))
    src[0] = [5, 5, 5, 5]  # degenerate: sizes floor at the float epsilon
    got = bbox2loc(*_t(src, dst)).numpy()
    want = np.asarray(jax_bbox2loc(*_j(src, dst)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("n_sample,n_valid", [
    (32, (5, 1, 0)),  # one image with no valid GT
    (256, (5, 1, 0)),  # fewer positives than the cap: every positive kept
    (16, (8, 8, 3)),
])
def test_proposal_targets_match_jax(n_sample, n_valid):
    gt, gt_valid, gt_labels, rois, roi_valid, roi_levels = _scene(1, n_valid=n_valid)
    b, g = gt_valid.shape
    keys = jax.random.split(jax.random.key(7), b)
    want = jax_proposal_targets(
        keys, *_j(rois, roi_valid, roi_levels, gt, gt_labels, gt_valid),
        n_sample=n_sample)
    pos_u, neg_u = _draws(keys, rois.shape[1] + g)
    got = proposal_targets(
        pos_u, neg_u, *_t(rois, roi_valid, roi_levels, gt, gt_labels, gt_valid),
        n_sample=n_sample)
    for name in ("levels", "labels", "assignment", "is_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # every slot holds the same ROI, invalid slots included (stable ranking)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_allclose(got.locs.numpy(), np.asarray(want.locs),
                               rtol=LOC_TOL, atol=LOC_TOL)
    assert got.labels.dtype == got.levels.dtype == torch.int32
    n_pos = (got.is_pos & got.valid).sum(dim=1)
    cap = int(round(n_sample * 0.25))
    if n_sample == 256:
        assert 0 < int(n_pos[0]) < cap  # fewer positives than the cap
        assert not bool(got.valid[0].all())
    else:
        assert int(n_pos[0]) == cap
    if n_valid[-1] == 0:  # no valid GT: no positive, background only
        assert int(n_pos[-1]) == 0 and int(got.labels[-1].max()) == 0
        assert bool(got.valid[-1].any())


def test_proposal_targets_with_fewer_candidates_than_slots():
    """n_sample above R+G: slot indices past the candidate list are clamped,
    as JAX's gather clamps them, and those slots are invalid."""
    gt, gt_valid, gt_labels, rois, roi_valid, roi_levels = _scene(2, r=12)
    b, g = gt_valid.shape
    keys = jax.random.split(jax.random.key(3), b)
    want = jax_proposal_targets(
        keys, *_j(rois, roi_valid, roi_levels, gt, gt_labels, gt_valid),
        n_sample=64)
    got = proposal_targets(
        *_draws(keys, 12 + g),
        *_t(rois, roi_valid, roi_levels, gt, gt_labels, gt_valid), n_sample=64)
    for name in ("rois", "levels", "labels", "assignment", "is_pos", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert not bool(got.valid[:, 12 + g:].any())


def _anchor_scene(seed, hw=(128, 160)):
    rng = np.random.RandomState(seed)
    shapes = [(hw[0] // s, hw[1] // s) for s in (4, 8, 16)]
    anchors = np.concatenate(multilevel_anchors(
        shapes, [4, 8, 16], [2.0, 4.0, 8.0], 16.0, (0.5, 1.0, 2.0)), 0)
    b, g = 3, 6
    gt = _boxes(rng, (b, g), hi=70.0, min_size=12.0, max_size=50.0)
    gt_valid = np.zeros((b, g), bool)
    gt_valid[0, :5] = True
    gt_valid[1, :1] = True  # image 2: no valid GT
    img_hw = np.array([hw, (100, 130), hw], np.float32)
    return anchors.astype(np.float32), gt, gt_valid, img_hw


@pytest.mark.parametrize("n_sample", [256, 16, 4000])
def test_anchor_targets_match_jax(n_sample):
    anchors, gt, gt_valid, img_hw = _anchor_scene(3)
    b = gt.shape[0]
    keys = jax.random.split(jax.random.key(11), b)
    want = jax_anchor_targets(keys, *_j(anchors, gt, gt_valid, img_hw),
                              n_sample=n_sample)
    pos_u, neg_u = _draws(keys, anchors.shape[0])
    got = anchor_targets(pos_u, neg_u, *_t(anchors, gt, gt_valid, img_hw),
                         n_sample=n_sample)
    labels = got.labels.numpy()
    np.testing.assert_array_equal(labels, np.asarray(want.labels))
    assert got.labels.dtype == torch.int32
    np.testing.assert_allclose(got.locs.numpy(), np.asarray(want.locs),
                               rtol=LOC_TOL, atol=LOC_TOL)
    n_pos, n_neg = (labels == 1).sum(1), (labels == 0).sum(1)
    assert n_pos[0] > 0 and n_pos[2] == 0  # no valid GT: negatives only
    if n_sample == 16:
        assert n_pos[0] == 8 and n_neg[0] == 8 and n_neg[2] == 16
    if n_sample == 256:
        assert 0 < n_pos[0] < 128  # fewer positives than the cap
        assert (n_pos + n_neg == 256).all()
    # anchors that cross the true image extent are ignored
    outside = (anchors[:, 2] > img_hw[1, 0]) | (anchors[:, 3] > img_hw[1, 1])
    assert (labels[1][outside] == -1).all() and outside.any()


def test_keep_top_random_is_a_threshold_not_an_index_set():
    mask = torch.tensor([[True, True, False, True, True, False],
                         [True, False, False, False, False, False],
                         [True, True, True, True, True, True]])
    u = torch.tensor([[0.5, 0.9, 0.99, 0.5, 0.1, 0.7]] * 3)
    # row 0, k=2: the 2nd largest masked priority is 0.5 and ties at it stay
    keep = keep_top_random(mask, u, torch.tensor([2, 3, 0]), 4)
    assert keep.tolist() == [[True, True, False, True, False, False],
                             [True, False, False, False, False, False],
                             [False] * 6]  # fewer than k: all; k == 0: none
    # k above k_max indexes the k_max-th value
    keep = keep_top_random(mask[2:], u[2:], 6, 2)
    assert keep.tolist() == [[False, True, True, False, False, False]]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_mask_targets_match_jax(dtype):
    gt, gt_valid, gt_labels, rois, roi_valid, roi_levels = _scene(4, n_valid=(5, 2, 1))
    b, g = gt_valid.shape
    rng = np.random.RandomState(5)
    s = 56
    yy, xx = np.mgrid[:s, :s]
    # ellipses and rectangles with soft edges, as interpolated crops have
    masks = np.zeros((b, g, s, s), np.float32)
    for i in range(b):
        for k in range(g):
            cy, cx, ry, rx = rng.uniform(20, 36, 2).tolist() + rng.uniform(8, 26, 2).tolist()
            d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            masks[i, k] = np.clip(1.5 - d, 0.0, 1.0)
    if dtype == "uint8":
        masks = (masks * 255.0 + 0.5).astype(np.uint8)
    keys = jax.random.split(jax.random.key(2), b)
    sample = proposal_targets(
        *_draws(keys, rois.shape[1] + g),
        *_t(rois, roi_valid, roi_levels, gt, gt_labels, gt_valid), n_sample=32)
    jsample = JaxProposalTargets(*(jnp.asarray(x.numpy()) for x in sample))
    want = np.asarray(jax_mask_targets(jsample, *_j(masks, gt), mask_size=28))
    got = mask_targets(sample, *_t(masks, gt), mask_size=28).numpy()
    assert got.shape == (b, 32, 28, 28)
    assert set(np.unique(got)) == {0.0, 1.0}
    # a cell whose interpolated value sits within float32 rounding of 0.5
    # may land on either side; none does on these inputs
    np.testing.assert_array_equal(got, want)
    pos = (sample.is_pos & sample.valid).numpy()
    assert 0.2 < got[pos].mean() < 0.95  # positives overlap their GT's shape
    # the prefix form the train step uses equals the full call's prefix
    prefix = ProposalTargets(*(x[:, :8] for x in sample))
    np.testing.assert_array_equal(
        mask_targets(prefix, *_t(masks, gt), mask_size=28).numpy(), got[:, :8])
