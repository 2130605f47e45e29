"""One ``fpn_keypoint`` train step of the port against the JAX package's,
on the CPU.

``fpn_keypoint`` at full width (ResNet-50-FPN, 8 head convs of 256, 17
keypoints, 56² heatmaps) cut to 128×128, batch 2, 256/64 train proposals
and 32 sampled ROIs; one JAX random init carried into the port by the
weight bridge, the same synthetic keypoint batch (equal bit for bit), and
the samplers' uniform draws made along the JAX step's key splits. The
fifth loss term is the keypoint heatmap loss (softmax over 3136 bins a
keypoint), whose gradient reaches the shared pool's backward, the region
scatter's plain version here. Tolerances are those of
``tests/test_torch_train_step.py``'s mask step: each loss term within 1e-3
relative (the keypoint loss sums more terms), each tensor's update within
0.5% of JAX's largest update of the step and 5% of its own plus two float32
roundings of its weights; the two biases that the heatmap softmax cannot
see by their own rule (below).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    init_model,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    load_flax_variables,
)
from test_torch_train_step import (  # noqa: E402
    _assert_updates_match,
    _numpy,
    _snapshot,
    jax_step_draws,
)

torch.set_num_threads(1)

HW = (128, 128)
B = 2
LOSS_RTOL = 1e-3


def _cfg(lib):
    return lib._rep(
        lib.fpn_keypoint(),
        proposals=dict(n_train_pre_nms=256, n_train_post_nms=64),
        sampler=dict(n_sample=32),
        train=dict(batch_size=B, image_size=HW))


@pytest.fixture(scope="module")
def run():
    cfg = _cfg(jcfg)
    jmodel, variables = init_model(cfg, jax.random.key(2))
    variables = _numpy(variables)
    jbatch = JaxData(cfg, seed=3).batch(0)
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    key = np.asarray(jax.random.key_data(jstate.key))
    jstate, m = jax_make_train_step(cfg, jmodel)(
        jstate, jax.tree.map(jnp.asarray, jbatch))
    jmetrics = {k: float(v) for k, v in m.items()}
    jparams = _numpy(jstate.params)

    pcfg = _cfg(tcfg)
    model = load_flax_variables(MaskRCNN(pcfg, device="cpu", seed=0), variables)
    state = create_train_state(pcfg, model)
    batch = SyntheticDetectionData(pcfg, seed=3).batch(0)
    n_cand = pcfg.proposals.n_train_post_nms + pcfg.train.max_gt
    n_anchor = sum(h * w for h, w in ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))) * 3
    draws, _ = jax_step_draws(jax.random.wrap_key_data(key), B, n_cand, n_anchor)
    before = _snapshot(model)
    metrics = {k: float(v) for k, v in make_train_step(pcfg)(state, batch, draws).items()}
    jweights = [convert_flax_variables(
        {"params": p, "batch_stats": variables["batch_stats"]}, model)
        for p in (variables["params"], jparams)]
    return dict(batch=batch, jbatch=jbatch, metrics=metrics, jmetrics=jmetrics,
                weights=[before, _snapshot(model)], jweights=jweights)


def test_keypoint_batch_equals_jax(run):
    got, want = run["batch"], run["jbatch"]
    assert got.gt_masks is None and want.gt_masks is None
    assert got.gt_keypoints.shape == (B, 64, 17, 3)
    for name in ("images", "img_hw", "scale", "gt_boxes", "gt_labels",
                 "gt_valid", "gt_keypoints"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_keypoint_step_losses_match_jax(run):
    got, want = run["metrics"], run["jmetrics"]
    for name in ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
                 "roi_cls_loss", "mask_loss"):
        assert np.isfinite(got[name]) and got[name] > 0, name
        assert abs(got[name] - want[name]) <= LOSS_RTOL * abs(want[name]), (
            name, got[name], want[name])
    # the heatmap loss starts near log(56²): a uniform guess over the bins
    assert 7.5 < got["mask_loss"] < 8.6
    assert 2 <= got["n_pos_rois"] <= 16 < got["n_valid_rois"] <= 64


def test_keypoint_step_update_matches_jax(run):
    """Every tensor as in the mask step but two biases. The transposed
    conv's bias passes through the last 1×1 conv with no ReLU between, so
    it and the last conv's bias only add a constant to all 56² bins of a
    keypoint, which its softmax cannot see: their gradients are rounding
    noise on both sides (a few 1e-11), and each must stay below a millionth
    of the step's largest update instead."""
    unseen = ("head.mask.deconv1.bias", "head.mask.conv2.bias")
    drop = lambda ws: [{k: v for k, v in w.items() if k not in unseen}  # noqa: E731
                       for w in ws]
    want, got, largest = _assert_updates_match(
        dict(run, weights=drop(run["weights"]), jweights=drop(run["jweights"])), 0)
    for ws in (run["weights"], run["jweights"]):
        for k in unseen:
            assert float((ws[1][k] - ws[0][k]).abs().max()) <= 1e-6 * largest, k
    # the keypoint branch trained: every other tensor of it moved
    branch = [k for k in want if k.startswith("head.mask.")]
    assert len(branch) == 2 * 10 - 2  # mask1..mask8, the two kernels
    assert all(float(np.abs(got[k]).max()) > 0 for k in branch)
