"""One train step of each Darknet preset against the JAX package on the CPU.

``tiny_test`` at its own 128×160, batch 2 (512/64 proposals, 32 sampled
ROIs an image, the mask head on the one level), and ``darknet_keypoint``
at its own 256×320 cut to batch 2 (12000/2000 proposals over its 960
anchors, 256 sampled ROIs an image, the 20-keypoint head), with one JAX
random init carried into the port, the same synthetic batch and the
samplers' uniform draws made along the JAX step's own key splits. Both
pool by gather on the one level in two pools (every slot for the box
branch, the positive prefix for the mask or keypoint branch).

The Darknet BatchNorms always train, whatever ``model.freeze_bn`` says
(here the presets' ``True``): features are normalised by batch
statistics, and a small random init is chaotic under them, so the RPN's
shared conv is zeroed in both packages and both propose and sample the
same ROIs (``tests/test_torch_trainable_bn.py``'s recipe), and a single
step is compared. Tolerances: each loss term within 1e-3 relative; each
tensor's update within 0.5% of JAX's largest update of the step and within
5% of JAX's largest update of that tensor plus two float32 roundings of
its weights, except where the true gradient is zero: Darknet's conv
biases, which the BatchNorm on batch statistics subtracts again (their
updates are float32 rounding of sums that cancel, up to 6.8e-5 of the
step's largest update in either package; each must stay below 1e-3 of
it), and for the keypoint head the two biases its softmax cannot see
(``tests/test_torch_keypoint_step.py``: below 1e-6 of it). The Darknet
running statistics move as JAX's within 1e-5 of max(1, each tensor's
largest value).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as base  # noqa: E402
from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.models.rpn import generate_proposals as jax_proposals  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    init_model,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN, pyramid_shapes  # noqa: E402
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

B = 2
LOSS_RTOL = 1e-3
STATS_RTOL = 1e-5
BN_BIAS_SHARE = 1e-3  # a Darknet conv bias's rounding-only update, of the
#   step's largest update
SOFTMAX_SHARE = 1e-6  # the keypoint head's two softmax-blind biases, same
LOSSES = ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
          "roi_cls_loss", "mask_loss")


def _cfg(lib, preset):
    return lib._rep(lib.PRESETS[preset](), train=dict(batch_size=B))


def _quiet_rpn(variables):
    conv = variables["params"]["rpn_head"]["conv"]
    conv["kernel"] = np.zeros_like(conv["kernel"])
    conv["bias"] = np.zeros_like(conv["bias"])
    return variables


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.startswith("extractor.") and k.endswith(("running_mean",
                                                          "running_var"))}


@pytest.fixture(scope="module", params=["tiny_test", "darknet_keypoint"])
def run(request):
    preset = request.param
    cfg = _cfg(jcfg, preset)
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = _quiet_rpn(base._numpy(variables))
    jbatch = JaxData(cfg).batch(0)
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    key = np.asarray(jax.random.key_data(jstate.key))
    jstate, m = jax_make_train_step(cfg, jmodel)(
        jstate, jax.tree.map(jnp.asarray, jbatch))
    jmetrics = {k: float(v) for k, v in m.items()}
    jvars = {"params": base._numpy(jstate.params),
             "batch_stats": base._numpy(jstate.batch_stats)}

    pcfg = _cfg(tcfg, preset)
    model = load_flax_variables(MaskRCNN(pcfg, device="cpu", seed=0), variables)
    state = create_train_state(pcfg, model)
    batch = SyntheticDetectionData(pcfg).batch(0)
    (h, w), = pyramid_shapes(pcfg, pcfg.train.image_size)
    n_cand = pcfg.proposals.n_train_post_nms + pcfg.train.max_gt
    draws, _ = base.jax_step_draws(jax.random.wrap_key_data(key), B, n_cand,
                                   h * w * 3)
    before = base._snapshot(model)
    metrics = {k: float(v) for k, v in
               make_train_step(pcfg)(state, batch, draws).items()}
    jweights = [convert_flax_variables(v, model) for v in (variables, jvars)]
    return dict(preset=preset, cfg=pcfg, jbatch=jbatch, batch=batch,
                jmetrics=jmetrics, metrics=metrics, jweights=jweights,
                weights=[before, base._snapshot(model)])


def test_batch_equals_jax(run):
    for name, got in run["batch"]._asdict().items():
        want = getattr(run["jbatch"], name)
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_losses_match_jax(run):
    want, got = run["jmetrics"], run["metrics"]
    for name in LOSSES:
        assert np.isfinite(got[name]) and got[name] > 0, name
        assert abs(got[name] - want[name]) <= LOSS_RTOL * abs(want[name]), (
            name, got[name], want[name])
    assert 2 <= got["n_pos_rois"] < got["n_valid_rois"]


def test_update_matches_jax(run):
    """Parameters move as JAX's (the running statistics are held below)."""
    unseen = {f"extractor.conv{i}.conv0.bias": BN_BIAS_SHARE for i in range(1, 6)}
    if run["preset"] == "darknet_keypoint":
        unseen.update({"head.mask.deconv1.bias": SOFTMAX_SHARE,
                       "head.mask.conv2.bias": SOFTMAX_SHARE})
    params = {k for k in run["weights"][0]
              if not k.endswith(("running_mean", "running_var"))}
    sub = {key: [{k: v for k, v in w.items() if k in params - set(unseen)}
                 for w in run[key]] for key in ("weights", "jweights")}
    want, got, largest = base._assert_updates_match(sub, 0)
    for k, share in unseen.items():
        for w in ("weights", "jweights"):
            noise = float((run[w][1][k] - run[w][0][k]).abs().max())
            assert noise <= share * largest, (k, w, noise, largest)
    moved = [k for k in want if k.startswith("extractor.")
             and float(np.abs(got[k]).max()) > 0]
    assert len(moved) == 5 * 3  # every conv kernel and BatchNorm affine


def test_darknet_statistics_move_under_freeze_bn(run):
    """``freeze_bn=True`` in both presets, yet every Darknet BatchNorm moves
    its running statistics in the step, as JAX's do."""
    assert run["cfg"].model.freeze_bn
    before, after = (_stats(w) for w in run["weights"])
    want = _stats(run["jweights"][1])
    assert len(before) == 10
    for k in before:
        assert not torch.equal(before[k], after[k]), k
        err = float((after[k] - want[k]).abs().max())
        assert err <= STATS_RTOL * max(1.0, float(want[k].abs().max())), (k, err)


def test_two_thousand_slots_over_960_anchors_as_jax():
    """``darknet_keypoint`` at 256×320 has 16×20×3 = 960 anchors under a
    12000/2000 train budget: both take ``min(n_pre, A)`` and return 2000
    slots, the valid ones first, in the same order and padding."""
    cfg = tcfg.darknet_keypoint()
    shapes = pyramid_shapes(cfg, (256, 320))
    anchors = anchors_for(cfg, shapes, (16,))
    assert anchors.shape == (960, 4)
    rng = np.random.default_rng(0)
    locs = rng.normal(0, 0.2, (B, 960, 4)).astype(np.float32)
    scores = rng.normal(0, 1, (B, 960, 2)).astype(np.float32)
    scale = np.ones(B, np.float32)
    img_hw = np.array([[256, 320], [200, 300]], np.float32)
    args = dict(n_pre=12000, n_post=2000, nms_thresh=0.7, min_size=16.0,
                n_levels=1)
    want = jax_proposals(jnp.asarray(locs), jnp.asarray(scores),
                         jnp.asarray(anchors), jnp.asarray(scale),
                         jnp.asarray(img_hw), **args)
    got = generate_proposals(torch.from_numpy(locs), torch.from_numpy(scores),
                             torch.from_numpy(anchors), torch.from_numpy(scale),
                             torch.from_numpy(img_hw), **args)
    assert got.rois.shape == (B, 2000, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    n = got.valid.sum(dim=1)
    assert (n > 50).all() and (n < 960).all()
    assert not got.valid[:, int(n.max()):].any()  # valid slots come first
    np.testing.assert_array_equal(got.levels.numpy(), np.asarray(want.levels))
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
