"""One C4-family train step against the JAX package on the CPU.

``light_head`` and ``c4_res5`` at full width cut to 192×256 (at 128×160
no 128-px anchor of the one C4 level lies inside the image, so the RPN's
loc loss would be 0 in both packages), batch 2, 3
classes, 256/64 train proposals and 32 sampled ROIs an image (16 for
``c4_res5``, whose res5 and 2048-wide conv run on every ROI), with one
JAX random init carried into the port, the same synthetic batch and the
samplers' uniform draws made along the JAX step's own key splits. Both
pool through the gather form (``roi_align="auto"`` on one level) in two
pools: every slot for the box branch, the positive prefix for the mask
branch. One whole ``make_train_step`` update in each package.

Tolerances are ``test_torch_train_step.py``'s: each loss term within 1e-4
relative; each tensor's update within 0.5% of JAX's largest update of the
step, and within 5% of JAX's largest update of that tensor plus two
float32 roundings of its weights.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as base  # noqa: E402
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

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (192, 256)
B = 2
N_SAMPLE = {"light_head": 32, "c4_res5": 16}


def _cfg(lib, preset):
    return lib._rep(
        getattr(lib, preset)(), model=dict(n_fg_class=3),
        proposals=dict(n_train_pre_nms=256, n_train_post_nms=64),
        sampler=dict(n_sample=N_SAMPLE[preset]),
        train=dict(batch_size=B, image_size=HW, max_gt=4, gt_mask_size=56),
    )


@pytest.fixture(scope="module", params=["light_head", "c4_res5"])
def run(request):
    preset = request.param
    cfg = _cfg(jcfg, preset)
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = base._numpy(variables)
    jbatch = JaxData(cfg).batch(0)
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    key = np.asarray(jax.random.key_data(jstate.key))
    jstate, m = jax_make_train_step(cfg, jmodel)(
        jstate, jax.tree.map(jnp.asarray, jbatch))
    jmetrics = {k: float(v) for k, v in m.items()}
    jparams = base._numpy(jstate.params)

    pcfg = _cfg(tcfg, preset)
    model = MaskRCNN(pcfg, device="cpu", seed=0)
    load_flax_variables(model, variables)
    state = create_train_state(pcfg, model)
    batch = SyntheticDetectionData(pcfg).batch(0)
    n_cand = pcfg.proposals.n_train_post_nms + pcfg.train.max_gt
    draws, _ = base.jax_step_draws(jax.random.wrap_key_data(key), B, n_cand,
                                   12 * 16 * 3)
    before = base._snapshot(model)
    metrics = {k: float(v) for k, v in
               make_train_step(pcfg)(state, batch, draws).items()}
    jweights = [convert_flax_variables(
        {"params": p, "batch_stats": variables["batch_stats"]}, model)
        for p in (variables["params"], jparams)]
    return dict(preset=preset, jbatch=jbatch, batch=batch, jmetrics=jmetrics,
                metrics=metrics, jweights=jweights,
                weights=[before, base._snapshot(model)], model=model)


def test_batch_equals_jax(run):
    for name, got in run["batch"]._asdict().items():
        want = getattr(run["jbatch"], name)
        if want is None:
            assert got is None, name
            continue
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_losses_match_jax(run):
    want, got = run["jmetrics"], run["metrics"]
    for name in ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
                 "roi_cls_loss", "mask_loss"):
        assert np.isfinite(got[name]) and got[name] > 0, name
        assert abs(got[name] - want[name]) <= base.LOSS_RTOL * abs(want[name]), (
            name, got[name], want[name])
    cap = N_SAMPLE[run["preset"]] // 4
    assert 2 <= got["n_pos_rois"] <= B * cap < got["n_valid_rois"]


def test_update_matches_jax(run):
    want, got, _ = base._assert_updates_match(run, 0)
    # the head's every parameter moves: the mask convs feed the deconv
    # (compat_mask_bug=False), and per-class locs reach every class row
    head = [k for k in want if k.startswith("head.") and "running" not in k]
    assert len(head) > 10
    for k in head:
        assert float(np.abs(got[k]).max()) > 0, k
    if run["preset"] == "light_head":
        assert any(k.startswith("head.conv4") for k in head)
        assert any(k.startswith("head.thin.conv_ur") for k in head)
    else:
        assert run["model"].head.cls_loc.weight.shape[0] == 16


def test_res5_head_statistics_move_only_in_head_full():
    """With trainable BatchNorm (``freeze_bn=False``) JAX's ``head_train``
    reaches the Res5 head through ``head_box``/``head_mask``, which pass no
    ``train`` flag: the head normalises by its running statistics and never
    moves them during a train step (``ROADMAP.md`` §C). Only ``head_full``
    passes ``train``. The port does the same, and ``head_full(train=True)``
    moves the statistics as JAX's does (within 1e-5 relative)."""
    from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN
    from maskrcnn_tpu_torch.utils.convert_flax import export_flax_variables

    hw = (128, 160)
    cfg = jcfg._rep(jcfg.c4_res5(), model=dict(n_fg_class=3, freeze_bn=False))
    pcfg = tcfg._rep(tcfg.c4_res5(), model=dict(n_fg_class=3, freeze_bn=False))
    jmodel = JaxMaskRCNN(cfg)
    variables = base._numpy(jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1, *hw, 3)), method=JaxMaskRCNN.init_forward))(
            jax.random.key(2)))
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(1, 8, 10, 1024)).astype(np.float32)]
    rois_bn = np.array([[[8.0, 8.0, 100.0, 120.0], [20.0, 30.0, 60.0, 90.0],
                         [0.0, 0.0, 127.0, 159.0]]], np.float32)
    levels_bn = np.zeros((1, 3), np.int32)
    _, jtrain = jmodel.apply(variables, [jnp.asarray(f) for f in feats],
                             jnp.asarray(rois_bn), jnp.asarray(levels_bn), 2,
                             mutable=["batch_stats"], method=JaxMaskRCNN.head_train)
    args = (jnp.asarray(rois_bn[0]), jnp.zeros(3, jnp.int32), jnp.zeros(3, jnp.int32))
    _, jfull = jmodel.apply(variables, [jnp.asarray(f) for f in feats], *args, True,
                            mutable=["batch_stats"], method=JaxMaskRCNN.head_full)

    def head_stats(tree):
        return jax.tree.leaves(base._numpy(tree)["head"])

    unmoved = head_stats(variables["batch_stats"])
    for a, b in zip(head_stats(jtrain["batch_stats"]), unmoved):
        np.testing.assert_array_equal(a, b)

    model = MaskRCNN(pcfg, device="cpu", seed=0)
    load_flax_variables(model, variables)
    t_feats = [torch.from_numpy(f) for f in feats]
    with torch.enable_grad():
        model.head_train(t_feats, torch.from_numpy(rois_bn),
                         torch.from_numpy(levels_bn), 2)
    for a, b in zip(head_stats(export_flax_variables(model, variables)["batch_stats"]),
                    unmoved):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        model.head_full(t_feats, torch.from_numpy(rois_bn[0]),
                        torch.zeros(3, dtype=torch.int32),
                        torch.zeros(3, dtype=torch.int32), True)
    moved = head_stats(export_flax_variables(model, variables)["batch_stats"])
    for a, b, c in zip(moved, head_stats(jfull["batch_stats"]), unmoved):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert not np.array_equal(a, c)
