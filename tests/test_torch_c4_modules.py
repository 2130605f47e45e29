"""The C4 family's modules against the JAX package on the CPU.

Each JAX module (`C4Backbone` inside the model, `Res5Stage`,
`ThinFeatureMap`, `LightHead` with both `compat_mask_bug` values, `Res5Head`
with frozen and trainable BatchNorm) gets a JAX random init, carried into
the port by the weight bridge, and both run the same numpy inputs at the
presets' own widths: a 128×160 image (C4 is 8×10×1024) and 6 pooled 7×7
ROIs. Tolerance: max abs ≤ 1e-4 · max|JAX| (float32 convolutions summed in
different orders), and running statistics within 1e-5 relative.

Also: single-level anchors and proposals on the C4 grid (3 anchors a
position, scale 8 only, as JAX builds them), the per-class box decode of
the Res5 head, class-aware NMS by coordinate offset, and the weight
bridge's C4 trees both ways.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu.models import anchors_for as jax_anchors_for  # noqa: E402
from maskrcnn_tpu.models import generate_proposals as jax_proposals  # noqa: E402
from maskrcnn_tpu.models.backbones.resnet import Res5Stage as JaxRes5Stage  # noqa: E402
from maskrcnn_tpu.models.heads.light_head import (  # noqa: E402
    LightHead as JaxLightHead,
    ThinFeatureMap as JaxThinFeatureMap,
)
from maskrcnn_tpu.models.heads.res5_head import Res5Head as JaxRes5Head  # noqa: E402
from maskrcnn_tpu.models.maskrcnn import backbone_geometry, pyramid_shapes  # noqa: E402
from maskrcnn_tpu.ops.boxes import clip_boxes as jax_clip_boxes  # noqa: E402
from maskrcnn_tpu.ops.boxes import loc2bbox as jax_loc2bbox  # noqa: E402
from maskrcnn_tpu.ops.nms import batched_nms_padded as jax_batched_nms  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import decode_boxes  # noqa: E402
from maskrcnn_tpu_torch.models.backbones.fpn import build_backbone  # noqa: E402
from maskrcnn_tpu_torch.models.backbones.resnet import Res5Stage  # noqa: E402
from maskrcnn_tpu_torch.models.heads.light_head import (  # noqa: E402
    LightHead,
    ThinFeatureMap,
)
from maskrcnn_tpu_torch.models.heads.res5_head import Res5Head  # noqa: E402
from maskrcnn_tpu_torch.models.init import init_weights  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import (  # noqa: E402
    pyramid_shapes as port_pyramid_shapes,
)
from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals  # noqa: E402
from maskrcnn_tpu_torch.ops.nms import batched_nms_padded  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    export_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (128, 160)
N_CLASS = 4  # 3 foreground classes and background
R = 6


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _cfg(lib, preset, **model):
    return lib._rep(getattr(lib, preset)(), model=dict(n_fg_class=3, **model),
                    train=dict(batch_size=1, image_size=HW))


def _init(module, *inputs, **kw):
    variables = module.init(jax.random.key(0), *(jnp.asarray(x) for x in inputs),
                            **kw)
    return _np(variables)


def _load(port, variables):
    port.load_state_dict(convert_flax_variables(variables, port), strict=True)
    return port.eval()


def _pooled(c, seed=0):
    return np.random.default_rng(seed).normal(size=(R, 7, 7, c)).astype(np.float32)


@pytest.fixture(scope="module")
def c4_pair():
    """The ``c4_res5`` model (C4 backbone, RPN, Res5 head) in both packages
    from one JAX init."""
    jmodel = JaxMaskRCNN(_cfg(jcfg, "c4_res5"))
    dummy = jnp.zeros((1, *HW, 3), jnp.float32)
    variables = _np(jax.jit(lambda k: jmodel.init(
        k, dummy, method=JaxMaskRCNN.init_forward))(jax.random.key(0)))
    model = MaskRCNN(_cfg(tcfg, "c4_res5"), device="cpu", seed=0)
    load_flax_variables(model, variables)
    return jmodel, variables, model


def test_c4_backbone_and_rpn_match_jax(c4_pair):
    jmodel, variables, model = c4_pair
    x = np.random.default_rng(1).uniform(size=(1, *HW, 3)).astype(np.float32)
    feats, locs, scores = jmodel.apply(variables, jnp.asarray(x), False)
    assert [f.shape for f in feats] == [(1, 8, 10, 1024)]
    assert port_pyramid_shapes(_cfg(tcfg, "c4_res5"), HW) == [(8, 10)]
    with torch.no_grad():
        got_feats, got_locs, got_scores = model(torch.from_numpy(x))
    assert len(got_feats) == 1
    _close(got_feats[0], feats[0])
    _close(got_locs, locs)
    _close(got_scores, scores)
    # res4's end: no res5 in the backbone, 1024 channels into the RPN
    assert not any(k.startswith("extractor.resnet.res5") for k in model.state_dict())
    assert model.rpn_head.conv.in_channels == 1024


def test_darknet_backbone_names_its_roadmap_item():
    """ROADMAP A.4's Darknet backbone, which ``build_backbone`` refused
    until it was ported, now builds (its parity tests are
    ``tests/test_torch_darknet_*.py``); a backbone no preset names still
    raises, naming it."""
    backbone = build_backbone("darknet", 256, False, torch.float32)
    assert type(backbone).__name__ == "DarknetBackbone"
    assert MaskRCNN(tcfg.tiny_test(), device="cpu").rpn_head.conv.in_channels == 256
    with pytest.raises(ValueError, match="'resnet101'"):
        build_backbone("resnet101", 256, False, torch.float32)


@pytest.mark.parametrize("frozen", [True, False])
def test_res5_stage_matches_jax(frozen):
    x = _pooled(1024, seed=2)
    jmod = JaxRes5Stage(frozen_bn=frozen)
    variables = _init(jmod, x)
    port = _load(Res5Stage(frozen), variables)
    if frozen:
        want = jmod.apply(variables, jnp.asarray(x), False)
    else:
        want, upd = jmod.apply(variables, jnp.asarray(x), True,
                               mutable=["batch_stats"])
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), not frozen)
    _close(got.permute(0, 2, 3, 1), want)
    assert got.shape == (R, 2048, 7, 7)  # stride 1 throughout
    if not frozen:  # statistics over the ROIs' 7×7 positions
        moved = export_flax_variables(port, variables)["batch_stats"]
        for a, b in zip(jax.tree.leaves(moved), jax.tree.leaves(_np(upd["batch_stats"]))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_thin_feature_map_matches_jax():
    x = np.random.default_rng(3).normal(size=(1, 8, 10, 1024)).astype(np.float32)
    jmod = JaxThinFeatureMap()
    variables = _init(jmod, x)
    port = _load(ThinFeatureMap(), variables)
    want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == (1, 8, 10, 490)
    _close(got, want)
    # no activation after the sum: negative values pass
    assert float(got.min()) < 0


@pytest.mark.parametrize("compat", [False, True])
def test_light_head_matches_jax(compat):
    pooled = _pooled(490, seed=4)
    feat = np.random.default_rng(6).normal(size=(1, 8, 10, 1024)).astype(np.float32)
    jmod = JaxLightHead(N_CLASS, compat_mask_bug=compat)
    # the thin map's parameters exist once it is called, as in the model
    variables = _init(jmod, feat, pooled, method=lambda m, f, p: (
        m.thin_map(f), m(p, p)))
    port = _load(LightHead(N_CLASS, compat), variables)
    locs, scores, masks = jmod.apply(variables, jnp.asarray(pooled),
                                     jnp.asarray(pooled))
    thin = jmod.apply(variables, jnp.asarray(feat), method=JaxLightHead.thin_map)
    with torch.no_grad():
        _close(port.thin_map(torch.from_numpy(feat)), thin)
    with torch.no_grad():
        t = torch.from_numpy(pooled)
        got_locs, got_scores, got_masks = port(t, t)
        labels = torch.tensor([0, 1, 2, 2, 1, 0])
        sel = port.predict_mask(t, labels)
    assert locs.shape == (R, 4) and masks.shape == (R, 14, 14, N_CLASS - 1)
    _close(got_locs, locs)
    _close(got_scores, scores)
    _close(got_masks, masks)
    _close(sel, np.take_along_axis(np.asarray(masks),
                                   labels.numpy()[:, None, None, None], 3)[..., 0])
    # fc reads the pool flattened in HWC order: 24010 = 7·7·490 rows
    fc = variables["params"]["fc"]["kernel"]
    assert fc.shape == (24010, 2048)
    np.testing.assert_array_equal(port.fc.weight.detach().numpy(), fc.T)
    # the reference graph has no conv2..conv4, in flax as in the port
    assert ("conv2" in variables["params"]) == (not compat) == hasattr(port, "conv2")


@pytest.mark.parametrize("frozen", [True, False])
def test_res5_head_matches_jax(frozen):
    pooled = _pooled(1024, seed=5)
    jmod = JaxRes5Head(N_CLASS, frozen_bn=frozen)
    variables = _init(jmod, pooled, pooled)
    port = _load(Res5Head(N_CLASS, frozen), variables)
    t = torch.from_numpy(pooled)
    # train=False: the running statistics, frozen or not
    locs, scores, masks = jmod.apply(variables, jnp.asarray(pooled),
                                     jnp.asarray(pooled), False)
    with torch.no_grad():
        got = port(t, t, False)
        sel = port.predict_mask(t, torch.tensor([2, 1, 0, 0, 1, 2]))
    assert locs.shape == (R, N_CLASS * 4) and masks.shape == (R, 14, 14, N_CLASS - 1)
    for g, w in zip(got, (locs, scores, masks)):
        _close(g, w)
    _close(sel, np.take_along_axis(np.asarray(masks),
                                   np.array([2, 1, 0, 0, 1, 2])[:, None, None, None],
                                   3)[..., 0])
    # train=True: batch statistics over R·7·7 positions when not frozen
    out, upd = jmod.apply(variables, jnp.asarray(pooled), jnp.asarray(pooled),
                          True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(t, t, True)
    for g, w in zip(got, out):
        _close(g, w)
    moved = export_flax_variables(port, variables)["batch_stats"]
    for a, b, c in zip(jax.tree.leaves(moved),
                       jax.tree.leaves(_np(upd["batch_stats"])),
                       jax.tree.leaves(variables["batch_stats"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert frozen == np.array_equal(a, c)  # frozen statistics stay put


def test_new_modules_init_as_flax():
    """lecun-normal kernels (truncated at two deviations, variance 1/fan_in)
    and zero biases, from the port's seeded generator."""
    head = Res5Head(N_CLASS, True)
    init_weights(head, seed=3)
    for name, layer, fan_in in (("conv1", head.conv1, 2048 * 9),
                                ("deconv1", head.deconv1, 2048 * 4)):
        w = layer.weight.detach()
        std = float(w.std()) * np.sqrt(fan_in)
        assert 0.95 < std < 1.05, (name, std)
        assert float(w.abs().max()) <= 2.0 / 0.8796 / np.sqrt(fan_in) + 1e-7
        assert float(layer.bias.detach().abs().max()) == 0.0
    thin = ThinFeatureMap()
    init_weights(thin, seed=3)
    w = thin.conv_ul.weight.detach()
    assert 0.95 < float(w.std()) * np.sqrt(1024 * 15) < 1.05
    assert float(thin.conv_br.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("preset", ["light_head", "c4_res5"])
def test_weight_bridge_carries_the_c4_trees_both_ways(preset):
    jmodel = JaxMaskRCNN(_cfg(jcfg, preset, freeze_bn=False))
    dummy = jnp.zeros((1, *HW, 3), jnp.float32)
    variables = _np(jax.jit(lambda k: jmodel.init(
        k, dummy, method=JaxMaskRCNN.init_forward))(jax.random.key(7)))
    model = MaskRCNN(_cfg(tcfg, preset, freeze_bn=False), device="cpu")
    sd = convert_flax_variables(variables, model)
    assert len(sd) == len(jax.tree.leaves(variables)) == len(model.state_dict())
    load_flax_variables(model, variables)
    back = export_flax_variables(model, variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    # the head's transposed conv is applied flipped, as for the FPN heads
    k = variables["params"]["head"]["deconv1"]["kernel"]
    np.testing.assert_array_equal(model.head.deconv1.weight.detach().numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))


@pytest.mark.parametrize("preset", ["light_head", "c4_res5"])
def test_single_level_anchors_use_scale_8_only(preset):
    """JAX takes ``anchors.scales[:n_levels]``: on the one C4 level only
    scale 8 of (8, 16, 32), 3 anchors a position where chainercv's
    single-level RPN has 9 (``ROADMAP.md`` §C). The port copies it."""
    cfg, pcfg = _cfg(jcfg, preset), _cfg(tcfg, preset)
    shapes = pyramid_shapes(cfg, HW)
    strides = backbone_geometry(cfg)[0]
    assert cfg.anchors.scales == (8.0, 16.0, 32.0) and strides == (16,)
    want = jax_anchors_for(cfg, shapes, strides)
    got = anchors_for(pcfg, shapes, strides)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8 * 10 * 3, 4)
    sizes = np.sqrt((got[:, 2] - got[:, 0]) * (got[:, 3] - got[:, 1]))
    np.testing.assert_allclose(np.unique(np.round(sizes)), [128.0], atol=1.0)
    n_anchor = len(cfg.anchors.ratios)
    assert MaskRCNN(pcfg, device="cpu").rpn_head.score.out_channels == 2 * n_anchor == 6


def test_single_level_proposals_match_jax():
    cfg = _cfg(jcfg, "light_head")
    anchors = jax_anchors_for(cfg, [(8, 10)], (16,))
    rng = np.random.default_rng(8)
    a = anchors.shape[0]
    locs = (rng.normal(size=(2, a, 4)) * 0.2).astype(np.float32)
    scores = rng.normal(size=(2, a, 2)).astype(np.float32)
    scale = np.array([1.0, 0.8], np.float32)
    img_hw = np.array([[128, 160], [100, 150]], np.float32)
    kw = dict(n_pre=120, n_post=32, nms_thresh=0.7, min_size=16.0, n_levels=1)
    want = _np(jax_proposals(jnp.asarray(locs), jnp.asarray(scores),
                             jnp.asarray(anchors), jnp.asarray(scale),
                             jnp.asarray(img_hw), **kw))
    got = generate_proposals(torch.from_numpy(locs), torch.from_numpy(scores),
                             torch.from_numpy(anchors), torch.from_numpy(scale),
                             torch.from_numpy(img_hw), **kw)
    assert want.valid.sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.levels.numpy(), want.levels)
    assert not want.levels.any()  # every ROI on level 0
    np.testing.assert_allclose(got.rois.numpy(), want.rois, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("per_class", [False, True])
def test_box_decode_matches_jax(per_class):
    """The decode of JAX's ``decode_image``: class-agnostic, or per class
    (``(R, n_class·4)`` → ``·std + mean`` → ``loc2bbox`` per class, the
    background column dropped, clipped)."""
    cfg = _cfg(tcfg, "c4_res5" if per_class else "light_head")
    rng = np.random.default_rng(9)
    r, n_fg = 12, 3
    y0, x0 = rng.uniform(0, 100, (2, r))
    rois = np.stack([y0, x0, y0 + rng.uniform(4, 60, r),
                     x0 + rng.uniform(4, 60, r)], 1).astype(np.float32)
    locs = rng.normal(size=(r, (n_fg + 1) * 4 if per_class else 4)).astype(np.float32)
    probs = rng.dirichlet(np.ones(n_fg + 1), r).astype(np.float32)
    rvalid = rng.uniform(size=r) > 0.2
    hw = np.array([120.0, 150.0], np.float32)
    mean = np.asarray(cfg.sampler.loc_normalize_mean, np.float32)
    std = np.asarray(cfg.sampler.loc_normalize_std, np.float32)
    if per_class:
        locs_pc = locs.reshape(r, -1, 4) * std + mean
        boxes = jax.vmap(lambda a, b: jax_loc2bbox(jnp.broadcast_to(a, b.shape), b))(
            jnp.asarray(rois), jnp.asarray(locs_pc))
        want = boxes[:, 1:].transpose(1, 0, 2)
    else:
        want = jnp.broadcast_to(jax_loc2bbox(jnp.asarray(rois),
                                             jnp.asarray(locs * std + mean))[None],
                                (n_fg, r, 4))
    want = np.asarray(jax_clip_boxes(want.reshape(-1, 4), (hw[0], hw[1]))).reshape(n_fg, r, 4)
    boxes, scores, valid = decode_boxes(cfg, torch.from_numpy(rois),
                                        torch.from_numpy(locs),
                                        torch.from_numpy(probs),
                                        torch.from_numpy(rvalid),
                                        torch.from_numpy(hw))
    np.testing.assert_allclose(boxes.numpy(), want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(scores.numpy(), probs[:, 1:].T)
    np.testing.assert_array_equal(valid.numpy(),
                                  rvalid[None] & (probs[:, 1:].T > cfg.eval.score_thresh))
    if per_class:  # each class its own box
        assert float(np.abs(want[0] - want[1]).max()) > 1.0


def test_batched_nms_matches_jax():
    rng = np.random.default_rng(10)
    n = 60
    y0, x0 = rng.uniform(0, 300, (2, n))
    boxes = np.stack([y0, x0, y0 + rng.uniform(20, 80, n),
                      x0 + rng.uniform(20, 80, n)], 1).astype(np.float32)
    boxes[30:] = boxes[:30] + rng.normal(scale=2.0, size=(30, 4)).astype(np.float32)
    scores = rng.uniform(size=n).astype(np.float32)
    cls = rng.integers(0, 3, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.1
    for thresh in (0.3, 0.5):
        want = _np(jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(cls), thresh, 40, jnp.asarray(valid)))
        got = batched_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(cls), thresh, 40,
                                 torch.from_numpy(valid))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    # boxes of different classes never suppress each other: with one class
    # for all, fewer survive
    args = (torch.from_numpy(boxes), torch.from_numpy(scores))
    aware = batched_nms_padded(*args, torch.from_numpy(cls), 0.3, n)
    same = batched_nms_padded(*args, torch.zeros(n, dtype=torch.int32), 0.3, n)
    assert int(aware[1].sum()) > int(same[1].sum())
