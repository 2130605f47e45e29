"""Port models (maskrcnn_tpu_torch.models) against the JAX package.

One JAX random init of ``fpn_mask`` (3 classes) goes through the weight
bridge into the port; both then run the same numpy inputs: ResNet-50-FPN
and the RPN head on a 64×64 image, and the FPN mask head (box branch, full
and class-gathered mask branch) on pooled features. Tolerance: max abs
≤ 1e-4 · max|ref| — the two frameworks sum the ~50 convolutions in
different orders.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (64, 64)


def _cfg(lib):
    return lib._rep(lib.fpn_mask(), model=dict(n_fg_class=3),
                    train=dict(batch_size=1, image_size=HW))


@pytest.fixture(scope="module")
def pair():
    """(jax module, numpy variables, port model with the same weights)."""
    jmodel = JaxMaskRCNN(_cfg(jcfg))
    dummy = jnp.zeros((1, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy,
                                         method=JaxMaskRCNN.init_forward))
    variables = jax.tree.map(np.asarray, jax.device_get(init(jax.random.key(0))))
    model = MaskRCNN(_cfg(tcfg), device="cpu", seed=0)
    load_flax_variables(model, variables)
    return jmodel, variables, model


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def test_config_presets_equal():
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    for name in jcfg.PRESETS:
        assert (dataclasses.asdict(tcfg.PRESETS[name]())
                == dataclasses.asdict(jcfg.PRESETS[name]())), name
    assert dataclasses.asdict(tcfg.tiny_test()) == dataclasses.asdict(jcfg.tiny_test())


def test_weight_bridge_consumes_every_jax_leaf(pair):
    _, variables, model = pair
    n_leaves = len(jax.tree.leaves(variables))
    sd = convert_flax_variables(variables, model)
    assert len(sd) == n_leaves == len(model.state_dict())
    # the layout rules, leaf by leaf
    p = variables["params"]
    k = p["extractor"]["resnet"]["conv1"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["extractor.resnet.conv1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    fc1 = p["head"]["box"]["fc1"]["kernel"]  # (in, out)
    np.testing.assert_array_equal(sd["head.box.fc1.weight"].numpy(), fc1.T)
    dk = p["head"]["mask"]["deconv1"]["kernel"]  # (2, 2, c, o), applied flipped
    np.testing.assert_array_equal(sd["head.mask.deconv1.weight"].numpy()[:, :, 0, 1],
                                  dk[1, 0])
    np.testing.assert_array_equal(sd["head.mask.conv2_weight"].numpy(),
                                  p["head"]["mask"]["conv2_kernel"].T)
    bs = variables["batch_stats"]["extractor"]["resnet"]["bn1"]["BatchNorm_0"]
    np.testing.assert_array_equal(sd["extractor.resnet.bn1.running_var"].numpy(),
                                  bs["var"])


def test_weight_bridge_rejects_missing_and_extra_leaves(pair):
    _, variables, model = pair
    extra = {**variables, "params": {**variables["params"],
                                     "stray": {"kernel": np.zeros((1, 1))}}}
    with pytest.raises(KeyError, match="stray"):
        convert_flax_variables(extra, model)
    head = dict(variables["params"]["head"])
    head.pop("box")
    missing = {**variables, "params": {**variables["params"], "head": head}}
    with pytest.raises(KeyError, match="head.box.fc1.weight"):
        convert_flax_variables(missing, model)


def test_port_random_init_is_seeded_and_complete():
    a = MaskRCNN(_cfg(tcfg), device="cpu", seed=3).state_dict()
    b = MaskRCNN(_cfg(tcfg), device="cpu", seed=3).state_dict()
    c = MaskRCNN(_cfg(tcfg), device="cpu", seed=4).state_dict()
    for key in a:
        assert torch.isfinite(a[key]).all(), key
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    w = "head.box.fc1.weight"
    assert not torch.equal(a[w], c[w])
    # lecun-normal: variance 1 / fan_in
    assert abs(float(a[w].std()) * np.sqrt(a[w].shape[1]) - 1.0) < 0.05
    assert float(a["head.box.fc1.bias"].abs().max()) == 0.0
    assert float(a["extractor.resnet.bn1.running_var"].min()) == 1.0


def test_backbone_and_rpn_match_jax(pair):
    jmodel, variables, model = pair
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (1, *HW, 3)).astype(np.uint8)
    want_f, want_l, want_s = jmodel.apply(variables, jnp.asarray(images), False)
    with torch.no_grad():
        got_f, got_l, got_s = model(torch.from_numpy(images))
    assert len(got_f) == len(want_f) == 5
    for g, w in zip(got_f, want_f):
        _close(g.numpy(), w)
    _close(got_l.numpy(), want_l)
    _close(got_s.numpy(), want_s)


def test_fpn_mask_head_matches_jax(pair):
    jmodel, variables, model = pair
    rng = np.random.RandomState(1)
    r = 5
    pooled_box = rng.randn(r, 7, 7, 256).astype(np.float32)
    pooled_mask = rng.randn(r, 14, 14, 256).astype(np.float32)
    class_idx = np.array([0, 2, 1, 2, 0], np.int32)
    j_locs, j_scores, j_masks = jmodel.apply(
        variables, jnp.asarray(pooled_box), jnp.asarray(pooled_mask),
        method=lambda m, pb, pm: m.head(pb, pm))
    j_sel = jmodel.apply(
        variables, jnp.asarray(pooled_mask), jnp.asarray(class_idx),
        method=lambda m, pm, ci: m.head.predict_mask(pm, ci))
    with torch.no_grad():
        locs, scores, masks = model.head(torch.from_numpy(pooled_box),
                                         torch.from_numpy(pooled_mask))
        sel = model.head.predict_mask(torch.from_numpy(pooled_mask),
                                      torch.from_numpy(class_idx))
    _close(locs.numpy(), j_locs)
    _close(scores.numpy(), j_scores)
    assert masks.shape == (r, 28, 28, 3)
    _close(masks.numpy(), j_masks)
    assert sel.shape == (r, 28, 28)
    _close(sel.numpy(), j_sel)
    # the gathered channel is the full output's channel
    _close(sel.numpy(), masks.numpy()[np.arange(r), :, :, class_idx])
