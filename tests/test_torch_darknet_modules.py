"""The Darknet family's modules in the port against the JAX package on the
CPU: ``ConvBN`` and ``DarknetBackbone``, the facade's widths on the one
256-wide level, the weight bridge both ways, and the CLIs' class count of
``tiny_test``.

The backbone gets one flax random init with its BatchNorms' scale, bias
and running statistics drawn at random too, carried into the port by the
weight bridge, and seeded images. Tolerances (float32): features within
1e-5 of max |JAX|; the running statistics one train forward moves within
1e-6 of max(1, the tensor's largest value) (measured 5.5e-7 on a variance
of 0.5). Both sum the same 3×3 convolutions
in other orders; the BatchNorms' statistics are float32 means over a
batch, flax's fast variance ``E[x²] − E[x]²`` in both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.models.backbones.fpn import (  # noqa: E402
    ConvBN as JaxConvBN,
    DarknetBackbone as JaxDarknet,
)
from maskrcnn_tpu.train import init_model  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.models.backbones.fpn import (  # noqa: E402
    ConvBN,
    DarknetBackbone,
    build_backbone,
)
from maskrcnn_tpu_torch.models.maskrcnn import (  # noqa: E402
    MaskRCNN,
    backbone_channels,
    pyramid_shapes,
)
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    _flatten,
    convert_flax_variables,
    export_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

B = 2
FEATURE_RTOL = 1e-5
STATS_RTOL = 1e-6


def _numpy(tree):
    return jax.tree.map(lambda x: np.array(x), jax.device_get(tree))


def _randomize_norms(variables, seed):
    """Draw every BatchNorm's scale, bias, mean and variance at random, so
    that the running statistics and the affine map matter."""
    rng = np.random.default_rng(seed)
    out = _numpy(variables)
    for path, x in _flatten(out):
        leaf = path[-1]
        if "Norm_0" not in path and "BatchNorm_0" not in path:
            continue
        node = out
        for name in path[:-1]:
            node = node[name]
        if leaf in ("scale", "var"):
            node[leaf] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        else:
            node[leaf] = rng.normal(0, 0.2, x.shape).astype(np.float32)
    return out


class _Holder(torch.nn.Module):
    """A module with the backbone under ``extractor``, the bridge's prefix."""

    def __init__(self, extractor):
        super().__init__()
        self.extractor = extractor


def _images(hw, seed):
    return np.random.default_rng(seed).uniform(0, 1, (B, *hw, 3)).astype(np.float32)


def _close(got, want, rtol, floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(float(np.abs(want).max()), floor), (
        err, float(np.abs(want).max()))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("hw", [(64, 96), (128, 160)])
def test_darknet_backbone_matches_jax(hw, train):
    x = _images(hw, seed=hw[0] + train)
    jmod = JaxDarknet()
    variables = _randomize_norms(jmod.init(jax.random.key(1), jnp.asarray(x)),
                                 seed=hw[1])
    tree = {k: {"extractor": v} for k, v in variables.items()}
    if train:
        out, mut = jmod.apply(variables, jnp.asarray(x), True,
                              mutable=["batch_stats"])
        want_stats = {"params": variables["params"],
                      "batch_stats": _numpy(mut["batch_stats"])}
    else:
        out = jmod.apply(variables, jnp.asarray(x), False)
    want = np.asarray(out[0])
    assert want.shape == (B, hw[0] // 16, hw[1] // 16, 256)

    holder = _Holder(DarknetBackbone())
    holder.load_state_dict(convert_flax_variables(tree, holder))
    with torch.no_grad():
        got = holder.extractor(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last), train)
    assert len(got) == 1
    _close(got[0].permute(0, 2, 3, 1).numpy(), want, FEATURE_RTOL)
    if train:
        moved = convert_flax_variables(
            {k: {"extractor": v} for k, v in want_stats.items()}, holder)
        sd = holder.state_dict()
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 10
        for k in stats:
            _close(sd[k].numpy(), moved[k].numpy(), STATS_RTOL, 1.0)
            assert not torch.equal(sd[k], convert_flax_variables(tree, holder)[k]), k
    else:  # the running statistics stay where they were
        before = convert_flax_variables(tree, holder)
        for k, v in holder.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_conv_bn_trains_its_norm_whatever_freeze_bn_says():
    """One ``ConvBN`` against flax's: output and moved statistics; its
    BatchNorm is ``Norm(frozen=False)`` and ``build_backbone`` gives
    the same under ``freeze_bn=True``."""
    x = np.random.default_rng(3).normal(size=(B, 12, 16, 8)).astype(np.float32)
    jmod = JaxConvBN(32)
    variables = _randomize_norms(jmod.init(jax.random.key(2), jnp.asarray(x)), 4)
    out, mut = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    mod = ConvBN(8, 32)
    sd = {"conv0.weight": torch.from_numpy(
              variables["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()),
          "conv0.bias": torch.from_numpy(variables["params"]["Conv_0"]["bias"])}
    bn_p = variables["params"]["Norm_0"]["BatchNorm_0"]
    bn_s = variables["batch_stats"]["Norm_0"]["BatchNorm_0"]
    sd.update({"bn0.weight": torch.from_numpy(bn_p["scale"]),
               "bn0.bias": torch.from_numpy(bn_p["bias"]),
               "bn0.running_mean": torch.from_numpy(bn_s["mean"]),
               "bn0.running_var": torch.from_numpy(bn_s["var"])})
    mod.load_state_dict(sd)
    assert not mod.bn0.frozen
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2), True)
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(out), FEATURE_RTOL)
    new = mut["batch_stats"]["Norm_0"]["BatchNorm_0"]
    _close(mod.bn0.running_mean.numpy(), new["mean"], STATS_RTOL, 1.0)
    _close(mod.bn0.running_var.numpy(), new["var"], STATS_RTOL, 1.0)
    backbone = build_backbone("darknet", 64, True, torch.float32)
    assert isinstance(backbone, DarknetBackbone)
    assert all(not m.bn0.frozen for m in backbone.children())


def test_max_pool_floors_odd_sizes_as_flax():
    """flax's ``max_pool`` is VALID: an odd side loses its last row."""
    x = np.random.default_rng(5).uniform(size=(1, 50, 70, 3)).astype(np.float32)
    jmod = JaxDarknet()
    variables = _numpy(jmod.init(jax.random.key(0), jnp.asarray(x)))
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False)[0])
    holder = _Holder(DarknetBackbone())
    holder.load_state_dict(convert_flax_variables(
        {k: {"extractor": v} for k, v in variables.items()}, holder))
    with torch.no_grad():
        got = holder.extractor(torch.from_numpy(x).permute(0, 3, 1, 2), False)[0]
    assert want.shape == (1, 3, 4, 256)
    _close(got.permute(0, 2, 3, 1).numpy(), want, FEATURE_RTOL)


def test_remat_gives_the_same_gradients_and_moves_statistics_once():
    torch.manual_seed(0)
    plain, remat = DarknetBackbone(), DarknetBackbone(remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.rand(B, 3, 64, 96)
    grads = []
    for mod in (plain, remat):
        mod(x, True)[0].square().sum().backward()
        grads.append({k: p.grad.clone() for k, p in mod.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5, atol=1e-6)
    for k, v in plain.state_dict().items():
        torch.testing.assert_close(remat.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("preset", ["tiny_test", "darknet_keypoint"])
def test_facade_takes_the_darknet_level_width(preset):
    """The RPN and the FPN heads read the one 256-wide stride-16 level,
    whatever ``fpn_channels`` says (64 under ``tiny_test``)."""
    cfg = tcfg.PRESETS[preset]()
    model = MaskRCNN(cfg, device="cpu")
    assert backbone_channels(cfg) == 256
    assert isinstance(model.extractor, DarknetBackbone)
    assert model.rpn_head.conv.in_channels == 256
    assert model.head.box.conv1.in_channels == 256
    assert model.head.mask.mask1.in_channels == 256
    assert pyramid_shapes(cfg, cfg.train.image_size) == [
        (cfg.train.image_size[0] // 16, cfg.train.image_size[1] // 16)]
    with torch.no_grad():
        feats = model.extract(torch.zeros(1, *cfg.train.image_size, 3,
                                          dtype=torch.uint8))
    assert feats[0].shape == (1, *pyramid_shapes(cfg, cfg.train.image_size)[0], 256)


@pytest.mark.parametrize("preset", ["tiny_test", "darknet_keypoint"])
def test_flax_tree_round_trips_bit_for_bit(preset):
    """flax tree → port → flax tree gives back every leaf, the Darknet
    BatchNorms' scale, bias, mean and variance among them."""
    cfg = jcfg.PRESETS[preset]()
    _, variables = init_model(cfg, jax.random.key(0))
    variables = _randomize_norms(variables, seed=7)
    model = MaskRCNN(tcfg.PRESETS[preset](), device="cpu")
    load_flax_variables(model, variables)
    back = export_flax_variables(model, variables)
    leaves = dict(_flatten(variables))
    got = dict(_flatten(back))
    assert leaves.keys() == got.keys()
    darknet = [p for p in leaves if p[1] == "extractor"]
    assert len(darknet) == 5 * 6
    for p, x in leaves.items():
        assert got[p].dtype == x.dtype and np.array_equal(got[p], x), p


def test_tiny_test_keeps_its_three_classes_without_a_label_file():
    """The CLIs' label default skips ``tiny_test``, as the JAX CLIs do
    (``cli/train.py:164-166``): 3 classes, no names."""
    from maskrcnn_tpu_torch.cli import train as train_cli

    cfg, names = train_cli.build_config("tiny_test", None, [])
    assert cfg.model.n_fg_class == 3 and names is None
    cfg, names = train_cli.build_config("darknet_keypoint", None, [])
    assert cfg.model.n_fg_class == 1 and names is None
