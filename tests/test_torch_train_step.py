"""The port's training path as a whole: the ``fpn_mask`` train step against
the JAX package on the CPU.

``fpn_mask`` at full width (ResNet-50-FPN, 256 channels) cut to 128×128,
batch 2, 3 classes, 256/64 train proposals and 32 sampled ROIs, with one JAX
random init carried into the port by the weight bridge, the same synthetic
batch, and the samplers' uniform draws made with ``jax.random`` along the
JAX step's own key splits and handed to the port. Two JAX steps (one
compile) with ``lr_decay_every_iters=1``, so the second runs at a tenth of
the rate on the first step's momentum.

Tolerances: each loss term within 1e-4 relative; each tensor's update
``new − old`` within 0.5% of JAX's largest update of that step, and within
5% of JAX's largest update of that same tensor plus two float32 roundings
of its weights. The two frameworks sum ~60 layers of float32 convolutions in
different orders forward and backward (an activation a rounding away from
zero passes a ReLU in one and not in the other, which moves one channel of
a conv and of its BN bias by a few percent), and the update is a difference
of float32 weights, each rounded at its own size: a BN scale near 1 moves by
about 3e-6 per step in steps of 6e-8.
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
from maskrcnn_tpu_torch.models.backbones.resnet import Norm  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import (  # noqa: E402
    MomentumSGD,
    create_train_state,
    lr_schedule,
    make_optimizer,
)
from maskrcnn_tpu_torch.train.step import SamplerDraws, make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (128, 128)
B = 2
LOSS_RTOL = 1e-4
UPDATE_SHARE = 5e-3  # of JAX's largest update of the step (measured: 1.1e-3)
OWN_SHARE = 5e-2  # of JAX's largest update of the same tensor, beyond
ULPS = 2  # float32 roundings of the tensor's largest weight (measured: 3.1e-2)


def _cfg(lib, **sections):
    base = dict(
        model=dict(n_fg_class=3),
        proposals=dict(n_train_pre_nms=256, n_train_post_nms=64),
        sampler=dict(n_sample=32),
        train=dict(batch_size=B, image_size=HW, lr_decay_every_iters=1),
    )
    for name, changes in sections.items():
        base[name] = {**base.get(name, {}), **changes}
    return lib._rep(lib.fpn_mask(), **base)


def jax_step_draws(state_key, b, n_cand, n_anchor):
    """The uniform priorities JAX's train step draws from ``state_key``
    (``train/step.py``: per-image key pairs, column 0 proposals, column 1
    anchors; each sampler splits its key in two) → (SamplerDraws, next key)."""
    key, new_key = jax.random.split(state_key)
    img_keys = jax.random.split(key, b * 2).reshape(b, 2)

    def pair(k, n):
        k1, k2 = jax.random.split(k)
        return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                         np.asarray(jax.random.uniform(k2, (n,)))])

    return SamplerDraws(
        torch.from_numpy(np.stack([pair(img_keys[i, 0], n_cand) for i in range(b)])),
        torch.from_numpy(np.stack([pair(img_keys[i, 1], n_anchor) for i in range(b)])),
    ), new_key


def _numpy(tree):
    return jax.tree.map(lambda x: np.array(x), jax.device_get(tree))


def _port_model(cfg, variables):
    model = MaskRCNN(cfg, device="cpu", seed=0)
    return load_flax_variables(model, variables)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def run():
    """Two steps of both packages from the same weights, batch and draws."""
    cfg = _cfg(jcfg)
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = _numpy(variables)
    jbatch = JaxData(cfg).batch(0)
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    jstep = jax_make_train_step(cfg, jmodel)
    # the step donates its state: keep each key as plain data
    keys = [np.asarray(jax.random.key_data(jstate.key))]
    jparams, jmetrics = [variables["params"]], []
    for _ in range(2):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, jbatch))
        keys.append(np.asarray(jax.random.key_data(jstate.key)))
        jparams.append(_numpy(jstate.params))
        jmetrics.append({k: float(v) for k, v in m.items()})

    pcfg = _cfg(tcfg)
    model = _port_model(pcfg, variables)
    state = create_train_state(pcfg, model)
    step = make_train_step(pcfg)
    batch = SyntheticDetectionData(pcfg).batch(0)
    n_cand = pcfg.proposals.n_train_post_nms + pcfg.train.max_gt
    n_anchor = sum(h * w for h, w in ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))) * 3
    weights, metrics, lrs = [_snapshot(model)], [], []
    for i in range(2):
        draws, next_key = jax_step_draws(jax.random.wrap_key_data(keys[i]),
                                         B, n_cand, n_anchor)
        assert np.array_equal(jax.random.key_data(next_key), keys[i + 1])
        m = step(state, batch, draws)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        metrics.append({k: float(v) for k, v in m.items()})
        weights.append(_snapshot(model))
    # JAX's parameters in the port's layout, through the same bridge
    jweights = [convert_flax_variables(
        {"params": p, "batch_stats": variables["batch_stats"]}, model)
        for p in jparams]
    return dict(variables=variables, batch=batch, jbatch=jbatch,
                jmetrics=jmetrics, metrics=metrics, jweights=jweights,
                weights=weights, lrs=lrs, state=state)


def _updates(weights, i):
    return {k: (weights[i + 1][k] - weights[i][k]).numpy() for k in weights[0]}


def _assert_updates_match(run, i):
    want, got = _updates(run["jweights"], i), _updates(run["weights"], i)
    largest = max(float(np.abs(w).max()) for w in want.values())
    assert largest > 0
    worst = max(want, key=lambda k: float(np.abs(got[k] - want[k]).max()))
    err = float(np.abs(got[worst] - want[worst]).max())
    assert err <= UPDATE_SHARE * largest, (worst, err, largest)
    eps = float(np.finfo(np.float32).eps)
    for k in want:
        own = float(np.abs(want[k]).max())
        size = float(run["jweights"][i][k].abs().max())
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= OWN_SHARE * own + ULPS * eps * size, (k, err, own, size)
    return want, got, largest


def test_batch_equals_jax_bit_for_bit(run):
    for name, got in run["batch"]._asdict().items():
        want = getattr(run["jbatch"], name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert run["batch"].gt_masks.dtype == np.uint8
    assert run["batch"].gt_valid.sum() >= 2


def test_frozen_bn_affine_is_parameters_with_the_same_state_dict_keys():
    bn = Norm(4)  # frozen unless asked
    assert bn.frozen
    assert sorted(n for n, _ in bn.named_parameters()) == ["bias", "weight"]
    assert sorted(n for n, _ in bn.named_buffers()) == ["running_mean", "running_var"]
    assert sorted(bn.state_dict()) == ["bias", "running_mean", "running_var", "weight"]
    # the same in training and not: statistics stay frozen and unmoved
    x = torch.randn(2, 4, 3, 3)
    with torch.no_grad():
        bn.running_mean.normal_()
        bn.weight.normal_()
    stats = bn.running_mean.clone()
    assert torch.equal(bn(x, train=True), bn(x, train=False))
    assert torch.equal(bn.running_mean, stats)


@pytest.mark.parametrize("i", [0, 1])
def test_loss_breakdown_matches_jax(run, i):
    want, got = run["jmetrics"][i], run["metrics"][i]
    for name in ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
                 "roi_cls_loss", "mask_loss"):
        assert np.isfinite(got[name]) and got[name] > 0, name
        assert abs(got[name] - want[name]) <= LOSS_RTOL * abs(want[name]), (
            name, got[name], want[name])
    # positives are sampled (the GT boxes are candidates) and fill no more
    # than their cap; every slot carrying loss is counted
    assert 2 <= got["n_pos_rois"] <= 16 < got["n_valid_rois"] <= 64


def test_first_step_update_matches_jax(run):
    _assert_updates_match(run, 0)


def test_frozen_bn_scale_and_bias_move_as_in_jax(run):
    """Frozen BN fixes the statistics, not the affine: were the port's BN
    ``weight`` and ``bias`` buffers, they would stay put while JAX updates
    ``scale``/``bias`` with gradient and weight decay."""
    want, got, largest = _assert_updates_match(run, 0)
    bn = [k for k in want if ".bn" in k or "_bn." in k]
    affine = [k for k in bn if k.endswith((".weight", ".bias"))]
    assert len(affine) == 2 * 53
    moved = [k for k in affine if float(np.abs(want[k]).max()) > 0]
    assert len(moved) == len(affine)  # weight decay alone moves every scale
    eps = float(np.finfo(np.float32).eps)
    for k in affine:
        # held to its own update (in ``_assert_updates_match``), under a
        # bound that an error of the update's own size would break
        own = float(np.abs(want[k]).max())
        size = float(run["jweights"][0][k].abs().max())
        assert OWN_SHARE * own + ULPS * eps * size < 0.2 * own, k
        assert float(np.abs(got[k]).max()) > 0, k
    for k in set(bn) - set(affine):  # running statistics stay frozen
        assert float(np.abs(got[k]).max()) == 0.0 == float(np.abs(want[k]).max())


def test_second_step_momentum_and_lr_decay_match_jax(run):
    """Step 1 runs at lr·0.1 (``lr_decay_every_iters=1``) on step 0's
    momentum: without momentum, or without the decay, the update is off by
    far more than the tolerance."""
    want, got, largest = _assert_updates_match(run, 1)
    assert run["lrs"] == pytest.approx([1e-3, 1e-4])
    assert run["state"].step == 2
    first = _updates(run["jweights"], 0)
    k = "head.box.score.weight"
    # the second update is dominated by 0.9 · 0.1 of the first: momentum
    ratio = float(np.abs(want[k]).max() / np.abs(first[k]).max())
    assert 0.05 < ratio < 0.3, ratio


def test_lr_schedule_and_optimizer_settings():
    cfg = _cfg(tcfg, train=dict(lr_decay_every_iters=None, epoch_size=80,
                                lr_decay_every_epochs=2.0, batch_size=4))
    sched, jsched = lr_schedule(cfg), None
    from maskrcnn_tpu.train import lr_schedule as jax_lr_schedule
    jsched = jax_lr_schedule(_cfg(jcfg, train=dict(
        lr_decay_every_iters=None, epoch_size=80, lr_decay_every_epochs=2.0,
        batch_size=4)))
    for step in (0, 39, 40, 79, 80, 200):
        assert sched(step) == pytest.approx(float(jsched(step)), rel=1e-6)
    model = torch.nn.Linear(2, 2)
    opt = make_optimizer(cfg, model)
    group = opt.param_groups[0]
    assert (group["momentum"], group["weight_decay"], group["dampening"],
            group["nesterov"]) == (0.9, 5e-4, 0, False)
    assert len(group["params"]) == 2  # biases decay too
    assert isinstance(opt, torch.optim.SGD)
    # a bf16 buffer is the port's own step, with the same settings
    opt16 = make_optimizer(_cfg(tcfg, train=dict(momentum_dtype="bfloat16")), model)
    assert isinstance(opt16, MomentumSGD) and opt16.momentum_dtype == torch.bfloat16
    assert {k: opt16.param_groups[0][k] for k in ("momentum", "weight_decay")} == {
        "momentum": 0.9, "weight_decay": 5e-4}
    with pytest.raises(ValueError, match="float16"):
        make_optimizer(_cfg(tcfg, train=dict(momentum_dtype="float16")), model)


def _one_update(run, draws=None, seed=None, **sections):
    cfg = _cfg(tcfg, **sections)
    model = _port_model(cfg, run["variables"])
    before = _snapshot(model)
    state = create_train_state(cfg, model, seed)
    batch = SyntheticDetectionData(cfg).batch(0)
    metrics = make_train_step(cfg)(state, batch, draws)
    after = _snapshot(model)
    keys = [k for k, _ in model.named_parameters()]
    vec = torch.cat([(after[k] - before[k]).reshape(-1) for k in keys]).numpy()
    return vec, metrics


def test_grad_accum_matches_full_batch_within_bound(run):
    """``grad_accum_steps=2`` (micro-batch 1) against the port's own full
    batch, same draws: the sampling is split-invariant, so the two differ
    only in that each micro-batch's losses divide by its own valid counts.
    The bound is the JAX package's for this comparison
    (``test_grad_accum_divergence_bounded``): relative L2 of the update
    under 0.35 and cosine over 0.9."""
    cfg = _cfg(tcfg)
    gen = torch.Generator().manual_seed(5)
    draws = SamplerDraws(torch.rand((B, 2, 64 + cfg.train.max_gt), generator=gen),
                         torch.rand((B, 2, 4092), generator=gen))
    full, m1 = _one_update(run, draws)
    acc, m2 = _one_update(run, draws, train=dict(grad_accum_steps=2))
    rel = np.linalg.norm(full - acc) / np.linalg.norm(full)
    cos = float(full @ acc / (np.linalg.norm(full) * np.linalg.norm(acc)))
    assert rel < 0.35 and cos > 0.9, (rel, cos)
    # the same ROIs were sampled, and the terms whose counts are even agree
    assert float(m1["n_valid_rois"]) == float(m2["n_valid_rois"])
    assert float(m1["n_pos_rois"]) == float(m2["n_pos_rois"])
    assert float(m2["rpn_cls_loss"]) == pytest.approx(float(m1["rpn_cls_loss"]),
                                                      rel=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(_cfg(tcfg, train=dict(grad_accum_steps=3)))


def test_generator_draws_are_seeded(run):
    """Without injected draws the step samples from the state's generator:
    one seed gives one update, another seed another."""
    a, _ = _one_update(run, seed=3)
    b, _ = _one_update(run, seed=3)
    c, _ = _one_update(run, seed=4)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("impl", ["gather", "pallas"])
def test_only_the_shared_pool_trains(run, impl):
    """The train step pools through the shared window pool, whose backward
    is the region scatter; the other ROIAlign forms serve and do not train."""
    with pytest.raises(NotImplementedError, match="no backward"):
        _one_update(run, model=dict(roi_align=impl), seed=0)
