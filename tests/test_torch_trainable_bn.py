"""Trainable BatchNorm (``model.freeze_bn=False``) in the port against the
JAX package on the CPU.

The setting of every quality run of the JAX package: the backbone's
BatchNorms normalise by the batch statistics in training and move their
running statistics (flax ``batch_stats``) by ``0.9·running + 0.1·batch``.

- One BatchNorm, strict: the port's :class:`Norm` against the JAX package's
  ``Norm`` (flax ``nn.BatchNorm``), frozen and trainable, training and not,
  float32 and bfloat16: output, gradients of input, scale and bias, and the
  moved running statistics, within 2e-5 of their size in float32 (the fast
  variance cancels 9 bits of a channel with std 0.1 about a mean of 2),
  a bf16 rounding of the output and 1e-2 for its gradients in bf16.
- The train step: ``fpn_mask`` at full width cut to 128×128, batch 2, 3
  classes, two float32 steps of both packages from one JAX random init and
  the same sampler draws (``tests/test_torch_train_step.py``'s set-up and
  helpers), with the RPN's shared conv zeroed in both so that both propose
  and sample the same ROIs (:func:`_quiet_rpn`). Batch statistics make the
  step chaotic at this size: rounding differences grow through 53
  batch-normalisations (JAX's float32 means round coarser than the port's,
  and a channel of res5 holds 32 values), and near-tied proposals would
  reorder. The tolerances are set from the measured distances: first-step
  loss terms within 3e-4 relative (measured 1.5e-4), running statistics
  within 1e-3 of each tensor's largest value (9e-5), the update within 10%
  of its largest entry (3.4%) with a cosine above 0.99 (0.9986); the
  second step's loss within 3% (measured 0.6%: the first updates differ as
  above), and its statistics chained from the first step's by the port's
  own forward, exactly.
- Gradient accumulation (micro-batch 1) chains the statistics from one
  micro-batch to the next, as JAX's scan carries them, checked against
  JAX's backbone forward applied micro-batch after micro-batch;
  ``model.remat`` gives the same step and moves the statistics once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as base  # noqa: E402
from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.models.backbones.resnet import Norm as JaxNorm  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    init_model,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.backbones.resnet import Norm  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    export_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

B = base.B
LOSS_RTOL = 3e-4  # first step, each term (measured 1.5e-4)
STATS_RTOL = 1e-3  # of each statistic tensor's largest value (measured 9e-5)
UPDATE_SHARE = 0.1  # of the largest entry of the first update (measured 0.034)
UPDATE_COS = 0.99  # of the whole first update (measured 0.9986)
NORM_RTOL = 2e-5  # one float32 BatchNorm: E[x²] − E[x]² of a channel with
#   std 0.1 about a mean of 2 loses 9 bits (measured 2.3e-6 of the largest)
SECOND_LOSS_RTOL = 3e-2  # the total loss of the second step (measured 6e-3)


def _cfg(lib, **sections):
    model = {"freeze_bn": False, **sections.pop("model", {})}
    return base._cfg(lib, model=dict(n_fg_class=3, **model), **sections)


@pytest.fixture(scope="module")
def run():
    """Two steps of both packages with trainable BN, from the same weights,
    batch and draws."""
    cfg = _cfg(jcfg)
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = _quiet_rpn(base._numpy(variables))
    jbatch = JaxData(cfg).batch(0)
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    jstep = jax_make_train_step(cfg, jmodel)
    keys = [np.asarray(jax.random.key_data(jstate.key))]
    jvars, jmetrics = [variables], []
    for _ in range(2):
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, jbatch))
        keys.append(np.asarray(jax.random.key_data(jstate.key)))
        jvars.append({"params": base._numpy(jstate.params),
                      "batch_stats": base._numpy(jstate.batch_stats)})
        jmetrics.append({k: float(v) for k, v in m.items()})

    pcfg = _cfg(tcfg)
    model = base._port_model(pcfg, variables)
    state = create_train_state(pcfg, model)
    step = make_train_step(pcfg)
    batch = SyntheticDetectionData(pcfg).batch(0)
    n_cand = pcfg.proposals.n_train_post_nms + pcfg.train.max_gt
    n_anchor = sum(h * w for h, w in ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))) * 3
    weights, metrics, exported, draws = [base._snapshot(model)], [], [], []
    for i in range(2):
        d, _ = base.jax_step_draws(jax.random.wrap_key_data(keys[i]), B,
                                   n_cand, n_anchor)
        draws.append(d)
        metrics.append({k: float(v) for k, v in step(state, batch, d).items()})
        weights.append(base._snapshot(model))
        exported.append(export_flax_variables(model, variables))
    jweights = [convert_flax_variables(v, model) for v in jvars]
    return dict(variables=variables, jvars=jvars, jmetrics=jmetrics,
                metrics=metrics, jweights=jweights, weights=weights,
                exported=exported, draws=draws, jmodel=jmodel, batch=batch)


def _quiet_rpn(variables):
    """Zero the RPN's shared 3×3 conv: every anchor then scores the same
    and its boxes are the anchors moved by the loc biases, in both
    packages, so both propose and sample the same ROIs at every step. With
    batch statistics the backbone's features differ between the packages
    by float32 rounding amplified through 53 batch-normalisations of a
    random init, enough to reorder near-tied proposals and sample other
    ROIs; the features still reach every loss through the ROI head, and the
    conv, whose ReLU passes no gradient at 0, stays zero."""
    conv = variables["params"]["rpn_head"]["conv"]
    conv["kernel"] = np.zeros_like(conv["kernel"])
    conv["bias"] = np.zeros_like(conv["bias"])
    return variables


def _stat_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def _model(cfg):
    return MaskRCNN(cfg, device="cpu", seed=0)


def test_every_batchnorm_is_trainable():
    norms = [m for m in _model(_cfg(tcfg)).modules() if isinstance(m, Norm)]
    assert len(norms) == 53 and not any(m.frozen for m in norms)
    frozen = [m for m in _model(base._cfg(tcfg)).modules() if isinstance(m, Norm)]
    assert len(frozen) == 53 and all(m.frozen for m in frozen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frozen,train", [(False, True), (False, False),
                                          (True, True)])
def test_norm_matches_the_jax_norm(frozen, train, dtype):
    """One BatchNorm on (2, 5, 3, 16) NHWC values with a mean far from 0:
    outputs, the three gradients and the moved statistics."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 3, 16) * rng.uniform(0.1, 3, 16) + 2.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    mean, var = rng.randn(16).astype(np.float32), rng.uniform(0.5, 2, 16).astype(np.float32)
    ct = rng.randn(*x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xq = np.asarray(jnp.asarray(x).astype(jdt).astype(jnp.float32))  # the input dtype

    jnorm = JaxNorm(frozen, jdt)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}

    def f(x_, params):
        out, mut = jnorm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x_.astype(jdt), train, mutable=["batch_stats"])
        return (out.astype(jnp.float32) * ct).sum(), (out, mut)

    (_, (jout, jmut)), (jgx, jgp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(xq), variables["params"])

    norm = Norm(16, frozen, tdt)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        norm.running_mean.copy_(torch.from_numpy(mean))
        norm.running_var.copy_(torch.from_numpy(var))
    xt = torch.from_numpy(xq).permute(0, 3, 1, 2).to(tdt).requires_grad_()
    out = norm(xt, train)
    assert out.dtype == tdt
    (out.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()

    def close(got, want, rel):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        err = float(np.abs(np.asarray(got, np.float32) - want).max())
        assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))

    bf16 = dtype == "bfloat16"
    close(out.float().permute(0, 2, 3, 1).detach().numpy(), jout,
          8e-3 if bf16 else NORM_RTOL)
    grad_tol = 1e-2 if bf16 else NORM_RTOL
    close(xt.grad.float().permute(0, 2, 3, 1).numpy(), jgx, grad_tol)
    close(norm.weight.grad.numpy(), jgp["BatchNorm_0"]["scale"], grad_tol)
    close(norm.bias.grad.numpy(), jgp["BatchNorm_0"]["bias"], grad_tol)
    stats = jmut["batch_stats"]["BatchNorm_0"]
    close(norm.running_mean.numpy(), stats["mean"], NORM_RTOL)
    close(norm.running_var.numpy(), stats["var"], NORM_RTOL)
    moved = not (frozen or not train)
    assert moved == (not np.array_equal(norm.running_mean.numpy(), mean))


def test_first_step_losses_match_jax(run):
    want, got = run["jmetrics"][0], run["metrics"][0]
    for name in ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
                 "roi_cls_loss", "mask_loss"):
        assert np.isfinite(got[name]) and got[name] > 0, name
        assert abs(got[name] - want[name]) <= LOSS_RTOL * abs(want[name]), (
            name, got[name], want[name])


def test_first_step_update_matches_jax(run):
    want, got = base._updates(run["jweights"], 0), base._updates(run["weights"], 0)
    keys = [k for k in want if "running" not in k]
    largest = max(float(np.abs(want[k]).max()) for k in keys)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in keys)
    assert worst <= UPDATE_SHARE * largest, (worst, largest)
    w = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    g = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    cos = float(w @ g / (np.linalg.norm(w) * np.linalg.norm(g)))
    assert cos > UPDATE_COS, cos


def test_second_step_loss_matches_jax(run):
    want, got = run["jmetrics"][1], run["metrics"][1]
    assert all(np.isfinite(v) for v in got.values())
    assert abs(got["loss"] - want["loss"]) <= SECOND_LOSS_RTOL * want["loss"]
    assert got["loss"] < run["metrics"][0]["loss"]


def test_first_step_statistics_match_jax(run):
    """The step moves every running statistic, as JAX's ``batch_stats``,
    compared in the flax tree the port exports."""
    keys = _stat_keys(run["weights"][0])
    assert len(keys) == 2 * 53
    moved = [k for k in keys
             if not torch.equal(run["weights"][1][k], run["weights"][0][k])]
    assert moved == keys
    got = jax.tree.leaves(run["exported"][0]["batch_stats"])
    want = jax.tree.leaves(run["jvars"][1]["batch_stats"])
    assert len(got) == len(want) == 2 * 53
    for g, w in zip(got, want):
        err = float(np.abs(g - w).max())
        assert err <= STATS_RTOL * float(np.abs(w).max()), (err, float(np.abs(w).max()))


def test_second_step_chains_the_statistics(run):
    """The second step's statistics are the first step's moved once more by
    the batch statistics of the second step's forward: the backbone in
    training mode on the weights after the first step."""
    model = _model(_cfg(tcfg))
    model.load_state_dict(run["weights"][1])
    with torch.no_grad():
        model.extract(torch.from_numpy(run["batch"].images), train=True)
    after = model.state_dict()
    for k in _stat_keys(after):
        assert torch.equal(after[k], run["weights"][2][k]), k
        assert not torch.equal(after[k], run["weights"][1][k]), k


def test_export_inverts_the_bridge(run):
    """The port's state back into the flax tree it came from, leaf for leaf
    (kernels, the flipped transposed conv, the class-gathered conv)."""
    model = base._port_model(_cfg(tcfg), run["variables"])
    back = export_flax_variables(model, run["variables"])
    flat_in = jax.tree_util.tree_leaves_with_path(run["variables"])
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, x), (_, y) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(x, y, err_msg=str(path))


def _one_step(run, **sections):
    cfg = _cfg(tcfg, **sections)
    model = base._port_model(cfg, run["variables"])
    before = base._snapshot(model)
    state = create_train_state(cfg, model)
    metrics = make_train_step(cfg)(state, run["batch"], run["draws"][0])
    return model, before, base._snapshot(model), metrics


def test_grad_accum_chains_the_statistics(run):
    """``grad_accum_steps=2``: micro-batch 0 moves the statistics, and
    micro-batch 1 moves them on from there (JAX's scan carry), checked
    against JAX's backbone forward in training mode applied image by
    image."""
    model, before, after, _ = _one_step(run, train=dict(grad_accum_steps=2))
    images = jnp.asarray(run["batch"].images)
    params = run["variables"]["params"]
    fwd = jax.jit(lambda v, x: run["jmodel"].apply(
        v, x, True, mutable=["batch_stats"])[1]["batch_stats"])
    stats = run["variables"]["batch_stats"]
    for i in range(B):
        stats = fwd({"params": params, "batch_stats": stats}, images[i:i + 1])
    last_only = fwd(run["variables"], images[B - 1:B])
    want = convert_flax_variables({"params": params, "batch_stats": base._numpy(stats)},
                                  model)
    other = convert_flax_variables(
        {"params": params, "batch_stats": base._numpy(last_only)}, model)
    for k in _stat_keys(after):
        scale = float(want[k].abs().max())
        assert float((after[k] - want[k]).abs().max()) <= STATS_RTOL * scale, k
    # the chain is neither the last micro-batch's update alone nor the
    # full batch's
    k = "extractor.resnet.bn1.running_mean"
    scale = float(want[k].abs().max())
    assert float((want[k] - other[k]).abs().max()) > 10 * STATS_RTOL * scale
    assert float((after[k] - run["weights"][1][k]).abs().max()) > 10 * STATS_RTOL * scale


def test_remat_gives_the_same_step_and_moves_the_statistics_once(run):
    plain, before, want, m_plain = _one_step(run)
    remat, _, got, m_remat = _one_step(run, model=dict(remat=True))
    assert remat.extractor.remat and not plain.extractor.remat
    for name, v in m_plain.items():
        assert float(m_remat[name]) == float(v), name
    for k in want:
        assert torch.equal(got[k], want[k]), k
    k = "extractor.resnet.bn1.running_mean"
    assert float((want[k] - before[k]).abs().max()) > 0
