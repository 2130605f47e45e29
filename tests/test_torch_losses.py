"""The port's losses (``maskrcnn_tpu_torch.train.losses``) against the JAX
package: the same numpy inputs through both, values and input gradients.
Tolerance 1e-5 relative (float32 sums of a few thousand terms)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu.train import losses as JL  # noqa: E402
from maskrcnn_tpu_torch.train import losses as TL  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

RTOL = 1e-5


def _both(jax_fn, torch_fn, diff, *others):
    """Value and gradient with respect to ``diff`` of both versions."""
    want, jgrad = jax.value_and_grad(jax_fn)(
        jnp.asarray(diff), *(jnp.asarray(o) for o in others))
    x = torch.from_numpy(diff).requires_grad_()
    got = torch_fn(x, *(torch.from_numpy(o) for o in others))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-4,
                               atol=1e-7)
    return float(got.detach())


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_smooth_l1_matches_jax_on_both_branches(sigma):
    rng = np.random.RandomState(0)
    x = rng.uniform(-2, 2, (200, 4)).astype(np.float32)
    t = rng.uniform(-2, 2, (200, 4)).astype(np.float32)
    got = TL.smooth_l1(torch.from_numpy(x), torch.from_numpy(t), sigma).numpy()
    want = np.asarray(JL.smooth_l1(jnp.asarray(x), jnp.asarray(t), sigma))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    inner = np.abs(x - t) < 1.0 / sigma ** 2
    assert inner.any() and (~inner).any()


@pytest.mark.parametrize("sigma,labels", [
    (3.0, "rpn"), (1.0, "head"), (1.0, "all_ignored")])
def test_fast_rcnn_loc_loss_matches_jax(sigma, labels):
    rng = np.random.RandomState(1)
    n = 300
    pred = rng.randn(n, 4).astype(np.float32)
    gt = rng.randn(n, 4).astype(np.float32)
    lab = {"rpn": rng.choice([-1, 0, 1], n, p=[0.8, 0.15, 0.05]),
           "head": rng.choice([-1, 0, 1, 2, 3], n),
           "all_ignored": np.full(n, -1)}[labels].astype(np.int32)
    got = _both(lambda p, g, l: JL.fast_rcnn_loc_loss(p, g, l, sigma),
                lambda p, g, l: TL.fast_rcnn_loc_loss(p, g, l, sigma),
                pred, gt, lab)
    assert (got == 0.0) == (labels == "all_ignored")  # the count floors at 1


@pytest.mark.parametrize("n_class", [2, 81])
def test_softmax_ce_ignore_matches_jax(n_class):
    rng = np.random.RandomState(2)
    n = 400
    logits = (rng.randn(n, n_class) * 3).astype(np.float32)
    lab = rng.randint(-1, n_class, n).astype(np.int32)
    got = _both(JL.softmax_ce_ignore, TL.softmax_ce_ignore, logits, lab)
    assert got > 0 and (lab == -1).any()
    # ignored rows carry no gradient
    x = torch.from_numpy(logits).requires_grad_()
    TL.softmax_ce_ignore(x, torch.from_numpy(lab)).backward()
    assert float(x.grad[torch.from_numpy(lab) == -1].abs().max()) == 0.0


@pytest.mark.parametrize("form", ["gathered", "stack"])
def test_sigmoid_mask_loss_matches_jax(form):
    rng = np.random.RandomState(3)
    n, s, n_fg = 12, 28, 5
    labels = rng.randint(0, n_fg + 1, n).astype(np.int32)
    is_pos = (labels > 0) & (rng.rand(n) < 0.8)
    targets = (rng.rand(n, s, s) < 0.4).astype(np.float32)
    shape = (n, s, s) if form == "gathered" else (n, s, s, n_fg)
    logits = (rng.randn(*shape) * 4).astype(np.float32)
    got = _both(JL.sigmoid_mask_loss, TL.sigmoid_mask_loss, logits, targets,
                labels, is_pos)
    assert got > 0
    if form == "stack":  # the stack form picks channel label − 1
        sel = logits[np.arange(n), :, :, np.clip(labels - 1, 0, n_fg - 1)]
        want = TL.sigmoid_mask_loss(*(torch.from_numpy(a) for a in
                                      (sel, targets, labels, is_pos)))
        np.testing.assert_allclose(got, float(want), rtol=1e-6)
    none = np.zeros(n, bool)  # no positive: zero, not NaN
    assert float(TL.sigmoid_mask_loss(*(torch.from_numpy(a) for a in
                                        (logits, targets, labels, none)))) == 0.0


def test_select_roi_locs_matches_jax():
    rng = np.random.RandomState(4)
    agnostic = rng.randn(9, 4).astype(np.float32)
    per_class = rng.randn(9, 6 * 4).astype(np.float32)
    labels = rng.randint(-1, 6, 9).astype(np.int32)
    for locs in (agnostic, per_class):
        got = TL.select_roi_locs(torch.from_numpy(locs), torch.from_numpy(labels))
        want = JL.select_roi_locs(jnp.asarray(locs), jnp.asarray(labels))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TL.LossBreakdown._fields == JL.LossBreakdown._fields
