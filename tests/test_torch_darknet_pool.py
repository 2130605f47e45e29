"""The single pools on the Darknet level against the JAX package on the CPU.

One 256-wide stride-16 level of a 256×320 image (16×20, ``darknet_keypoint``'s
bucket) at batch 2, 7×7 (box) and 14×14 (mask or keypoint) out. The port's
``"pallas"`` form (the forward kernel's window geometry, the region scatter
backward; here their plain versions) against JAX's Pallas wrapper in
interpret mode with its custom VJP, and the port's ``"gather"`` form (the
presets' default on one level, autograd) against JAX's. JAX's interpret
mode shifts a window that runs past the end of the flat buffer where the
TPU kernel reads zero (``ROADMAP.md`` §C): the JAX side gets a zero level
past its pyramid, so no window shifts. Tolerances: forward within 1e-5 of
max |JAX|, feature gradient within 1e-4 of max |JAX| (float32 sums in
other orders).

The pallas window at C=256 is ``t_eff = 24`` cells (``t_span=20`` widened
so that x starts quantise to 4, ``pallas_geometry``), wider than the whole
16×20 level: no ROI inside the image is clamped, and the pallas pool is
the gather pool on every one of them, the full image included (where the
C4 family's 20- and 22-cell windows clamp wide ROIs, ``ROADMAP.md`` §C).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu.kernels import multilevel_roi_align_pallas  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.ops import roi_align as tra  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import SamplerDraws, make_train_step  # noqa: E402

jra = importlib.import_module("maskrcnn_tpu.ops.roi_align")
torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

B = 2
HW = (16, 20)  # the Darknet level of a 256x320 image
SCALES = (1.0 / 16,)
C = 256
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def _level(seed):
    return [np.random.default_rng(seed).normal(size=(B, *HW, C)).astype(np.float32)]


def _rois(n, seed, max_px=320.0):
    """Proposal-like ROIs of a 256×320 image: log-uniform sides from 16 px
    to ``max_px``, aspect 1/3 to 3, some partly off the image."""
    rng = np.random.default_rng(seed)
    side = np.exp(rng.uniform(np.log(16), np.log(max_px), n))
    ar = np.exp(rng.uniform(np.log(1 / 3), np.log(3), n))
    bh, bw = np.minimum(side * np.sqrt(ar), 256), np.minimum(side / np.sqrt(ar), 320)
    y0, x0 = rng.uniform(-8, 256 - bh / 2), rng.uniform(-8, 320 - bw / 2)
    rois = np.stack([y0, x0, y0 + bh, x0 + bw], 1).astype(np.float32)
    return rois, rng.integers(0, B, n).astype(np.int32), np.zeros(n, np.int32)


def _span(rois):
    return ((rois[:, 2:] - rois[:, :2]) * SCALES[0]).max(axis=1)


def _port(feats, rois, bi, lv, out, impl, g):
    t = [torch.tensor(f, requires_grad=True) for f in feats]
    pooled = tra.multilevel_roi_align(
        t, torch.from_numpy(rois), torch.from_numpy(bi), torch.from_numpy(lv),
        (out, out), SCALES, impl=impl)
    (pooled * torch.from_numpy(g)).sum().backward()
    return pooled.detach().numpy(), t[0].grad.numpy()


def _jax(feats, rois, bi, lv, out, impl, g):
    def pool(fs):
        if impl == "pallas":  # a zero level past the pyramid: no shifted window
            zeros = jnp.zeros((B, 64, 64, C), fs[0].dtype)
            return multilevel_roi_align_pallas(
                list(fs) + [zeros], jnp.asarray(rois), jnp.asarray(bi),
                jnp.asarray(lv), (out, out), SCALES + (1.0,), interpret=True)
        return jra.multilevel_roi_align(fs, jnp.asarray(rois), jnp.asarray(bi),
                                        jnp.asarray(lv), (out, out), SCALES,
                                        impl="gather")

    pooled, vjp = jax.vjp(pool, [jnp.asarray(f) for f in feats])
    (grads,) = vjp(jnp.asarray(g))
    return np.asarray(pooled), np.asarray(grads[0])


@pytest.mark.parametrize("out", [7, 14])
@pytest.mark.parametrize("impl", ["pallas", "gather"])
def test_single_pool_and_gradient_match_jax(impl, out):
    """Each form against JAX's same form, on ROIs up to the whole image."""
    feats = _level(seed=out)
    rois, bi, lv = _rois(40, seed=out + 1)
    g = np.random.default_rng(out + 2).normal(size=(40, out, out, C)).astype(np.float32)
    got, got_g = _port(feats, rois, bi, lv, out, impl, g)
    want, want_g = _jax(feats, rois, bi, lv, out, impl, g)
    _close(got, want, FWD_RTOL)
    _close(got_g, want_g, GRAD_RTOL)
    assert got_g.shape == (B, *HW, C)


def test_pallas_equals_gather_on_every_roi_of_the_level():
    """The 24-cell window holds every ROI of a 256×320 image, up to the
    whole image: pallas and gather pool the same, at 7×7 and 14×14."""
    feats = [torch.from_numpy(_level(seed=20)[0])]
    rois, bi, lv = _rois(200, seed=21, max_px=600.0)
    rois = np.concatenate([rois, [[0, 0, 256, 320], [-4, -4, 256, 320]]]).astype(np.float32)
    bi, lv = np.append(bi, [0, 1]).astype(np.int32), np.append(lv, [0, 0]).astype(np.int32)
    assert float(_span(rois).max()) >= 20
    for out in (7, 14):
        args = (torch.from_numpy(rois), torch.from_numpy(bi),
                torch.from_numpy(lv), (out, out), SCALES)
        _, _, by, bx = tra.pallas_geometry(feats, *args)
        assert by.shape[2] == bx.shape[2] == 24
        _close(tra.multilevel_roi_align(feats, *args, impl="pallas").numpy(),
               tra.multilevel_roi_align(feats, *args, impl="gather").numpy(),
               FWD_RTOL)


def test_tiny_test_step_trains_through_the_region_pool_as_through_gather(
        monkeypatch):
    """``tiny_test`` at 128×160: its 8×10 level fits the 24-cell window, so
    one step under ``"pallas"`` (two ``_RegionPool`` calls: the box pool and
    the mask pool) gives the losses and update of the step under
    ``"gather"`` from the same weights and draws, within 1e-4 relative and
    1e-4 of the step's largest update."""
    calls = []
    pool = tra._RegionPool.apply

    def count(*args):
        calls.append(args[0].shape)
        return pool(*args)

    monkeypatch.setattr(tra._RegionPool, "apply", count)
    gen = torch.Generator().manual_seed(0)
    base = tcfg.tiny_test()
    draws = SamplerDraws(torch.rand((B, 2, 64 + 8), generator=gen),
                         torch.rand((B, 2, 8 * 10 * 3), generator=gen))
    runs = {}
    for impl in ("gather", "pallas"):
        cfg = tcfg._rep(base, model=dict(roi_align=impl))
        state = create_train_state(cfg, MaskRCNN(cfg, device="cpu", seed=0))
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        metrics = make_train_step(cfg)(
            state, SyntheticDetectionData(cfg, seed=1).batch(0), draws)
        runs[impl] = ({k: float(v) for k, v in metrics.items()},
                      {k: v - before[k] for k, v in state.model.state_dict().items()})
    assert len(calls) == 2
    (want, want_up), (got, got_up) = runs["gather"], runs["pallas"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1e-30), (k, got[k], v)
    largest = max(float(u.abs().max()) for u in want_up.values())
    for k, u in want_up.items():
        assert float((got_up[k] - u).abs().max()) <= 1e-4 * largest, k
