"""The single-pool train path (``ops/roi_align.py:_RegionPool``) against the
JAX package on the CPU: forward and feature gradient.

One level of the C4 family (C=1024, and the light head's thin map at
C=490, which the port pads to 512 channels for its kernels) at batch 2, and
the FPN pyramid (C=256). The port's ``"pallas"`` and ``"region"`` forms
(forward kernel and region scatter, here their plain versions) against
JAX's gather form (``multilevel_roi_align``, autodiff) and JAX's Pallas
wrapper in interpret mode (its custom VJP, ``_roi_align_core``), on ROIs
whose windows stay inside the flat buffer: where a window runs past its
end, JAX's interpret path shifts it (``ROADMAP.md`` §C). The gather form
trains through plain autograd. Tolerance: max abs ≤ 1e-4 · max|JAX| for
pools and gradients (float32 sums in different orders).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu.kernels import multilevel_roi_align_pallas  # noqa: E402
from maskrcnn_tpu_torch.kernels import roi_align_cuda  # noqa: E402
from maskrcnn_tpu_torch.ops import roi_align as tra  # noqa: E402

jra = importlib.import_module("maskrcnn_tpu.ops.roi_align")
torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

B = 2
C4_HW = (40, 48)  # a 640×768 image's C4 level
C4_SCALES = (1.0 / 16,)
FPN_STRIDES = (4, 8, 16, 32, 64)


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


def _c4_level(c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, *C4_HW, c)).astype(np.float32)]


def _fpn_levels(seed, h=256, w=320, c=256):
    rng = np.random.default_rng(seed)
    shapes = [(h // s, w // s) for s in FPN_STRIDES[:4]]
    shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    return [rng.normal(size=(B, hh, ww, c)).astype(np.float32) for hh, ww in shapes]


def _rois(feats, scales, n, seed, max_cells=16.0):
    """``n`` ROIs spanning 0.5..``max_cells`` cells of a random level."""
    rng = np.random.default_rng(seed)
    rois, bi, lv = [], [], []
    for _ in range(n):
        level = int(rng.integers(len(feats)))
        hl, wl = feats[level].shape[1:3]
        fh = rng.uniform(0.5, min(max_cells, hl))
        fw = rng.uniform(0.5, min(max_cells, wl))
        fy, fx = rng.uniform(-1, hl - fh + 1), rng.uniform(-1, wl - fw + 1)
        s = 1.0 / scales[level]
        rois.append([fy * s, fx * s, (fy + fh) * s, (fx + fw) * s])
        bi.append(int(rng.integers(B)))
        lv.append(level)
    return (np.array(rois, np.float32), np.array(bi, np.int32),
            np.array(lv, np.int32))


def _inside_buffer(feats, rois, bi, lv, out, scales):
    """ROIs whose pallas-geometry windows end inside the flat buffer."""
    t = [torch.from_numpy(f) for f in feats]
    flat, row_ids, _, bx = tra.pallas_geometry(
        t, torch.from_numpy(rois), torch.from_numpy(bi), torch.from_numpy(lv),
        (out, out), scales)
    ends = row_ids.long().max(dim=1).values + bx.shape[2]
    return (ends <= flat.shape[0]).numpy()


def _port(feats, rois, bi, lv, out, scales, impl, g):
    """(pool, feature gradients) of ``sum(pool · g)``."""
    t = [torch.tensor(f, requires_grad=True) for f in feats]
    pooled = tra.multilevel_roi_align(
        t, torch.from_numpy(rois), torch.from_numpy(bi), torch.from_numpy(lv),
        (out, out), scales, impl=impl)
    (pooled * torch.from_numpy(g)).sum().backward()
    return pooled.detach().numpy(), [x.grad.numpy() for x in t]


def _jax(feats, rois, bi, lv, out, scales, impl, g):
    def pool(fs):
        args = (fs, jnp.asarray(rois), jnp.asarray(bi), jnp.asarray(lv),
                (out, out), scales)
        if impl == "pallas":
            return multilevel_roi_align_pallas(*args, interpret=True)
        return jra.multilevel_roi_align(*args, impl=impl)

    pooled, vjp = jax.vjp(pool, [jnp.asarray(f) for f in feats])
    (grads,) = vjp(jnp.asarray(g))
    return np.asarray(pooled), [np.asarray(x) for x in grads]


def _cotangent(n, out, c, seed):
    return np.random.default_rng(seed).normal(size=(n, out, out, c)).astype(np.float32)


@pytest.mark.parametrize("c", [490, 1024])
@pytest.mark.parametrize("impl", ["pallas", "region"])
def test_single_level_pool_and_gradient_match_jax_gather(c, impl):
    """On one level JAX's ``auto`` is the gather form; the port's window
    forms compute the same pool and, through the region scatter, the same
    feature gradient."""
    feats = _c4_level(c, seed=c)
    rois, bi, lv = _rois(feats, C4_SCALES, 24, seed=1)
    g = _cotangent(24, 7, c, seed=2)
    got, got_g = _port(feats, rois, bi, lv, 7, C4_SCALES, impl, g)
    want, want_g = _jax(feats, rois, bi, lv, 7, C4_SCALES, "gather", g)
    _close(got, want)
    _close(got_g[0], want_g[0])
    assert got_g[0].shape == (B, *C4_HW, c)


@pytest.mark.parametrize("c", [490, 1024])
def test_single_level_pallas_pool_matches_jax_pallas(c):
    """Against JAX's Pallas wrapper (interpret mode) and its custom VJP, on
    the ROIs whose windows stay inside the buffer."""
    feats = _c4_level(c, seed=c + 1)
    rois, bi, lv = _rois(feats, C4_SCALES, 40, seed=3)
    keep = _inside_buffer(feats, rois, bi, lv, 7, C4_SCALES)
    assert 10 <= keep.sum() < len(keep)  # some windows do run past the end
    rois, bi, lv = rois[keep], bi[keep], lv[keep]
    g = _cotangent(len(rois), 7, c, seed=4)
    got, got_g = _port(feats, rois, bi, lv, 7, C4_SCALES, "pallas", g)
    want, want_g = _jax(feats, rois, bi, lv, 7, C4_SCALES, "pallas", g)
    _close(got, want)
    _close(got_g[0], want_g[0])


@pytest.mark.parametrize("impl", ["pallas", "gather"])
def test_fpn_pool_and_gradient_match_jax(impl):
    """FPN heads train through two pools under ``"pallas"`` and
    ``"gather"``: five levels at C=256, 14×14 out, against JAX's same form
    (the pallas one on ROIs whose windows stay inside the buffer)."""
    feats = _fpn_levels(seed=5)
    scales = tuple(1.0 / s for s in FPN_STRIDES)
    rois, bi, lv = _rois(feats, scales, 40, seed=6, max_cells=12.0)
    if impl == "pallas":
        keep = _inside_buffer(feats, rois, bi, lv, 14, scales)
        rois, bi, lv = rois[keep], bi[keep], lv[keep]
        assert len(rois) >= 20
    g = _cotangent(len(rois), 14, 256, seed=7)
    got, got_g = _port(feats, rois, bi, lv, 14, scales, impl, g)
    want, want_g = _jax(feats, rois, bi, lv, 14, scales, impl, g)
    _close(got, want)
    for a, b in zip(got_g, want_g):
        if np.abs(b).max() > 0:
            _close(a, b)
        else:
            assert np.abs(a).max() == 0


def test_thin_map_channels_reach_the_kernels_padded_to_512(monkeypatch):
    """C=490 is no multiple of the kernels' 32 channels (B2) nor of B1's
    vector: the port flattens the level with zero channels up to 512, hands
    both kernel wrappers 512 channels, slices the pool back to 490 and the
    gradient arrives at 490 channels; the padding changes no value."""
    seen = {}
    fwd, bwd = tra.roi_align_fwd, tra.region_scatter

    def spy_fwd(flat, *args):
        seen["fwd"] = tuple(flat.shape)
        return fwd(flat, *args)

    def spy_bwd(d_regs, *args):
        seen["bwd"] = tuple(d_regs.shape)
        return bwd(d_regs, *args)

    monkeypatch.setattr(tra, "roi_align_fwd", spy_fwd)
    monkeypatch.setattr(tra, "region_scatter", spy_bwd)
    feats = _c4_level(490, seed=8)
    rois, bi, lv = _rois(feats, C4_SCALES, 8, seed=9)
    g = _cotangent(8, 7, 490, seed=10)
    got, got_g = _port(feats, rois, bi, lv, 7, C4_SCALES, "pallas", g)
    assert seen["fwd"] == (B * C4_HW[0] * C4_HW[1], 512)
    assert seen["bwd"][0] == 8 and seen["bwd"][3] == 512
    assert got.shape == (8, 7, 7, 490) and got_g[0].shape == (B, *C4_HW, 490)
    # the first 490 channels pool as they would alone
    flat, row_ids, by, bx = tra.pallas_geometry(
        [torch.from_numpy(feats[0])], torch.from_numpy(rois),
        torch.from_numpy(bi), torch.from_numpy(lv), (7, 7), C4_SCALES)
    assert flat.shape[1] == 512 and float(flat[:, 490:].abs().max()) == 0.0
    alone = roi_align_cuda.roi_align_region_plain(
        flat[:, :490].contiguous(), *tra.window_starts(row_ids), by, bx)
    np.testing.assert_array_equal(got, alone.numpy())
    assert tra.kernel_channels(490) == 512 and tra.kernel_channels(1024) == 1024


def test_single_level_region_window_is_the_whole_map():
    """``"region"`` on one level: the window is ``max(H, W) + 3`` rows (x
    folded to a multiple of 8), so no ROI is clamped — the 10 GB train
    tensor at 800×1024 that keeps it to test sizes."""
    feats = [torch.zeros(B, *C4_HW, 32)]
    rois = torch.tensor([[0.0, 0.0, 640.0, 768.0]])
    _, row_ids, by, bx = tra.region_geometry(
        feats, rois, torch.zeros(1, dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), (7, 7), C4_SCALES)
    assert row_ids.shape[1] == by.shape[2] == max(C4_HW) + 3
    assert bx.shape[2] % 8 == 0 and bx.shape[2] >= max(C4_HW) + 3
