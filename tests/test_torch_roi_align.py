"""Port ROIAlign (maskrcnn_tpu_torch.ops.roi_align) against the JAX package.

Same numpy inputs through both: region geometry parameters, the plain
region pool (what the CUDA kernel's wrapper runs on CPU tensors) against
JAX's region and gather forms, and the buffer-end case where the JAX
Pallas stand-in ``_interpret_forward`` shifts its window.
Tolerance: max abs ≤ 1e-4 · max|ref| (f32, different summation order).
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu_torch.ops import roi_align as tra  # noqa: E402

# the JAX package's ops/__init__ re-exports a function named roi_align
jra = importlib.import_module("maskrcnn_tpu.ops.roi_align")
torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

STRIDES = (4, 8, 16, 32, 64)
SCALES = tuple(1.0 / s for s in STRIDES)


def _pyramid(rng, b, h, w, c=256):
    shapes = [(h // s, w // s) for s in STRIDES[:4]]
    shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    return [rng.randn(b, hh, ww, c).astype(np.float32) for hh, ww in shapes]


def _rois(rng, feats, n_exact=40, n_thin=6, n_off=6):
    """Boxes sized in their level's frame: ``n_exact`` within the exact
    window span, ``n_thin`` long thin boxes (window clamp), ``n_off``
    partly off the map."""
    b = feats[0].shape[0]
    rois, levels = [], []
    for kind, n in (("exact", n_exact), ("thin", n_thin), ("off", n_off)):
        for _ in range(n):
            lv = rng.randint(0, len(feats))
            hl, wl = feats[lv].shape[1:3]
            if kind == "exact":
                fh, fw = rng.uniform(0.5, min(14.0, hl)), rng.uniform(0.5, min(14.0, wl))
                fy, fx = rng.uniform(0, hl - fh), rng.uniform(0, wl - fw)
            elif kind == "thin":
                fh, fw = rng.uniform(0.5, 2.0), rng.uniform(24.0, 40.0)
                if rng.rand() < 0.5:
                    fh, fw = fw, fh
                fy, fx = rng.uniform(-2, hl - 2), rng.uniform(-2, wl - 2)
            else:
                fh, fw = rng.uniform(2.0, 10.0), rng.uniform(2.0, 10.0)
                fy = rng.choice([-fh / 2, hl - fh / 2])
                fx = rng.choice([-fw / 2, wl - fw / 2])
            s = STRIDES[lv]
            rois.append([fy * s, fx * s, (fy + fh) * s, (fx + fw) * s])
            levels.append(lv)
    n = len(rois)
    kinds = np.array(["exact"] * n_exact + ["thin"] * n_thin + ["off"] * n_off)
    return (np.array(rois, np.float32), rng.randint(0, b, n).astype(np.int32),
            np.array(levels, np.int32), kinds)


def _jax(feats, rois, bi, lv, out_size, impl):
    return np.asarray(jra.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(bi),
        jnp.asarray(lv), out_size, SCALES[:len(feats)], impl=impl))


def _port(feats, rois, bi, lv, out_size, impl):
    return tra.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(bi), torch.from_numpy(lv), out_size,
        SCALES[:len(feats)], impl=impl).numpy()


def _close(got, want):
    tol = 1e-4 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("geometry", ["region", "pallas"])
@pytest.mark.parametrize("hw", [(256, 512), (256, 320)])  # fold 8 / fold 1
def test_region_params_match_jax(geometry, hw):
    rng = np.random.RandomState(1)
    feats = _pyramid(rng, 2, *hw, c=256)
    rois, bi, lv, _ = _rois(rng, feats)
    b, c = 2, 256
    shapes = np.array([f.shape[1:3] for f in feats], np.int32)
    if geometry == "region":
        t = 20
        fold = 8 if all(int(w) % 8 == 0 for w in shapes[:, 1]) else 1
        tx = -(-(t + fold - 1) // fold) * fold if fold > 1 else t
        kw = dict(x_align=fold, t_span_x=tx)
        strides = shapes[:, 1]
    else:  # multilevel_roi_align_pallas's geometry
        n_half = -(-c // 128)
        a = 8 // math.gcd(n_half, 8)
        t = -(-(20 + a - 1) // a) * a
        strides = np.array([-(-int(w) // a) * a for w in shapes[:, 1]], np.int32)
        kw = dict(x_align=a, row_strides=strides)
    offsets = np.concatenate([[0], np.cumsum(shapes[:, 0].astype(np.int64)
                                             * strides * b)[:-1]])
    # origin="box": the window shared by the two pools of the train path
    for out_size, origin in (((7, 7), "sample"), ((14, 14), "sample"),
                             ((14, 14), "box")):
        want = jra.region_params(shapes, offsets, jnp.asarray(rois),
                                 jnp.asarray(bi), jnp.asarray(lv), out_size,
                                 SCALES, 2, t, origin=origin, **kw)
        got = tra.region_params(shapes, offsets, torch.from_numpy(rois),
                                torch.from_numpy(bi), torch.from_numpy(lv),
                                out_size, SCALES, 2, t, origin=origin, **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    # the port's own geometry functions agree with the arguments above
    make = tra.region_geometry if geometry == "region" else tra.pallas_geometry
    flat, row_ids, by, _ = make(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
        torch.from_numpy(bi), torch.from_numpy(lv), (7, 7), SCALES)
    assert flat.shape == (int(offsets[-1] + shapes[-1, 0] * strides[-1] * b), c)
    assert by.shape[-1] == t
    np.testing.assert_array_equal(row_ids.numpy(), np.asarray(jra.region_params(
        shapes, offsets, jnp.asarray(rois), jnp.asarray(bi), jnp.asarray(lv),
        (7, 7), SCALES, 2, t, **kw)[0]))


@pytest.mark.parametrize("out_size", [(7, 7), (14, 14)])
@pytest.mark.parametrize("hw", [(256, 512), (256, 320)])
def test_plain_region_pool_matches_jax(out_size, hw):
    rng = np.random.RandomState(2)
    feats = _pyramid(rng, 2, *hw)
    rois, bi, lv, kinds = _rois(rng, feats)
    got = _port(feats, rois, bi, lv, out_size, "region")
    _close(got, _jax(feats, rois, bi, lv, out_size, "region"))
    # thin boxes exceed the window and get the clamped interpolation; the
    # others are exact and equal the pointwise gather form
    gather = _jax(feats, rois, bi, lv, out_size, "gather")
    exact = kinds != "thin"
    _close(got[exact], gather[exact])
    _close(_port(feats, rois, bi, lv, out_size, "gather"), gather)


def test_pallas_geometry_matches_region_within_span():
    rng = np.random.RandomState(3)
    feats = _pyramid(rng, 2, 256, 512)
    rois, bi, lv, kinds = _rois(rng, feats)
    exact = kinds != "thin"
    for out_size in ((7, 7), (14, 14)):
        got = _port(feats, rois, bi, lv, out_size, "pallas")
        _close(got[exact], _jax(feats, rois, bi, lv, out_size, "region")[exact])


def test_buffer_end_roi_matches_gather():
    """A ROI at the bottom-right corner of the last level of the last image:
    its window runs past the end of the flat pyramid. The port reads zero
    there (as the TPU kernel does) and matches the gather form; JAX's
    ``_interpret_forward`` clamps the window start instead and lands on the
    wrong pixels (recorded in ROADMAP.md §C, not fixed in the JAX package)."""
    from maskrcnn_tpu.kernels import multilevel_roi_align_pallas

    rng = np.random.RandomState(0)
    b, c = 2, 256
    feats = [rng.randn(b, 32, 32, c).astype(np.float32),
             rng.randn(b, 13, 16, c).astype(np.float32)]
    scales = (0.25, 0.125)
    rois = np.array([[70.0, 90.0, 103.0, 127.0]], np.float32)
    bi = np.array([b - 1], np.int32)
    lv = np.array([1], np.int32)
    j = [jnp.asarray(f) for f in feats]
    want = np.asarray(jra.multilevel_roi_align(
        j, jnp.asarray(rois), jnp.asarray(bi), jnp.asarray(lv), (7, 7), scales,
        impl="gather"))
    t = [torch.from_numpy(f) for f in feats]
    for impl in ("region", "pallas"):
        got = tra.multilevel_roi_align(
            t, torch.from_numpy(rois), torch.from_numpy(bi),
            torch.from_numpy(lv), (7, 7), scales, impl=impl).numpy()
        _close(got, want)
    shifted = np.asarray(multilevel_roi_align_pallas(
        j, jnp.asarray(rois), jnp.asarray(bi), jnp.asarray(lv), (7, 7), scales,
        interpret=True))
    # 3.78 max abs at this seed; the region form is within 3e-7
    assert float(np.abs(shifted - want).max()) > 3.0


def test_plain_kernel_version_reads_zero_past_end():
    """The plain version of the kernel: rows at or past S contribute zero."""
    flat = torch.arange(8 * 32, dtype=torch.float32).reshape(8, 32) + 1.0
    by = torch.ones(1, 1, 2)
    bx = torch.ones(1, 1, 2)
    from maskrcnn_tpu_torch.kernels.roi_align_cuda import roi_align_region_plain

    out = roi_align_region_plain(flat, torch.tensor([6], dtype=torch.int32),
                                 torch.tensor([2], dtype=torch.int32), by, bx)
    # window rows 6, 7 (first row) and 8, 9 (second, past the end)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), (flat[6] + flat[7]).numpy())
