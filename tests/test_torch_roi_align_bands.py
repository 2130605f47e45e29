"""The banded arithmetic of the ROIAlign forward kernel, on the CPU.

``roi_align_region_banded`` repeats the CUDA kernel's steps in plain torch
(bands from the weights, only the hull of the bands loaded, Bx first); it
is held here against ``roi_align_region_plain`` (two dense contractions, By
first) on every geometry the port builds and on weights that are not
ROIAlign's. Tolerance: max abs ≤ 1e-6 · max|plain| (float32 sums of at most
a few dozen terms in another order). ``roi_align_work`` (the bound's work
count) is held against a numpy count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch.kernels.roi_align_cuda import (  # noqa: E402
    roi_align_region_banded,
    roi_align_region_plain,
    roi_align_work,
    weight_bands,
)
from maskrcnn_tpu_torch.ops import roi_align as tra  # noqa: E402

torch.set_num_threads(1)

STRIDES = (4, 8, 16, 32, 64)
SCALES = tuple(1.0 / s for s in STRIDES)
TOL = 1e-6


def _pyramid(rng, b, h, w, c=32):
    shapes = [(h // s, w // s) for s in STRIDES[:4]]
    shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    return [torch.from_numpy(rng.randn(b, hh, ww, c).astype(np.float32))
            for hh, ww in shapes]


def _rois(rng, feats, n_fit=24, n_thin=6, n_off=6, n_end=4):
    """Boxes sized in their level's frame: ``n_fit`` inside the window span,
    ``n_thin`` longer than the window (clamped weights), ``n_off`` half off
    the map (all-zero weight rows), ``n_end`` at the bottom-right corner of
    the last level of the last image (windows past the buffer's end)."""
    b = feats[0].shape[0]
    rois, levels, bi = [], [], []
    for kind, n in (("fit", n_fit), ("thin", n_thin), ("off", n_off),
                    ("end", n_end)):
        for _ in range(n):
            # a box longer than the window needs a level larger than it
            lv = (len(feats) - 1 if kind == "end" else
                  rng.randint(0, 2 if kind == "thin" else len(feats)))
            hl, wl = feats[lv].shape[1:3]
            if kind == "fit":
                fh, fw = rng.uniform(0.5, min(14.0, hl)), rng.uniform(0.5, min(14.0, wl))
                fy, fx = rng.uniform(0, hl - fh), rng.uniform(0, wl - fw)
            elif kind == "thin":
                fh, fw = rng.uniform(0.5, 2.0), rng.uniform(40.0, 60.0)
                if rng.rand() < 0.5:
                    fh, fw = fw, fh
                fy, fx = rng.uniform(-2, 2), rng.uniform(-2, 2)
            elif kind == "off":
                fh, fw = rng.uniform(8.0, 10.0), rng.uniform(8.0, 10.0)
                fy, fx = -fh / 2, rng.choice([-fw / 2, wl - fw / 2])
            else:
                fh, fw = rng.uniform(1.0, hl), rng.uniform(1.0, wl)
                fy, fx = hl - fh, wl - fw
            s = STRIDES[lv]
            rois.append([fy * s, fx * s, (fy + fh) * s, (fx + fw) * s])
            levels.append(lv)
            bi.append(b - 1 if kind == "end" else rng.randint(0, b))
    kinds = np.array(["fit"] * n_fit + ["thin"] * n_thin + ["off"] * n_off
                     + ["end"] * n_end)
    return (torch.tensor(rois, dtype=torch.float32),
            torch.tensor(bi, dtype=torch.int32),
            torch.tensor(levels, dtype=torch.int32), kinds)


def _assert_banded_is_plain(flat, base, stride, by, bx, tol=TOL):
    want = roi_align_region_plain(flat, base, stride, by, bx)
    got = roi_align_region_banded(flat, base, stride, by, bx)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("out", [7, 14])
@pytest.mark.parametrize("geometry", ["region", "pallas"])
def test_banded_version_equals_plain(geometry, out):
    """Region (20×32, folded) and pallas (32×32 at C=32, padded rows) windows, with
    ROIs larger than their window, ROIs whose first output rows have zero
    weight and windows that run past the buffer's end."""
    rng = np.random.RandomState(5)
    feats = _pyramid(rng, 2, 256, 512)
    rois, bi, lv, kinds = _rois(rng, feats)
    build = getattr(tra, f"{geometry}_geometry")
    flat, row_ids, by, bx = build(feats, rois, bi, lv, (out, out), SCALES)
    base, stride = tra.window_starts(row_ids)
    assert tuple(by.shape[1:]) == (out, 20 if geometry == "region" else 32)
    assert bx.shape[2] == 32
    # the cases the docstring names are really there
    off = torch.from_numpy(kinds == "off")
    assert bool((by[off].abs().sum(dim=2) == 0).any())  # y_ok = 0 rows
    thin = torch.from_numpy(kinds == "thin")
    last = torch.maximum(by[thin][:, :, -1].amax(dim=1), bx[thin][:, :, -1].amax(dim=1))
    assert bool((last > 0).any())  # weights piled on the last index
    end = torch.from_numpy(kinds == "end")
    assert bool((row_ids[end][:, -1].long() + bx.shape[2] > flat.shape[0]).all())
    _assert_banded_is_plain(flat, base, stride, by, bx)
    _assert_banded_is_plain(flat.bfloat16(), base, stride, by, bx)


def test_banded_version_equals_plain_on_the_train_pair():
    """The shared windows of the train step: box pool over all slots, mask
    pool over the positive prefix, ``origin="box"``."""
    rng = np.random.RandomState(6)
    feats = _pyramid(rng, 2, 256, 512)
    rois, _, lv, _ = _rois(rng, feats, n_fit=12, n_thin=2, n_off=2, n_end=0)
    n, n_pos = 8, 3
    shapes, _, offsets = tra._level_layout(feats)
    row_ids, by_b, bx_b, by_m, bx_m = tra.pair_geometry(
        shapes, offsets, rois.reshape(2, n, 4), lv.reshape(2, n), n_pos,
        (7, 7), (14, 14), SCALES)
    flat = tra.flatten_pyramid(feats)
    base, stride = tra.window_starts(row_ids)
    _assert_banded_is_plain(flat, base, stride, by_b, bx_b)
    prefix = [x.reshape(2, n)[:, :n_pos].reshape(-1).contiguous()
              for x in (base, stride)]
    _assert_banded_is_plain(flat, *prefix, by_m, bx_m)


@pytest.mark.parametrize("r,oh,ow,ty,tx", [(6, 7, 7, 20, 32), (3, 16, 9, 7, 33),
                                           (1, 1, 3, 1, 5)])
def test_banded_version_equals_plain_on_dense_weights(r, oh, ow, ty, tx):
    """Weights that are not ROIAlign's: every band is the whole row (or what
    random zeros leave of it), windows start before row 0 and end past S."""
    g = torch.Generator().manual_seed(r)
    s = 300
    flat = torch.randn(s, 32, generator=g)
    base = torch.randint(-40, s, (r,), generator=g, dtype=torch.int32)
    stride = torch.randint(0, 40, (r,), generator=g, dtype=torch.int32)
    by = torch.randn(r, oh, ty, generator=g)
    bx = torch.randn(r, ow, tx, generator=g)
    _assert_banded_is_plain(flat, base, stride, by, bx)
    # holes inside the bands, empty rows and an ROI with no weight at all
    by = by * (torch.rand(r, oh, ty, generator=g) < 0.3)
    bx = bx * (torch.rand(r, ow, tx, generator=g) < 0.3)
    by[0, 0] = 0
    bx[-1] = 0
    _assert_banded_is_plain(flat, base, stride, by, bx)


def test_weight_bands_first_to_last_nonzero():
    w = torch.tensor([[[0.0, 0.5, 0.0, 0.25, 0.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0],
                       [1.0, 0.0, 0.0, 0.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0, float("nan")]]])
    lo, hi = weight_bands(w)
    assert lo.tolist() == [[1, 5, 0, 4]]
    assert hi.tolist() == [[4, 0, 5, 5]]


@pytest.mark.parametrize("out", [7, 14])
def test_region_params_rows_have_bands_of_at_most_four(out):
    """Two taps for each of two samples: when the ROI fits its window, the
    nonzeros of a row of By or Bx lie within four neighbouring indices."""
    rng = np.random.RandomState(7)
    feats = _pyramid(rng, 2, 256, 512)
    rois, bi, lv, kinds = _rois(rng, feats, n_fit=60, n_thin=4, n_off=4)
    _, _, by, bx = tra.region_geometry(feats, rois, bi, lv, (out, out), SCALES)
    fit = torch.from_numpy(kinds == "fit")
    widest = 0
    for w in (by, bx):
        lo, hi = weight_bands(w[fit])
        assert bool((hi > lo).all())  # no empty row for a box on the map
        assert int((hi - lo).max()) <= 4
        widest = max(widest, int((hi - lo).max()))
        # an ROI longer than its window piles weight on the last index
        assert int(weight_bands(w[torch.from_numpy(kinds == "thin")])[1].max()) \
            == w.shape[2]
    assert widest >= 3


def test_non_finite_feature_under_a_zero_weight():
    """Where the two versions differ, on purpose: the plain version computes
    0 · inf = NaN, the banded one (and the kernel) skips the term."""
    flat = torch.ones(12, 32)
    flat[5] = float("inf")
    by = torch.tensor([[[1.0, 0.0, 0.0]]])
    bx = torch.tensor([[[0.5, 0.5, 0.0]]])
    base = torch.tensor([0], dtype=torch.int32)
    stride = torch.tensor([3], dtype=torch.int32)
    assert 5 in (base.item() + np.arange(3)[:, None] * 3 + np.arange(3)).ravel()
    plain = roi_align_region_plain(flat, base, stride, by, bx)
    banded = roi_align_region_banded(flat, base, stride, by, bx)
    assert bool(torch.isnan(plain).all())
    assert banded.flatten().tolist() == [1.0] * 32
    # under a nonzero weight both give a non-finite output
    bx[0, 0, 2] = 0.25
    flat[2] = float("inf")
    assert bool(torch.isinf(roi_align_region_banded(flat, base, stride, by, bx)).all())


def _numpy_work(s, c, itemsize, base, stride, by, bx):
    r, oh, ty = by.shape
    ow, tx = bx.shape[1:]
    flops, rows = 0, set()
    for i in range(r):
        cols_y = [j for j in range(ty) if np.any(by[i, :, j] != 0)]
        cols_x = [k for k in range(tx) if np.any(bx[i, :, k] != 0)]
        nnz_y, nnz_x = int((by[i] != 0).sum()), int((bx[i] != 0).sum())
        flops += 2 * c * min(nnz_y * len(cols_x) + oh * nnz_x,
                             nnz_x * len(cols_y) + ow * nnz_y)
        for j in cols_y:
            for k in cols_x:
                g = int(base[i]) + j * int(stride[i]) + k
                if 0 <= g < s:
                    rows.add(g)
    fixed = 8 * r + 4 * (by.size + bx.size) + 4 * r * oh * ow * c
    return flops, len(rows) * c * itemsize + fixed


def test_work_count_on_a_hand_made_case():
    """Two ROIs over a 10-row buffer, counted by hand: ROI 0 has By nonzeros
    (0,1), (0,2), (1,2) and Bx nonzeros (0,0), (1,0), (1,1) on a window at
    rows 1 + 4j + k; ROI 1 has one weight each way and a window past the end."""
    s, c = 10, 32
    flat = torch.zeros(s, c)
    by = np.zeros((2, 2, 3), np.float32)
    bx = np.zeros((2, 2, 4), np.float32)
    by[0, 0, 1] = by[0, 0, 2] = by[0, 1, 2] = 0.5
    bx[0, 0, 0] = bx[0, 1, 0] = bx[0, 1, 1] = 0.5
    by[1, 1, 2] = bx[1, 0, 3] = 1.0
    base = np.array([1, 2], np.int32)
    stride = np.array([4, 3], np.int32)
    work = roi_align_work(flat, torch.from_numpy(base), torch.from_numpy(stride),
                          torch.from_numpy(by), torch.from_numpy(bx))
    # ROI 0: nnz 3 and 3, reached 2 rows × 2 columns: min(3·2 + 2·3, 3·2 + 2·3)
    # = 12; ROI 1: nnz 1 and 1, 1 × 1: min(1 + 2, 1 + 2) = 3
    assert work["flops"] == 2 * c * (12 + 3)
    # ROI 0 reaches rows 1 + 4·{1, 2} + {0, 1} = 5, 6, 9 and 10 (outside);
    # ROI 1 reaches 2 + 3·2 + 3 = 11 (outside)
    fixed = 8 * 2 + 4 * (12 + 16) + 4 * 2 * 2 * 2 * c
    assert work["bytes"] == 3 * c * 4 + fixed
    assert (work["flops"], work["bytes"]) == _numpy_work(
        s, c, 4, base, stride, by, bx)
    assert work["dense_flops"] == 2 * 2 * c * min(2 * 3 * 4 + 2 * 2 * 4,
                                                  2 * 3 * 4 + 2 * 2 * 3)
    # both windows whole: rows 1..4, 5..8, 9 and 2..5, 5..8, 8..9
    assert work["dense_bytes"] == 9 * c * 4 + fixed
    # 2 × 2 and 1 × 1 reached rows × columns of two 3 × 4 windows
    assert (work["reached_elements"], work["window_elements"]) == (5, 24)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_work_count_matches_numpy_and_stays_under_the_dense_count(dtype):
    rng = np.random.RandomState(8)
    feats = _pyramid(rng, 2, 256, 512)
    rois, bi, lv, _ = _rois(rng, feats)
    for geometry, out in (("region", 7), ("pallas", 14)):
        build = getattr(tra, f"{geometry}_geometry")
        flat, row_ids, by, bx = build(feats, rois, bi, lv, (out, out), SCALES)
        flat = flat.to(dtype)
        base, stride = tra.window_starts(row_ids)
        work = roi_align_work(flat, base, stride, by, bx)
        assert (work["flops"], work["bytes"]) == _numpy_work(
            flat.shape[0], flat.shape[1], flat.element_size(), base.numpy(),
            stride.numpy(), by.numpy(), bx.numpy())
        assert 0 < work["flops"] < work["dense_flops"]
        assert 0 < work["bytes"] < work["dense_bytes"]
    # dense weights: the two counts coincide
    by, bx = torch.rand_like(by) + 0.1, torch.rand_like(bx) + 0.1
    work = roi_align_work(flat, base, stride, by, bx)
    assert work["flops"] == work["dense_flops"]
    assert work["bytes"] == work["dense_bytes"]
