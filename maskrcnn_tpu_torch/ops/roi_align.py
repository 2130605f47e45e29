"""Batched multilevel ROIAlign (port of ``maskrcnn_tpu/ops/roi_align.py``).

Caffe2/chainer non-aligned ROIAlign: coordinates scaled by the level's
``spatial_scale`` with no half-pixel offset, ``sampling_ratio²`` bilinear
samples per output cell, averaged. Two forms compute it:

- the **region** form: per ROI, a ``ty × tx`` window of the flattened
  pyramid whose rows start at ``base + j·stride``, contracted as
  ``By @ window @ Bxᵀ`` with the sub-sample mean folded into ``By``/``Bx``
  (:func:`region_params`). On the card this runs in the hand-written kernel
  of :mod:`maskrcnn_tpu_torch.kernels.roi_align_cuda`;
- the pointwise **gather** form (:func:`roi_align_gather`), four corner
  gathers per sample — the test oracle, and what ``roi_align="gather"``
  selects.

Features enter in the JAX layout, one ``(B, H, W, C)`` tensor per level;
pooled output is ``(R, oh, ow, C)`` float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from maskrcnn_tpu_torch.kernels.roi_align_cuda import roi_align_fwd


def _level_layout(features, widths=None):
    """Static (shapes (L, 2), row strides (L,), flat offsets (L,)) of the
    flattened pyramid; ``widths`` pads each level's rows."""
    b = features[0].shape[0]
    shapes = np.array([[f.shape[1], f.shape[2]] for f in features], np.int64)
    strides = shapes[:, 1] if widths is None else np.asarray(widths, np.int64)
    sizes = shapes[:, 0] * strides
    offsets = np.concatenate([[0], np.cumsum(sizes * b)[:-1]])
    return shapes, strides, offsets


def flatten_pyramid(features, widths=None) -> torch.Tensor:
    """Levels (B, H, W, C) → one (S, C) buffer, level-major then batch, with
    each level's rows zero-padded to ``widths`` when given."""
    c = features[0].shape[-1]
    parts = []
    for i, f in enumerate(features):
        if widths is not None and int(widths[i]) != f.shape[2]:
            f = torch.nn.functional.pad(f, (0, 0, 0, int(widths[i]) - f.shape[2]))
        parts.append(f.reshape(-1, c))
    return torch.cat(parts, dim=0)


def region_params(
    shapes: np.ndarray,
    offsets: np.ndarray,
    rois: torch.Tensor,
    roi_batch_idx: torch.Tensor,
    roi_levels: torch.Tensor,
    out_size: tuple[int, int],
    spatial_scales: tuple[float, ...],
    sampling_ratio: int,
    t_span: int,
    x_align: int = 1,
    row_strides: np.ndarray | None = None,
    t_span_x: int | None = None,
    origin: str = "sample",
):
    """Per-ROI window geometry and interpolation matrices.

    Returns ``row_ids`` (R, t) int32, the flat start row of each window row;
    ``by`` (R, oh, t) and ``bx`` (R, ow, tx) float32, such that
    ``By @ flat[window] @ Bxᵀ`` is the pooled output. ``x_align`` quantizes
    the window's x start down to a multiple; ``row_strides`` overrides the
    level width as the flat row stride (padded rows); ``t_span_x`` widens
    the x window; ``origin="box"`` anchors the window at the box origin
    instead of the first sample. Same arguments and results as the JAX
    ``region_params``.
    """
    dev = rois.device
    oh, ow = out_size
    sr = sampling_ratio
    ny, nx = oh * sr, ow * sr
    t = t_span
    tx = t_span if t_span_x is None else t_span_x
    lv = roi_levels.long()

    def per_level(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=dev)[lv]

    scales = per_level(np.asarray(spatial_scales, np.float32), torch.float32)
    lvl_h = per_level(shapes[:, 0], torch.float32)
    lvl_w = per_level(shapes[:, 1], torch.float32)
    lvl_off = per_level(offsets, torch.int64)
    stride = per_level(shapes[:, 1] if row_strides is None else row_strides,
                       torch.int64)
    block = lvl_off + roi_batch_idx.long() * (lvl_h.long() * stride)

    rois = rois.float()
    y0 = rois[:, 0] * scales
    x0 = rois[:, 1] * scales
    bin_h = torch.clamp(rois[:, 2] * scales - y0, min=1.0) / oh
    bin_w = torch.clamp(rois[:, 3] * scales - x0, min=1.0) / ow
    iy = (torch.arange(ny, dtype=torch.float32, device=dev) + 0.5) / sr
    ix = (torch.arange(nx, dtype=torch.float32, device=dev) + 0.5) / sr
    ys = y0[:, None] + bin_h[:, None] * iy[None, :]  # (R, ny)
    xs = x0[:, None] + bin_w[:, None] * ix[None, :]
    h, w = lvl_h[:, None], lvl_w[:, None]
    y_ok = ((ys >= -1.0) & (ys <= h)).float()
    x_ok = ((xs >= -1.0) & (xs <= w)).float()
    zero = torch.zeros((), device=dev)
    yc = torch.minimum(torch.maximum(ys, zero), h - 1.0)
    xc = torch.minimum(torch.maximum(xs, zero), w - 1.0)
    if origin == "box":
        ry0 = torch.floor(torch.minimum(torch.maximum(y0, zero), lvl_h - 1.0))
        rx0 = torch.floor(torch.minimum(torch.maximum(x0, zero), lvl_w - 1.0))
    else:
        ry0 = torch.floor(yc[:, 0])  # samples ascend
        rx0 = torch.floor(xc[:, 0])
    ry0, rx0 = ry0.long(), rx0.long()
    if x_align > 1:
        rx0 = torch.div(rx0, x_align, rounding_mode="floor") * x_align

    def axis_weights(coords, ok, r0, axis_len, span):
        lo = torch.floor(coords)
        hi = torch.minimum(lo + 1.0, axis_len - 1.0)
        l_w = coords - lo  # weight of hi
        lo_i = (lo.long() - r0[:, None]).clamp(0, span - 1)
        hi_i = (hi.long() - r0[:, None]).clamp(0, span - 1)
        m = torch.zeros(coords.shape + (span,), dtype=torch.float32, device=dev)
        m.scatter_add_(2, lo_i[..., None], ((1.0 - l_w) * ok)[..., None])
        m.scatter_add_(2, hi_i[..., None], (l_w * ok)[..., None])
        return m

    r = rois.shape[0]
    by = axis_weights(yc, y_ok, ry0, h, t).reshape(r, oh, sr, t).mean(dim=2)
    bx = axis_weights(xc, x_ok, rx0, w, tx).reshape(r, ow, sr, tx).mean(dim=2)
    rows = torch.arange(t, device=dev)
    row_ids = (block[:, None] + (ry0[:, None] + rows[None, :]) * stride[:, None]
               + rx0[:, None])
    return row_ids.to(torch.int32), by, bx


def window_starts(row_ids):
    """(R, t) window row starts, an arithmetic sequence per ROI → (base,
    stride), each (R,) int32 — the kernel's geometry arguments."""
    base = row_ids[:, 0].contiguous()
    if row_ids.shape[1] > 1:
        stride = (row_ids[:, 1] - row_ids[:, 0]).contiguous()
    else:
        stride = torch.zeros_like(base)
    return base, stride


def region_pool(flat, row_ids, by, bx) -> torch.Tensor:
    """``By @ flat[window] @ Bxᵀ`` through the forward kernel wrapper (the
    hand-written kernel on a CUDA tensor, its plain version on the CPU)."""
    return roi_align_fwd(flat.contiguous(), *window_starts(row_ids),
                         by.contiguous(), bx.contiguous())


def region_geometry(features, rois, roi_batch_idx, roi_levels, out_size,
                    spatial_scales, sampling_ratio=2):
    """The JAX region form's geometry (``ops/roi_align.py`` auto/region):
    ``t_span=20`` on a pyramid, and with every level width divisible by 8 the
    x start folds to a multiple of 8 with a 32-wide window. Returns
    (flat, row_ids, by, bx)."""
    shapes, _, offsets = _level_layout(features)
    t_span = 20 if len(features) > 1 else int(shapes[0].max()) + 3
    fold = 8 if all(int(wl) % 8 == 0 for wl in shapes[:, 1]) else 1
    tx = -(-(t_span + fold - 1) // fold) * fold if fold > 1 else t_span
    row_ids, by, bx = region_params(
        shapes, offsets, rois, roi_batch_idx, roi_levels, out_size,
        spatial_scales, sampling_ratio, t_span, x_align=fold, t_span_x=tx,
    )
    return flatten_pyramid(features), row_ids, by, bx


def pallas_geometry(features, rois, roi_batch_idx, roi_levels, out_size,
                    spatial_scales, sampling_ratio=2):
    """The geometry of the JAX ``multilevel_roi_align_pallas``: with
    ``n = ceil(C/128)`` and ``a = 8 / gcd(n, 8)``, level widths pad to
    multiples of ``a``, x starts quantize to ``a`` and the square window
    widens to ``t_eff`` (24 at C=256). Returns (flat, row_ids, by, bx)."""
    c = features[0].shape[-1]
    n_half = -(-c // 128)
    a = 8 // math.gcd(n_half, 8)
    t_eff = -(-(20 + a - 1) // a) * a
    w_pads = [-(-int(f.shape[2]) // a) * a for f in features]
    shapes, strides, offsets = _level_layout(features, w_pads)
    row_ids, by, bx = region_params(
        shapes, offsets, rois, roi_batch_idx, roi_levels, out_size,
        spatial_scales, sampling_ratio, t_eff, x_align=a, row_strides=strides,
    )
    return flatten_pyramid(features, w_pads), row_ids, by, bx


def roi_align_gather(features, rois, roi_batch_idx, roi_levels, out_size,
                     spatial_scales, sampling_ratio=2) -> torch.Tensor:
    """Pointwise bilinear form (JAX ``_mlra_impl``) → (R, oh, ow, C) f32."""
    shapes, _, offsets = _level_layout(features)
    flat = flatten_pyramid(features).float()
    dev = flat.device
    oh, ow = out_size
    sr = sampling_ratio
    r = rois.shape[0]
    lv = roi_levels.long()
    scales = torch.as_tensor(np.asarray(spatial_scales, np.float32),
                             device=dev)[lv]
    lvl_h = torch.as_tensor(shapes[:, 0], dtype=torch.float32, device=dev)[lv]
    lvl_w = torch.as_tensor(shapes[:, 1], dtype=torch.float32, device=dev)[lv]
    lvl_off = torch.as_tensor(offsets, dtype=torch.int64, device=dev)[lv]
    block = lvl_off + roi_batch_idx.long() * (lvl_h * lvl_w).long()

    rois = rois.float()
    y0 = rois[:, 0] * scales
    x0 = rois[:, 1] * scales
    bin_h = torch.clamp(rois[:, 2] * scales - y0, min=1.0) / oh
    bin_w = torch.clamp(rois[:, 3] * scales - x0, min=1.0) / ow
    iy = (torch.arange(oh * sr, dtype=torch.float32, device=dev) + 0.5) / sr
    ix = (torch.arange(ow * sr, dtype=torch.float32, device=dev) + 0.5) / sr
    shape = (r, oh * sr, ow * sr)
    y = (y0[:, None] + bin_h[:, None] * iy[None, :])[:, :, None].expand(shape)
    x = (x0[:, None] + bin_w[:, None] * ix[None, :])[:, None, :].expand(shape)
    h = lvl_h[:, None, None].expand(shape)
    w = lvl_w[:, None, None].expand(shape)

    zero_mask = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    zero = torch.zeros((), device=dev)
    y = torch.minimum(torch.maximum(y, zero), h - 1.0)
    x = torch.minimum(torch.maximum(x, zero), w - 1.0)
    y_lo = torch.floor(y)
    x_lo = torch.floor(x)
    y_hi = torch.minimum(y_lo + 1.0, h - 1.0)
    x_hi = torch.minimum(x_lo + 1.0, w - 1.0)
    ly, lx = y - y_lo, x - x_lo
    hy, hx = 1.0 - ly, 1.0 - lx
    wi = w.long()
    blk = block[:, None, None]

    def fetch(yy, xx):
        return flat[blk + yy.long() * wi + xx.long()]  # (r, ny, nx, C)

    val = (fetch(y_lo, x_lo) * (hy * hx)[..., None]
           + fetch(y_lo, x_hi) * (hy * lx)[..., None]
           + fetch(y_hi, x_lo) * (ly * hx)[..., None]
           + fetch(y_hi, x_hi) * (ly * lx)[..., None])
    val = torch.where(zero_mask[..., None], torch.zeros_like(val), val)
    c = flat.shape[-1]
    return val.reshape(r, oh, sr, ow, sr, c).mean(dim=(2, 4))


def multilevel_roi_align(features, rois, roi_batch_idx, roi_levels, out_size,
                         spatial_scales, sampling_ratio=2,
                         impl=None) -> torch.Tensor:
    """Multilevel batched ROIAlign → (R, oh, ow, C) float32.

    ``impl``: None (auto: region on a pyramid, gather on one level),
    ``"region"``, ``"pallas"`` (region arithmetic in the window geometry of
    the JAX Pallas wrapper) or ``"gather"``. Region and pallas run the
    forward kernel on CUDA tensors.
    """
    if len(features) != len(spatial_scales):
        raise ValueError("one spatial scale per level")
    if impl is None:
        impl = "region" if len(features) > 1 else "gather"
    args = (features, rois, roi_batch_idx, roi_levels, out_size,
            spatial_scales, sampling_ratio)
    if impl == "region":
        return region_pool(*region_geometry(*args))
    if impl == "pallas":
        return region_pool(*pallas_geometry(*args))
    if impl == "gather":
        return roi_align_gather(*args)
    raise ValueError(f"unknown ROIAlign impl {impl!r}")
