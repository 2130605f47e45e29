"""Batched multilevel ROIAlign in plain torch, as the configuration's
``roi_align="auto"`` states it: on a pyramid, the region form; on one
level, the pointwise form.

Caffe2/chainer non-aligned ROIAlign: coordinates scaled by the level's
``spatial_scale`` with no half-pixel offset, ``sampling_ratio²`` bilinear
samples per output cell, averaged. The **region** form (the JAX package's
``auto``/``region`` on a pyramid) reads, per ROI, a window of ``t_span=20``
rows of the flattened pyramid, its x start folded to a multiple of 8 and
32 columns wide when every level's width divides by 8, and contracts it as
``By @ window @ Bxᵀ`` with the sub-sample mean folded into ``By``/``Bx``;
samples past the window's rows or columns weigh nothing, so an ROI that
spans more than the window at its level is pooled from the window's part
of it. The train step pools its box and mask inputs from ONE shared window
per ROI, anchored at the box's origin. The **pointwise** form gathers four
corners per sample. Features enter one ``(B, H, W, C)`` tensor per level;
pools are ``(R, oh, ow, C)`` float32. Backward: autograd's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.device import device_constant


def _level_layout(features, widths=None):
    """Static (shapes (L, 2), row strides (L,), flat offsets (L,)) of the
    flattened pyramid; ``widths`` pads each level's rows."""
    b = features[0].shape[0]
    shapes = np.array([[f.shape[1], f.shape[2]] for f in features], np.int64)
    strides = shapes[:, 1] if widths is None else np.asarray(widths, np.int64)
    sizes = shapes[:, 0] * strides
    offsets = np.concatenate([[0], np.cumsum(sizes * b)[:-1]])
    return shapes, strides, offsets


def flatten_pyramid(features, widths=None, channels=None) -> torch.Tensor:
    """Levels (B, H, W, C) → one (S, C) buffer, level-major then batch, with
    each level's rows zero-padded to ``widths`` and its channels to
    ``channels`` when given."""
    c = features[0].shape[-1] if channels is None else channels
    parts = []
    for i, f in enumerate(features):
        pad_w = 0 if widths is None else int(widths[i]) - f.shape[2]
        pad_c = c - f.shape[-1]
        if pad_w or pad_c:
            f = torch.nn.functional.pad(f, (0, pad_c, 0, pad_w))
        parts.append(f.reshape(-1, c))
    return torch.cat(parts, dim=0)


def _folded_window(shapes, t_span: int) -> tuple[int, int]:
    """(fold, tx): with every level width divisible by 8 the window's x
    start folds to a multiple of 8 and its width grows to cover the shift
    (32 at ``t_span=20``); else no fold and a square window."""
    fold = 8 if all(int(wl) % 8 == 0 for wl in shapes[:, 1]) else 1
    return fold, -(-(t_span + fold - 1) // fold) * fold if fold > 1 else t_span


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
        return device_constant(values, dtype, dev)[lv]

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
    scales = device_constant(np.asarray(spatial_scales, np.float32),
                             torch.float32, dev)[lv]
    lvl_h = device_constant(shapes[:, 0], torch.float32, dev)[lv]
    lvl_w = device_constant(shapes[:, 1], torch.float32, dev)[lv]
    lvl_off = device_constant(offsets, torch.int64, dev)[lv]
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


def window_pool(flat, row_ids, by, bx) -> torch.Tensor:
    """``By @ flat[window] @ Bxᵀ`` → (R, oh, ow, C) float32; rows of the
    window outside the flattened pyramid read zero."""
    s = flat.shape[0]
    idx = (row_ids.long()[:, :, None]
           + torch.arange(bx.shape[2], device=flat.device)[None, None, :])
    inside = ((idx >= 0) & (idx < s))[..., None]
    window = flat[idx.clamp(0, s - 1)].float() * inside  # (R, t, tx, C)
    tmp = torch.einsum("ryj,rjkc->rykc", by, window)
    return torch.einsum("rxk,rykc->ryxc", bx, tmp)


T_SPAN = 20


def multilevel_roi_align(features, rois, roi_batch_idx, roi_levels, out_size,
                         spatial_scales, sampling_ratio=2) -> torch.Tensor:
    """Multilevel batched ROIAlign → (R, oh, ow, C) float32: the region
    form on a pyramid, the pointwise form on one level."""
    if len(features) != len(spatial_scales):
        raise ValueError("one spatial scale per level")
    if len(features) == 1:
        return roi_align_gather(features, rois, roi_batch_idx, roi_levels,
                                out_size, spatial_scales, sampling_ratio)
    shapes, _, offsets = _level_layout(features)
    fold, tx = _folded_window(shapes, T_SPAN)
    row_ids, by, bx = region_params(
        shapes, offsets, rois, roi_batch_idx, roi_levels, out_size,
        spatial_scales, sampling_ratio, T_SPAN, x_align=fold, t_span_x=tx)
    return window_pool(flatten_pyramid(features), row_ids, by, bx)


def multilevel_roi_align_train(features, rois_bn, levels_bn, n_pos: int,
                               out_size_box, out_size_mask, spatial_scales,
                               sampling_ratio: int = 2):
    """Box pools of all (B·n) ROI slots and mask pools of the (B, :n_pos)
    prefix from one window per ROI anchored at the box's origin → (pooled
    box, pooled mask), float32; on a pyramid only."""
    b, n = rois_bn.shape[:2]
    shapes, _, offsets = _level_layout(features)
    fold, tx = _folded_window(shapes, T_SPAN)
    kw = dict(x_align=fold, t_span_x=tx, origin="box")
    images = torch.arange(b, dtype=torch.int32, device=rois_bn.device)
    rois = rois_bn.detach()
    row_ids, by_b, bx_b = region_params(
        shapes, offsets, rois.reshape(b * n, 4), images.repeat_interleave(n),
        levels_bn.reshape(b * n), out_size_box, spatial_scales,
        sampling_ratio, T_SPAN, **kw)
    _, by_m, bx_m = region_params(
        shapes, offsets, rois[:, :n_pos].reshape(b * n_pos, 4),
        images.repeat_interleave(n_pos), levels_bn[:, :n_pos].reshape(b * n_pos),
        out_size_mask, spatial_scales, sampling_ratio, T_SPAN, **kw)
    flat = flatten_pyramid(features)
    prefix = row_ids.reshape(b, n, -1)[:, :n_pos].reshape(b * n_pos, -1)
    return (window_pool(flat, row_ids, by_b, bx_b),
            window_pool(flat, prefix, by_m, bx_m))
