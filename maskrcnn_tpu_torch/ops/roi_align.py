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

The FPN heads' train step pools its box and mask inputs from ONE shared
window per ROI (:func:`multilevel_roi_align_train`): the forward kernel
twice, and as the backward one launch of the region-scatter kernel of
:mod:`maskrcnn_tpu_torch.kernels.region_scatter_cuda`. Every other pool
that trains through a window geometry (single-level heads, and FPN heads
under ``roi_align="pallas"``) is one :class:`_RegionPool`: the forward
kernel, and as its backward ``Byᵀ·g·Bx`` then the region scatter. The
gather form trains through plain autograd.

The kernels take channels in multiples of 32 (``CHANNEL_TILE``). A pyramid
of other widths (the light head's 490-channel thin map) is flattened for a
single pool with zero channels up to the next multiple (512), as the JAX
Pallas wrapper pads to its 128 lanes; the pool is sliced back to C, and
autograd slices the feature gradient back through the flattening. The FPN
pair's 256 channels need none.

Features enter in the JAX layout, one ``(B, H, W, C)`` tensor per level,
float32 or bfloat16; pooled output is ``(R, oh, ow, C)`` float32. With bf16
features the interpolation weights stay float32, where the JAX package's
``_kron_pool`` rounds its Kronecker weights to bf16 (about 4e-3 relative):
the port's forward is the more exact of the two, and the tests' bf16
tolerances hold that difference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from maskrcnn_tpu_torch.kernels.region_scatter_cuda import region_scatter
from maskrcnn_tpu_torch.kernels.roi_align_cuda import CHANNEL_TILE, roi_align_fwd
from maskrcnn_tpu_torch.utils.device import device_constant


def _level_layout(features, widths=None):
    """Static (shapes (L, 2), row strides (L,), flat offsets (L,)) of the
    flattened pyramid; ``widths`` pads each level's rows."""
    b = features[0].shape[0]
    shapes = np.array([[f.shape[1], f.shape[2]] for f in features], np.int64)
    strides = shapes[:, 1] if widths is None else np.asarray(widths, np.int64)
    sizes = shapes[:, 0] * strides
    offsets = np.concatenate([[0], np.cumsum(sizes * b)[:-1]])
    return shapes, strides, offsets


def kernel_channels(c: int) -> int:
    """C rounded up to the kernels' channel multiple."""
    return -(-c // CHANNEL_TILE) * CHANNEL_TILE


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


def window_starts(row_ids):
    """(R, t) window row starts, an arithmetic sequence per ROI → (base,
    stride), each (R,) int32 — the kernel's geometry arguments."""
    base = row_ids[:, 0].contiguous()
    if row_ids.shape[1] > 1:
        stride = (row_ids[:, 1] - row_ids[:, 0]).contiguous()
    else:
        stride = torch.zeros_like(base)
    return base, stride


class _RegionPool(torch.autograd.Function):
    """One pool over one window per ROI (JAX ``_roi_align_core`` with its
    custom VJP). Forward: the ROIAlign kernel; only the geometry is saved.
    Backward: ``Byᵀ·g·Bx`` in float32, then one launch of the region-scatter
    kernel with a float32 accumulator (JAX scatters the window rows into a
    float32 buffer), cast to the feature dtype. Only ``flat`` gets a
    gradient."""

    @staticmethod
    def forward(ctx, flat, base, stride, by, bx):
        ctx.save_for_backward(base, stride, by, bx)
        ctx.dims = (flat.shape[0], flat.dtype)
        return roi_align_fwd(flat, base, stride, by, bx)

    @staticmethod
    def backward(ctx, g):
        base, stride, by, bx = ctx.saved_tensors
        s_rows, dtype = ctx.dims
        d_reg = _d_regions(by, bx, g.contiguous(), torch.float32)
        d_flat = region_scatter(d_reg, base, stride, s_rows, torch.float32)
        return d_flat.to(dtype), None, None, None, None


def region_pool(flat, row_ids, by, bx, channels=None) -> torch.Tensor:
    """``By @ flat[window] @ Bxᵀ`` through the forward kernel wrapper (the
    hand-written kernel on a CUDA tensor, its plain version on the CPU),
    differentiable with respect to ``flat`` (:class:`_RegionPool`); the
    output's channels cut to ``channels`` when given."""
    out = _RegionPool.apply(flat.contiguous(), *window_starts(row_ids),
                            by.contiguous(), bx.contiguous())
    return out if channels is None else out[..., :channels]


def _folded_window(shapes, t_span: int) -> tuple[int, int]:
    """(fold, tx): with every level width divisible by 8 the window's x
    start folds to a multiple of 8 and its width grows to cover the shift
    (32 at ``t_span=20``); else no fold and a square window."""
    fold = 8 if all(int(wl) % 8 == 0 for wl in shapes[:, 1]) else 1
    return fold, -(-(t_span + fold - 1) // fold) * fold if fold > 1 else t_span


def region_geometry(features, rois, roi_batch_idx, roi_levels, out_size,
                    spatial_scales, sampling_ratio=2):
    """The JAX region form's geometry (``ops/roi_align.py`` auto/region):
    ``t_span=20`` on a pyramid, and with every level width divisible by 8 the
    x start folds to a multiple of 8 with a 32-wide window; on one level the
    window is the whole map, ``max(H, W) + 3`` rows. Returns (flat, row_ids,
    by, bx); ``flat``'s channels are padded to :func:`kernel_channels`."""
    shapes, _, offsets = _level_layout(features)
    t_span = 20 if len(features) > 1 else int(shapes[0].max()) + 3
    fold, tx = _folded_window(shapes, t_span)
    row_ids, by, bx = region_params(
        shapes, offsets, rois, roi_batch_idx, roi_levels, out_size,
        spatial_scales, sampling_ratio, t_span, x_align=fold, t_span_x=tx,
    )
    c = features[0].shape[-1]
    return flatten_pyramid(features, channels=kernel_channels(c)), row_ids, by, bx


def pallas_geometry(features, rois, roi_batch_idx, roi_levels, out_size,
                    spatial_scales, sampling_ratio=2):
    """The geometry of the JAX ``multilevel_roi_align_pallas``: with
    ``n = ceil(C/128)`` and ``a = 8 / gcd(n, 8)``, level widths pad to
    multiples of ``a``, x starts quantize to ``a`` and the square window
    widens to ``t_eff`` (24 at C=256, 22 at C=490, 20 at C=1024). Returns
    (flat, row_ids, by, bx); ``flat``'s channels are padded to
    :func:`kernel_channels`."""
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
    return flatten_pyramid(features, w_pads, kernel_channels(c)), row_ids, by, bx


def pair_geometry(shapes, offsets, rois_bn, levels_bn, n_pos: int,
                  out_size_box, out_size_mask, spatial_scales,
                  sampling_ratio: int = 2):
    """Shared-window geometry of the train pair (JAX ``_pair_geometry``):
    ``t_span=20`` rows, x folded to multiples of 8 with a 32-wide window
    when every level width divides by 8, and ``origin="box"`` for both
    output sizes, so the box pool of all ``B·n`` slots and the mask pool of
    the ``(B, :n_pos)`` prefix read the same ``(base, stride)`` windows.
    Returns (row_ids (B·n, t), by_b, bx_b, by_m, bx_m)."""
    b, n = rois_bn.shape[:2]
    dev = rois_bn.device
    t_span = 20
    fold, tx = _folded_window(shapes, t_span)
    kw = dict(x_align=fold, t_span_x=tx, origin="box")
    batch_idx = torch.arange(b, dtype=torch.int32, device=dev)
    row_ids, by_b, bx_b = region_params(
        shapes, offsets, rois_bn.reshape(b * n, 4), batch_idx.repeat_interleave(n),
        levels_bn.reshape(b * n), out_size_box, spatial_scales,
        sampling_ratio, t_span, **kw)
    _, by_m, bx_m = region_params(
        shapes, offsets, rois_bn[:, :n_pos].reshape(b * n_pos, 4),
        batch_idx.repeat_interleave(n_pos),
        levels_bn[:, :n_pos].reshape(b * n_pos), out_size_mask,
        spatial_scales, sampling_ratio, t_span, **kw)
    return row_ids, by_b, bx_b, by_m, bx_m


def _d_regions(by, bx, g, dtype=torch.float32) -> torch.Tensor:
    """``Byᵀ · g · Bx``: the cotangent of a pooled (R, oh, ow, C) output with
    respect to its (R, t, tx, C) window, as two batched matrix products in
    ``dtype``. In bf16 (JAX ``_fused_pair_bwd``'s ``cd``) the weights and the
    cotangent are rounded to bf16, each product accumulates in float32 and
    rounds to bf16; the intermediate ``Byᵀ·g`` rounds once more, where JAX
    contracts both weights at once in its Kronecker form."""
    r, oh, ow, c = g.shape
    by, bx, g = by.to(dtype), bx.to(dtype), g.to(dtype)
    tmp = torch.matmul(by.transpose(1, 2), g.reshape(r, oh, ow * c))
    tmp = tmp.reshape(r, by.shape[2], ow, c)  # (R, t, ow, C)
    return torch.matmul(bx.transpose(1, 2)[:, None], tmp)  # (R, t, tx, C)


class _RegionPair(torch.autograd.Function):
    """Box and mask pools from one window per ROI. Forward: the ROIAlign
    kernel once per output size; only the geometry is saved, the (R, t, tx,
    C) windows never exist. Backward (JAX ``_fused_pair_bwd``): both
    cotangent windows as matrix products in the feature dtype, the mask's
    added into the positive prefix in place (in that dtype), then ONE launch
    of the region-scatter kernel, accumulating in ``acc_dtype`` (float32
    unless C is a multiple of 256, as in JAX) and writing the gradient in
    the feature dtype. Only ``flat`` gets a gradient."""

    @staticmethod
    def forward(ctx, flat, base, stride, by_b, bx_b, by_m, bx_m, b, n, n_pos,
                acc_dtype):
        pooled_box = roi_align_fwd(flat, base, stride, by_b, bx_b)
        prefix = [x.reshape(b, n)[:, :n_pos].reshape(b * n_pos).contiguous()
                  for x in (base, stride)]
        pooled_mask = roi_align_fwd(flat, *prefix, by_m, bx_m)
        ctx.save_for_backward(base, stride, by_b, bx_b, by_m, bx_m)
        if flat.shape[1] % 256:
            acc_dtype = torch.float32
        ctx.dims = (b, n, n_pos, flat.shape[0], flat.dtype, acc_dtype)
        return pooled_box, pooled_mask

    @staticmethod
    def backward(ctx, g_box, g_mask):
        base, stride, by_b, bx_b, by_m, bx_m = ctx.saved_tensors
        b, n, n_pos, s_rows, dtype, acc_dtype = ctx.dims
        d_reg = _d_regions(by_b, bx_b, g_box, dtype)
        d_reg_m = _d_regions(by_m, bx_m, g_mask, dtype)
        tail = d_reg.shape[1:]
        d_reg.reshape(b, n, *tail)[:, :n_pos] += d_reg_m.reshape(b, n_pos, *tail)
        d_flat = region_scatter(d_reg, base, stride, s_rows, acc_dtype)
        return (d_flat,) + (None,) * 10


def multilevel_roi_align_train(features, rois_bn, levels_bn, n_pos: int,
                               out_size_box, out_size_mask, spatial_scales,
                               sampling_ratio: int = 2,
                               acc_dtype: torch.dtype = torch.float32):
    """Box pooling for ALL ``(B·n)`` ROI slots plus mask pooling for the
    ``(B, :n_pos)`` positive prefix, from one shared window per ROI.

    features: per level (B, Hl, Wl, C), float32 or bfloat16; rois_bn (B, n,
    4) yxyx with positives first; levels_bn (B, n) int32. Returns
    (pooled_box (B·n, oh, ow, C), pooled_mask (B·n_pos, ohm, owm, C)),
    float32, differentiable with respect to the features only; their
    gradient comes in the features' dtype, summed in ``acc_dtype``
    (``cfg.model.roi_align_acc``; float32 whenever C is no multiple of 256).
    On CUDA tensors the forward and the backward are the hand-written
    kernels; on CPU tensors their plain versions.
    """
    if len(features) != len(spatial_scales):
        raise ValueError("one spatial scale per level")
    b, n = rois_bn.shape[:2]
    shapes, _, offsets = _level_layout(features)
    row_ids, by_b, bx_b, by_m, bx_m = pair_geometry(
        shapes, offsets, rois_bn.detach(), levels_bn, n_pos, out_size_box,
        out_size_mask, spatial_scales, sampling_ratio)
    base, stride = window_starts(row_ids)
    return _RegionPair.apply(
        flatten_pyramid(features), base, stride, by_b.contiguous(),
        bx_b.contiguous(), by_m.contiguous(), bx_m.contiguous(), b, n, n_pos,
        acc_dtype)


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


def multilevel_roi_align(features, rois, roi_batch_idx, roi_levels, out_size,
                         spatial_scales, sampling_ratio=2,
                         impl=None) -> torch.Tensor:
    """Multilevel batched ROIAlign → (R, oh, ow, C) float32.

    ``impl``: None (auto: region on a pyramid, gather on one level),
    ``"region"``, ``"pallas"`` (region arithmetic in the window geometry of
    the JAX Pallas wrapper) or ``"gather"``. Region and pallas run the
    forward kernel on CUDA tensors and the region scatter in the backward;
    gather is plain torch with autograd.
    """
    if len(features) != len(spatial_scales):
        raise ValueError("one spatial scale per level")
    if impl is None:
        impl = "region" if len(features) > 1 else "gather"
    args = (features, rois, roi_batch_idx, roi_levels, out_size,
            spatial_scales, sampling_ratio)
    c = features[0].shape[-1]
    if impl == "region":
        return region_pool(*region_geometry(*args), channels=c)
    if impl == "pallas":
        return region_pool(*pallas_geometry(*args), channels=c)
    if impl == "gather":
        return roi_align_gather(*args)
    raise ValueError(f"unknown ROIAlign impl {impl!r}")
