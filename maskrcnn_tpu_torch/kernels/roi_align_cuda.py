"""ROIAlign forward: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``maskrcnn_tpu/kernels/roi_align_pallas.py``
(``_pallas_forward``, body ``_kernel``). Both compute, per ROI ``r``,

    out[r] = By[r] @ F[base[r] + j·stride[r] + k] @ Bx[r]ᵀ   (j < ty, k < tx)

over a flattened ``(S, C)`` pyramid, where ``By``/``Bx`` come from
:func:`maskrcnn_tpu_torch.ops.roi_align.region_params` and a row index at
or past ``S`` reads zero (the window is never shifted).

What bounds it on an H100: the bytes. ``By`` and ``Bx`` are banded (a row
has at most four nonzeros next to each other when the ROI fits its window),
so the arithmetic these inputs need, counted by :func:`roi_align_work` over
the nonzero weights in the cheaper contraction order, takes less time at
the card's float32 rate than reading the reached window rows once and
writing the output once takes at its memory rate. The kernel
(``csrc/roi_align_fwd.cu``) finds each weight row's band (first to last
nonzero) while it loads the weights, brings only the window rows and
columns inside the hull of the bands into shared memory, asynchronously
through a ring of row slabs, contracts each slab with ``Bx`` first and adds
the result into register accumulators of the output rows whose ``By`` band
holds that window row; a thread owns 4 consecutive channels, so every
access is 16 bytes. :func:`roi_align_region_banded` is that arithmetic step
by step in plain torch. The TPU design's DMA double-buffering, 8-row
alignment and ``kron(Bx, I_n)`` lane trick answer TPU constraints and are
not carried over.

The kernel is CUDA C++ with a plain C interface, built and loaded as
:mod:`maskrcnn_tpu_torch.kernels.build` describes. On a CPU tensor the
wrapper runs :func:`roi_align_region_plain`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from maskrcnn_tpu_torch.kernels.build import CudaLibrary

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
CHANNEL_TILE = 32  # channels per CUDA block (csrc kChannels)
MAX_OUT = 16  # largest oh / ow the kernel takes (csrc kMaxOut)


def window_rows(base, stride, ty: int, tx: int) -> torch.Tensor:
    """Pyramid row of every window element: (R, ty, tx) int64."""
    dev = base.device
    return (base.long()[:, None, None]
            + torch.arange(ty, device=dev)[None, :, None] * stride.long()[:, None, None]
            + torch.arange(tx, device=dev)[None, None, :])


def roi_align_region_plain(flat, base, stride, by, bx) -> torch.Tensor:
    """The kernel's function in plain torch: (R, oh, ow, C) float32."""
    s = flat.shape[0]
    idx = window_rows(base, stride, by.shape[2], bx.shape[2])
    inside = ((idx >= 0) & (idx < s))[..., None]
    window = flat[idx.clamp(0, max(s - 1, 0))].float() * inside  # (R, ty, tx, C)
    tmp = torch.einsum("ryj,rjkc->rykc", by, window)
    return torch.einsum("rxk,rykc->ryxc", bx, tmp)


def weight_bands(w):
    """Per row of ``w`` (R, o, t) the band of its nonzeros → (lo, hi), each
    (R, o) int64: the first nonzero's index and one past the last; an
    all-zero row gets the empty band ``lo = t, hi = 0``."""
    t = w.shape[-1]
    idx = torch.arange(t, device=w.device)
    nz = w != 0
    lo = torch.where(nz, idx, t).amin(dim=-1)
    hi = torch.where(nz, idx + 1, 0).amax(dim=-1)
    return lo, hi


def roi_align_region_banded(flat, base, stride, by, bx) -> torch.Tensor:
    """The kernel's arithmetic step by step, for tests and the smoke run:
    bands from the weights, only the window rows and columns inside the hull
    of the bands loaded (zero outside ``[0, S)``), ``Bx`` first over each
    output column's band, then ``By`` over each output row's band, window
    columns and rows ascending. A term outside a band is skipped, not
    multiplied by zero, so a non-finite feature under a zero weight leaves
    the output finite where :func:`roi_align_region_plain` gives NaN."""
    s, c = flat.shape
    r, oh, ty = by.shape
    ow, tx = bx.shape[1:]
    out = torch.zeros((r, oh, ow, c), dtype=torch.float32, device=flat.device)
    if r == 0:
        return out
    jlo, jhi = weight_bands(by)
    klo, khi = weight_bands(bx)
    j0, j1 = jlo.amin(dim=1), jhi.amax(dim=1)  # the hull, per ROI
    k0, k1 = klo.amin(dim=1), khi.amax(dim=1)
    base, stride = base.long(), stride.long()
    for j in range(ty):
        in_hull = (j >= j0) & (j < j1)
        if not bool(in_hull.any()):
            continue
        t = torch.zeros((r, ow, c), dtype=torch.float32, device=flat.device)
        for k in range(tx):
            rows = base + j * stride + k
            loaded = in_hull & (k >= k0) & (k < k1) & (rows >= 0) & (rows < s)
            v = flat[rows.clamp(0, max(s - 1, 0))].float()
            v = torch.where(loaded[:, None], v, torch.zeros_like(v))
            in_band = ((k >= klo) & (k < khi))[:, :, None]
            t = t + torch.where(in_band, bx[:, :, k, None] * v[:, None, :], 0.0)
        in_band = ((j >= jlo) & (j < jhi))[:, :, None, None]
        out = out + torch.where(
            in_band, by[:, :, j, None, None] * t[:, None, :, :], 0.0)
    return out


def roi_align_work(flat, base, stride, by, bx) -> dict:
    """The least work one ROIAlign forward needs on these inputs, and the
    dense count beside it → a dict of integers.

    ``flops``: 2·C·Σ_r min(nnz(By_r)·wx_r + oh·nnz(Bx_r), nnz(Bx_r)·wy_r +
    ow·nnz(By_r)), the nonzero weights in the cheaper contraction order,
    with ``wy_r``/``wx_r`` the window rows/columns of ROI ``r`` that carry
    any nonzero weight. ``bytes``: the pyramid rows inside ``[0, S)`` that
    some ROI reaches through a nonzero ``By`` column and a nonzero ``Bx``
    column, each once, plus geometry, weights and the output.
    ``dense_flops``/``dense_bytes``: the same with every weight counted as
    nonzero (two dense contractions over the whole windows).
    ``reached_elements`` of ``window_elements``: Σ_r wy_r·wx_r of R·ty·tx,
    the part of the windows a kernel has to bring in, ROI by ROI."""
    r, oh, ty = by.shape
    ow, tx = bx.shape[1:]
    s, c = flat.shape
    reach_y, reach_x = (by != 0).any(dim=1), (bx != 0).any(dim=1)  # (R, t)
    nnz_y = (by != 0).sum(dim=(1, 2))
    nnz_x = (bx != 0).sum(dim=(1, 2))
    wy, wx = reach_y.sum(dim=1), reach_x.sum(dim=1)
    flops = 2 * c * int(torch.minimum(nnz_y * wx + oh * nnz_x,
                                      nnz_x * wy + ow * nnz_y).sum())
    dense_flops = 2 * r * c * min(oh * ty * tx + oh * ow * tx,
                                  ow * ty * tx + oh * ow * ty)
    rows = window_rows(base, stride, ty, tx)
    inside = (rows >= 0) & (rows < s)
    reached = inside & reach_y[:, :, None] & reach_x[:, None, :]
    fixed = 8 * r + 4 * (by.numel() + bx.numel()) + 4 * r * oh * ow * c
    row_bytes = c * flat.element_size()
    return {
        "flops": flops,
        "bytes": torch.unique(rows[reached]).numel() * row_bytes + fixed,
        "dense_flops": dense_flops,
        "dense_bytes": torch.unique(rows[inside]).numel() * row_bytes + fixed,
        "reached_elements": int((wy * wx).sum()),
        "window_elements": r * ty * tx,
    }


class RoiAlignForward:
    """Callable wrapper with a launch counter (``launches``), which rises by
    one per kernel launch and nowhere else."""

    name = "roi_align_fwd"

    def __init__(self, source="roi_align_fwd.cu"):
        self.launches = 0
        self.library = CudaLibrary(source, {
            "roi_align_fwd_f32": _ARGTYPES, "roi_align_fwd_bf16": _ARGTYPES})

    def __call__(self, flat, base, stride, by, bx) -> torch.Tensor:
        """flat (S, C) f32/bf16; base, stride (R,) int32; by (R, oh, ty) and
        bx (R, ow, tx) f32 → (R, oh, ow, C) f32."""
        if flat.device.type == "cpu":
            return roi_align_region_plain(flat, base, stride, by, bx)
        if flat.device.type != "cuda":
            raise ValueError(f"roi_align_fwd: unsupported device {flat.device}")
        self._check(flat, base, stride, by, bx)
        r, oh, ty = by.shape
        ow, tx = bx.shape[1], bx.shape[2]
        s, c = flat.shape
        out = torch.empty((r, oh, ow, c), dtype=torch.float32, device=flat.device)
        if r == 0:
            return out
        lib = self.library.load()
        fn = (lib.roi_align_fwd_f32 if flat.dtype == torch.float32
              else lib.roi_align_fwd_bf16)
        with torch.cuda.device(flat.device):
            stream = torch.cuda.current_stream(flat.device).cuda_stream
            err = fn(flat.data_ptr(), base.data_ptr(), stride.data_ptr(),
                     by.data_ptr(), bx.data_ptr(), out.data_ptr(),
                     r, s, c, ty, tx, oh, ow, stream)
        if err != 0:
            raise RuntimeError(f"roi_align_fwd launch failed: cudaError_t {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(flat, base, stride, by, bx):
        if flat.dim() != 2 or flat.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("flat must be (S, C) float32 or bfloat16")
        s, c = flat.shape
        if c % CHANNEL_TILE:
            raise ValueError(f"C={c} must be a multiple of {CHANNEL_TILE}")
        if s >= 2**31 or by.shape[0] >= 2**31:
            raise ValueError("S and R must fit in int32")
        if by.dim() != 3 or bx.dim() != 3 or by.shape[0] != bx.shape[0]:
            raise ValueError("by must be (R, oh, ty) and bx (R, ow, tx)")
        r = by.shape[0]
        if not (1 <= by.shape[1] <= MAX_OUT and 1 <= bx.shape[1] <= MAX_OUT):
            raise ValueError(f"output sizes must lie in [1, {MAX_OUT}]")
        for name, t, dt, shape in (("base", base, torch.int32, (r,)),
                                   ("stride", stride, torch.int32, (r,)),
                                   ("by", by, torch.float32, None),
                                   ("bx", bx, torch.float32, None)):
            if t.dtype != dt or (shape is not None and tuple(t.shape) != shape):
                raise ValueError(f"{name}: expected {dt} {shape or ''}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        for name, t in (("flat", flat), ("base", base), ("stride", stride),
                        ("by", by), ("bx", bx)):
            if t.device != flat.device:
                raise ValueError(f"{name} is on {t.device}, flat on {flat.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if flat.data_ptr() % 16:
            raise ValueError("flat must be 16-byte aligned")


roi_align_fwd = RoiAlignForward()
