"""Region scatter-add: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel
``maskrcnn_tpu/kernels/region_scatter_pallas.py`` (``scatter_add_regions``,
body ``_kernel``): the backward of the region gather that the train step's
box and mask pools share. Both compute

    out[base[r] + j·stride[r] + k, c] += d_regs[r, j, k, c]   (j < t, k < tx)

into a zeroed ``(s_rows, C)`` gradient of the flattened pyramid, dropping
every row index outside ``[0, s_rows)`` (the forward read zero there).
``d_regs`` comes in the feature dtype (float32 or bfloat16), the sums are
taken in ``acc_dtype`` (float32 or bfloat16) and the result has the dtype of
``d_regs``, as the TPU kernel's ``out_dtype``/``acc_dtype``.

What bounds it on an H100: bytes. ``d_regs`` must be read once and the
output written once, one add per element. The kernel
(``csrc/region_scatter.cu``) gives each window row of each ROI, contiguous
on both sides, to one block that reads it in coalesced 16- or 32-byte
vectors and adds it with 16-byte vector reductions (four float32 sums, or
eight bf16 sums in one ``red.global.add.noftz.v4.bf16x2``); windows overlap
and blocks run in no order, so the adds are atomic and the summation order
varies from run to run. Zero vectors (the weights vanish outside the ROI's
extent inside its window) issue no reduction. When the accumulator and the
output differ in dtype, the sums go into a zeroed scratch of the
accumulator's dtype and a second kernel of the same call casts it; the
counter counts calls. The TPU design's sorted ROIs, sequential tiles with a
halo and 128-lane chunks, which accumulate without atomics or a scratch, are
not carried over.

Built and loaded as :mod:`maskrcnn_tpu_torch.kernels.build` describes. On a
CPU tensor the wrapper runs :func:`region_scatter_plain` (``index_add_``, or
one rounded bf16 add after another); on a CUDA tensor it launches the
kernel or raises. :func:`region_scatter_exact` gives the float64 sum and
the rounding bound that the kernel and its plain version are held to.
"""

from __future__ import annotations

import ctypes

import torch

from maskrcnn_tpu_torch.kernels.build import CudaLibrary


def scatter_rows(base, stride, t: int, tx: int, s_rows: int) -> torch.Tensor:
    """(R, t, tx) int64 output row of every window element, with every row
    outside ``[0, s_rows)`` mapped to the sink row ``s_rows``."""
    dev = base.device
    idx = (base.long()[:, None, None]
           + torch.arange(t, device=dev)[None, :, None] * stride.long()[:, None, None]
           + torch.arange(tx, device=dev)[None, None, :])
    return torch.where((idx >= 0) & (idx < s_rows), idx,
                       torch.full_like(idx, s_rows))


def region_scatter_plain(d_regs, base, stride, s_rows: int,
                         acc_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain torch, on the flattened row indices
    into ``s_rows`` rows plus a sink row that is cut off, then cast to the
    dtype of ``d_regs``: ``index_add_`` for a float32 or float64
    accumulator; a bf16 accumulator adds one window element after another,
    in ROI order, rounding to bf16 after each add (``index_add_`` on a 2-D
    bf16 tensor sums in float32 on the CPU and rounds once)."""
    r, t, tx, c = d_regs.shape
    rows = scatter_rows(base, stride, t, tx, s_rows).reshape(-1)
    src = d_regs.reshape(-1, c).to(acc_dtype)
    if acc_dtype == torch.bfloat16:
        return _bf16_sequential_sum(src, rows, s_rows).to(d_regs.dtype)
    out = torch.zeros((s_rows + 1, c), dtype=acc_dtype, device=d_regs.device)
    out.index_add_(0, rows, src)
    return out[:s_rows].to(d_regs.dtype)


def _bf16_sequential_sum(src, rows, n_rows: int) -> torch.Tensor:
    """``src`` (N, C) bf16 added into ``n_rows`` zeroed bf16 rows, each row
    taking its terms one at a time in the order given, rounded to bf16
    after every add; terms of rows at or past ``n_rows`` are dropped. Step
    i adds the i-th term of every row at once (the rows of a step are
    distinct), so the loop runs as many steps as the most terms that meet
    on a row; all-zero terms are left out, as adding zero changes no sum."""
    keep = ((rows < n_rows) & (src != 0).any(dim=1)).nonzero().squeeze(1)
    src, rows = src[keep], rows[keep]
    dest, by_dest = torch.sort(rows, stable=True)
    first = torch.searchsorted(dest, dest)
    rank = torch.arange(dest.numel(), device=dest.device) - first
    _, by_rank = torch.sort(rank, stable=True)
    out = torch.zeros((n_rows, src.shape[1]), dtype=torch.bfloat16,
                      device=src.device)
    start = 0
    for count in torch.bincount(rank).tolist():
        step = by_rank[start:start + count]
        row = dest[step]
        out[row] = (out[row].float() + src[by_dest[step]].float()).bfloat16()
        start += count
    return out


def region_scatter_exact(d_regs, base, stride, s_rows: int,
                         acc_dtype=torch.float32):
    """What a right region scatter may return, element by element →
    ``(exact, bound)``, both ``(s_rows, C)`` float64: the float64 sum of the
    windows and the largest error that rounding in ``acc_dtype`` (and into
    the dtype of ``d_regs``) can give it, in whatever order the adds run.

    Each rounded add lands within u·|result| of the exact one (u = 2^-24 in
    float32, 2^-8 in bf16, round to nearest). An element that sums n
    nonzero terms of absolute sum A rounds m = n − 1 partial sums (the first
    add into zero is exact), and m = n when the terms round into a bf16
    accumulator first; then it lies within A·((1+u)^m − 1) of the exact sum
    [Higham, *Accuracy and Stability of Numerical Algorithms*, §4.2]. A
    bf16 output of float32 sums rounds once more: 2^-8·|exact| plus
    (1 + 2^-8) times the float32 bound. 1e-12·A covers the float64 sum's own
    rounding. An element no window reaches must be 0."""
    wide = d_regs.to(torch.float64)
    exact = region_scatter_plain(wide, base, stride, s_rows, torch.float64)
    total = region_scatter_plain(wide.abs(), base, stride, s_rows, torch.float64)
    n = region_scatter_plain((d_regs != 0).to(torch.float64), base, stride,
                             s_rows, torch.float64)
    u = 2.0 ** -24 if acc_dtype == torch.float32 else 2.0 ** -8
    rounds_in = d_regs.dtype != acc_dtype == torch.bfloat16
    m = (n - 1).clamp(min=0) + (n > 0) * float(rounds_in)
    bound = total * torch.expm1(m * torch.log1p(torch.tensor(u, dtype=torch.float64)))
    if d_regs.dtype == torch.bfloat16 and acc_dtype == torch.float32:
        bound = 2.0 ** -8 * exact.abs() + (1 + 2.0 ** -8) * bound
    return exact, bound + 1e-12 * total


_GEOMETRY = [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
# (d_regs dtype, accumulator dtype) → (C entry point, whether it takes a
# scratch accumulator)
_ENTRY = {
    (torch.float32, torch.float32): ("region_scatter_f32", False),
    (torch.bfloat16, torch.bfloat16): ("region_scatter_bf16", False),
    (torch.bfloat16, torch.float32): ("region_scatter_bf16_acc_f32", True),
    (torch.float32, torch.bfloat16): ("region_scatter_f32_acc_bf16", True),
}


class RegionScatter:
    """Callable wrapper with a launch counter (``launches``), which rises by
    one per call that launches the kernel and nowhere else."""

    name = "region_scatter"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("region_scatter.cu", {
            fn: [ctypes.c_void_p] * (5 if scratch else 4) + _GEOMETRY
            for fn, scratch in _ENTRY.values()})

    def __call__(self, d_regs, base, stride, s_rows: int,
                 acc_dtype=torch.float32) -> torch.Tensor:
        """d_regs (R, t, tx, C) float32 or bfloat16; base, stride (R,) int32
        → (s_rows, C) in the dtype of ``d_regs``, summed in ``acc_dtype``."""
        if d_regs.device.type == "cpu":
            return region_scatter_plain(d_regs, base, stride, s_rows, acc_dtype)
        if d_regs.device.type != "cuda":
            raise ValueError(f"region_scatter: unsupported device {d_regs.device}")
        self._check(d_regs, base, stride, s_rows, acc_dtype)
        r, t, tx, c = d_regs.shape
        fn, scratch = _ENTRY[(d_regs.dtype, acc_dtype)]
        acc = torch.zeros((s_rows, c), dtype=acc_dtype, device=d_regs.device)
        if r == 0 or s_rows == 0:
            return acc.to(d_regs.dtype)
        out = (torch.empty((s_rows, c), dtype=d_regs.dtype, device=d_regs.device)
               if scratch else acc)
        lib = self.library.load()
        with torch.cuda.device(d_regs.device):
            stream = torch.cuda.current_stream(d_regs.device).cuda_stream
            ptrs = [d_regs.data_ptr(), base.data_ptr(), stride.data_ptr(),
                    acc.data_ptr()] + ([out.data_ptr()] if scratch else [])
            err = getattr(lib, fn)(*ptrs, r, t, tx, c, s_rows, stream)
        if err != 0:
            raise RuntimeError(f"region_scatter launch failed: cudaError_t {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(d_regs, base, stride, s_rows, acc_dtype):
        if d_regs.dim() != 4 or (d_regs.dtype, acc_dtype) not in _ENTRY:
            raise ValueError(
                "d_regs must be (R, t, tx, C) float32 or bfloat16 and the "
                f"accumulator float32 or bfloat16, got {d_regs.dtype} "
                f"{tuple(d_regs.shape)} and {acc_dtype}")
        r, t, tx, c = d_regs.shape
        vec = 4 if d_regs.dtype == acc_dtype == torch.float32 else 8
        if c % vec:
            raise ValueError(f"C={c} must be a multiple of {vec}")
        if s_rows < 0 or r * t >= 2**31 or tx * c >= 2**31:
            raise ValueError("s_rows must be >= 0; R·t and tx·C must fit in int32")
        for name, x in (("base", base), ("stride", stride)):
            if x.dtype != torch.int32 or tuple(x.shape) != (r,):
                raise ValueError(f"{name}: expected torch.int32 {(r,)}, got "
                                 f"{x.dtype} {tuple(x.shape)}")
        for name, x in (("d_regs", d_regs), ("base", base), ("stride", stride)):
            if x.device != d_regs.device:
                raise ValueError(f"{name} is on {x.device}, d_regs on "
                                 f"{d_regs.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if d_regs.data_ptr() % 16:
            raise ValueError("d_regs must be 16-byte aligned")


region_scatter = RegionScatter()
