"""Region scatter-add: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel
``maskrcnn_tpu/kernels/region_scatter_pallas.py`` (``scatter_add_regions``,
body ``_kernel``): the backward of the region gather that the train step's
box and mask pools share. Both compute

    out[base[r] + j·stride[r] + k, c] += d_regs[r, j, k, c]   (j < t, k < tx)

into a zeroed ``(s_rows, C)`` gradient of the flattened pyramid, dropping
every row index outside ``[0, s_rows)`` (the forward read zero there).

What bounds it on an H100: bytes. ``d_regs`` must be read once and the
output written once, one add per element. The kernel
(``csrc/region_scatter.cu``) gives each window row of each ROI, a contiguous
``tx·C`` floats on both sides, to one block that reads it as coalesced
float4s and adds it with 16-byte vector reductions; windows overlap and
blocks run in no order, so the adds are atomic and the f32 summation order
varies from run to run. Zero float4s (the weights vanish outside the ROI's
extent inside its window) issue no reduction. The TPU design's sorted ROIs,
sequential tiles with a halo and 128-lane chunks are not carried over.

Built and loaded as :mod:`maskrcnn_tpu_torch.kernels.build` describes. On a
CPU tensor the wrapper runs :func:`region_scatter_plain` (``index_add_``); on
a CUDA tensor it launches the kernel or raises.
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


def region_scatter_plain(d_regs, base, stride, s_rows: int) -> torch.Tensor:
    """The kernel's function in plain torch: ``index_add_`` on the flattened
    row indices into ``s_rows`` rows plus a sink row that is cut off."""
    r, t, tx, c = d_regs.shape
    rows = scatter_rows(base, stride, t, tx, s_rows).reshape(-1)
    out = torch.zeros((s_rows + 1, c), dtype=torch.float32, device=d_regs.device)
    out.index_add_(0, rows, d_regs.reshape(-1, c).float())
    return out[:s_rows]


class RegionScatter:
    """Callable wrapper with a launch counter (``launches``), which rises by
    one per kernel launch and nowhere else."""

    name = "region_scatter"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("region_scatter.cu", {
            "region_scatter_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_void_p]})

    def __call__(self, d_regs, base, stride, s_rows: int) -> torch.Tensor:
        """d_regs (R, t, tx, C) f32; base, stride (R,) int32 → (s_rows, C)
        f32."""
        if d_regs.device.type == "cpu":
            return region_scatter_plain(d_regs, base, stride, s_rows)
        if d_regs.device.type != "cuda":
            raise ValueError(f"region_scatter: unsupported device {d_regs.device}")
        self._check(d_regs, base, stride, s_rows)
        r, t, tx, c = d_regs.shape
        out = torch.zeros((s_rows, c), dtype=torch.float32, device=d_regs.device)
        if r == 0 or s_rows == 0:
            return out
        lib = self.library.load()
        with torch.cuda.device(d_regs.device):
            stream = torch.cuda.current_stream(d_regs.device).cuda_stream
            err = lib.region_scatter_f32(
                d_regs.data_ptr(), base.data_ptr(), stride.data_ptr(),
                out.data_ptr(), r, t, tx, c, s_rows, stream)
        if err != 0:
            raise RuntimeError(f"region_scatter launch failed: cudaError_t {err}")
        self.launches += 1
        return out

    @staticmethod
    def _check(d_regs, base, stride, s_rows):
        if d_regs.dim() != 4 or d_regs.dtype != torch.float32:
            raise ValueError("d_regs must be (R, t, tx, C) float32")
        r, t, tx, c = d_regs.shape
        if c % 4:
            raise ValueError(f"C={c} must be a multiple of 4")
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


region_scatter = RegionScatter()
