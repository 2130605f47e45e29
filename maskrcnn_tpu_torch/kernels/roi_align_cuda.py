"""ROIAlign forward: the hand-written Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``maskrcnn_tpu/kernels/roi_align_pallas.py``
(``_pallas_forward``, body ``_kernel``). Both compute, per ROI ``r``,

    out[r] = By[r] @ F[base[r] + j·stride[r] + k] @ Bx[r]ᵀ   (j < ty, k < tx)

over a flattened ``(S, C)`` pyramid, where ``By``/``Bx`` come from
:func:`maskrcnn_tpu_torch.ops.roi_align.region_params` and a row index at
or past ``S`` reads zero (the window is never shifted).

What bounds it on an H100: the two dense contractions need, in the cheaper
order, 2·R·C·min(oh·ty·tx + oh·ow·tx, ow·ty·tx + oh·ow·ty) f32 FLOPs on the
union of the R windows' rows — a few FLOPs per byte, far under the tensor
cores' ridge point, so the f32 CUDA-core rate and the memory rate bound it
about equally. The kernel contracts By first, which at the main path's
windows is the dearer order. The kernel (``csrc/roi_align_fwd.cu``) reads each
window element once, 32 channels per warp so each row read is one coalesced
segment, keeps the By-contracted intermediate in shared memory, reads the
interpolation weights from there as float4 broadcasts (four FMAs per load)
and accumulates in f32 registers. The TPU design's DMA double-buffering, 8-row
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
MAX_OUT = 16  # largest oh / ow the kernel holds in registers


def roi_align_region_plain(flat, base, stride, by, bx) -> torch.Tensor:
    """The kernel's function in plain torch: (R, oh, ow, C) float32."""
    s = flat.shape[0]
    ty, tx = by.shape[2], bx.shape[2]
    dev = flat.device
    idx = (base.long()[:, None, None]
           + torch.arange(ty, device=dev)[None, :, None] * stride.long()[:, None, None]
           + torch.arange(tx, device=dev)[None, None, :])  # (R, ty, tx)
    inside = ((idx >= 0) & (idx < s))[..., None]
    window = flat[idx.clamp(0, max(s - 1, 0))].float() * inside  # (R, ty, tx, C)
    tmp = torch.einsum("ryj,rjkc->rykc", by, window)
    return torch.einsum("rxk,rykc->ryxc", bx, tmp)


class RoiAlignForward:
    """Callable wrapper with a launch counter (``launches``), which rises by
    one per kernel launch and nowhere else."""

    name = "roi_align_fwd"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("roi_align_fwd.cu", {
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


roi_align_fwd = RoiAlignForward()
