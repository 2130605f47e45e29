"""Exact greedy NMS: the hand-written Hopper kernel and its plain versions.

No Pallas counterpart: the JAX package computes NMS in XLA ops, and the
kernel replaces its Jacobi fixpoint (``maskrcnn_tpu/ops/nms.py:128``
``_jacobi_fixpoint``, a ``lax.while_loop`` that stays on the device). All
three functions here take P problems of N boxes already sorted by
descending score and return the keep mask (P, N) of the greedy recurrence

    keep[i] = valid[i] and no kept j < i with IoU(j, i) > thresh,

which is acyclic (edges run from earlier to later boxes), so its fixpoint
is unique and equals sequential greedy NMS:

- :func:`nms_keep_plain`, the spec: Jacobi sweeps over the full
  suppression matrix until nothing changes (on a CUDA tensor each sweep's
  convergence test would wait for the device; the wrapper runs it only on
  the CPU);
- :func:`nms_keep_bitmask_plain`, the kernel's algorithm in plain torch:
  the suppression matrix packed into 64-bit words, walked 64 boxes at a
  time (each step's 64 bits decided in full, then trimmed at the
  ``n_out``-th kept box, where the walk stops);
- the kernel (``csrc/nms_greedy.cu``): a mask pass and a walk, one launch
  each for all P problems, the walk one block (one SM) a problem; what
  bounds it and what its design does about that are in the source's
  header.

The kernel stops at the ``n_out``-th kept box, so boxes after it may stay
unkept where the full fixpoint keeps them; compacted into ``n_out`` slots
(:func:`maskrcnn_tpu_torch.ops.nms.nms_padded`) every version gives the
same indices. The kernel is CUDA C++ with a plain C interface, built and
loaded as :mod:`maskrcnn_tpu_torch.kernels.build` describes. On a CPU
tensor the wrapper runs :func:`nms_keep_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from maskrcnn_tpu_torch.kernels.build import CudaLibrary
from maskrcnn_tpu_torch.ops.boxes import box_iou

WORD = 64  # boxes a mask word, and a step of the walk
IOU_OPS = 14  # float32 operations of one IoU and its comparison

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUNCTIONS = {
    # boxes, valid, mask, keep, P, N, n_out, thresh, stream
    "nms_greedy": [_PTR] * 4 + [_INT] * 3 + [_FLOAT, _PTR],
    # boxes, mask, P, N, thresh, stream
    "nms_mask": [_PTR] * 2 + [_INT] * 2 + [_FLOAT, _PTR],
    # mask, valid, keep, P, N, n_out, stream
    "nms_walk": [_PTR] * 3 + [_INT] * 3 + [_PTR],
}


def mask_words(p: int, n: int) -> int:
    """64-bit words of the kernel's mask scratch: each problem's upper
    triangle of 64×64 tiles, packed (``W = ceil(N/64)`` tile rows, row
    ``t`` holding 64 rows of its words ``t`` onwards, then the next tile
    row's 64 diagonal words; tile row 0's diagonal words before it)."""
    words = -(-n // WORD)
    return p * WORD * (1 + words + words * (words + 1) // 2)


def suppression(boxes_s, iou_thresh: float) -> torch.Tensor:
    """sup[..., j, i]: box j lies before box i and IoU(j, i) > thresh."""
    n = boxes_s.shape[-2]
    pos = torch.arange(n, device=boxes_s.device)
    return (box_iou(boxes_s, boxes_s) > iou_thresh) & (pos[:, None] < pos[None, :])


def nms_keep_plain(boxes_s, valid_s, iou_thresh: float, n_out: int) -> torch.Tensor:
    """Jacobi sweeps ``keep ← valid & ¬(keepᵀ·sup)`` to the fixpoint →
    (..., N) bool. ``n_out`` is unused: the full fixpoint is kept."""
    del n_out
    sup = suppression(boxes_s, iou_thresh).float()
    keep = valid_s
    for _ in range(boxes_s.shape[-2] + 1):
        hit = torch.matmul(keep.float()[..., None, :], sup)[..., 0, :]
        new = valid_s & (hit < 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def pack_words(sup: torch.Tensor) -> torch.Tensor:
    """(P, N, N) bool → (P, N, ceil(N/64)) int64: bit c of word w of row i
    is ``sup[i, 64·w + c]``."""
    p, n, _ = sup.shape
    words = -(-n // WORD)
    padded = torch.zeros((p, n, words * WORD), dtype=torch.int64,
                         device=sup.device)
    padded[..., :n] = sup.long()
    shifts = torch.arange(WORD, device=sup.device)
    # distinct powers of two: the sum is their OR, bit 63 the sign bit
    return (padded.reshape(p, n, words, WORD) << shifts).sum(-1)


def nms_keep_bitmask_plain(boxes_s, valid_s, iou_thresh: float,
                           n_out: int) -> torch.Tensor:
    """The kernel's mask and walk in plain torch and Python ints → (P, N)
    bool: the suppression words of :func:`pack_words`; each problem's
    removed bits start at its invalid boxes and the padding past N. Step
    ``s`` decides boxes ``64s .. 64s+63``: the diagonal word is walked bit by
    bit (a box not yet removed is kept and ORs its row's diagonal word in),
    the step's kept bits are trimmed to the lowest ``n_out − count`` once
    they reach the ``n_out``-th kept box, where the walk stops and leaves
    the boxes after it unkept; otherwise the kept rows' later words are ORed
    into the removed bits (the kernel ORs word ``s+1`` first and the rest
    beside the next step's decision: the same ORs)."""
    p, n = valid_s.shape
    words = -(-n // WORD)
    full = (1 << WORD) - 1
    mask = pack_words(suppression(boxes_s, iou_thresh)).tolist()
    valid = valid_s.tolist()
    keep = torch.zeros((p, n), dtype=torch.bool)
    for q in range(p):
        rows, removed = mask[q], [0] * words
        for i in range(words * WORD):
            if i >= n or not valid[q][i]:
                removed[i // WORD] |= 1 << (i % WORD)
        count = 0
        for s in range(words):
            cur = removed[s]
            for c in range(WORD):
                if not (cur >> c) & 1:
                    cur |= rows[s * WORD + c][s] & full
            kept = ~cur & full
            stop = count + bin(kept).count("1") >= n_out
            if stop:  # the lowest n_out - count kept bits
                for _ in range(bin(kept).count("1") - max(n_out - count, 0)):
                    kept &= ~(1 << (kept.bit_length() - 1))
            count += bin(kept).count("1")
            for c in range(WORD):
                if (kept >> c) & 1:
                    keep[q, s * WORD + c] = True
            if stop:
                break
            for w in range(s + 1, words):
                for c in range(WORD):
                    if (kept >> c) & 1:
                        removed[w] |= rows[s * WORD + c][w] & full
    return keep.to(valid_s.device)


def nms_work(keep: torch.Tensor, n_out: int) -> dict:
    """The least work an exact greedy NMS does for a keep mask (P, N) of the
    walk → a dict of integers. ``pairs``: each box up to the problem's
    ``n_out``-th kept one compared with the kept boxes before it;
    ``dense_pairs``: the whole upper triangle, N(N−1)/2 a problem;
    ``flops`` and ``dense_flops``: ``IOU_OPS`` a pair; ``bytes``: the boxes
    (16 bytes) and validity (1) read once, the keep mask (1) written once;
    ``mask_bytes``: the kernel's 64-bit suppression words over the upper
    triangle's tiles; ``steps``: each problem's 64-box steps of the walk (to
    the one that holds its ``n_out``-th kept box, or all ``ceil(N/64)``),
    and ``max_steps``, the most of them: the problems walk at once, one SM
    each, so the walk takes about ``max_steps`` steps' time."""
    p, n = keep.shape
    kept = torch.cumsum(keep.long(), dim=-1)
    before = kept - keep.long()
    # boxes the walk visits: all of them, or up to the n_out-th kept one
    stop = torch.where(kept[:, -1] >= n_out,
                       (kept < n_out).sum(dim=-1) + 1,
                       torch.full((p,), n, device=keep.device))
    visited = torch.arange(n, device=keep.device)[None, :] < stop[:, None]
    pairs = int((before * visited).sum())
    words = -(-n // WORD)
    steps = (-(-stop // WORD)).clamp(min=1).tolist()
    return {"pairs": pairs, "flops": IOU_OPS * pairs,
            "dense_pairs": p * n * (n - 1) // 2,
            "dense_flops": IOU_OPS * p * n * (n - 1) // 2,
            "bytes": p * n * (16 + 1 + 1),
            "mask_bytes": p * WORD * 8 * words * (words + 1) // 2,
            "steps": steps, "max_steps": max(steps, default=0)}


class NmsGreedy:
    """Callable wrapper with a launch counter (``launches``), which rises by
    one per call that launches the kernel (its mask pass and its walk, or
    one of them alone through :meth:`parts`) and nowhere else."""

    name = "nms_greedy"

    def __init__(self):
        self.launches = 0
        self.library = CudaLibrary("nms_greedy.cu", _FUNCTIONS)

    def __call__(self, boxes_s, valid_s, iou_thresh: float,
                 n_out: int) -> torch.Tensor:
        """boxes_s (P, N, 4) float32 sorted by descending score, valid_s
        (P, N) bool → keep (P, N) bool."""
        if boxes_s.device.type == "cpu":
            return nms_keep_plain(boxes_s, valid_s, iou_thresh, n_out)
        if boxes_s.device.type != "cuda":
            raise ValueError(f"nms_greedy: unsupported device {boxes_s.device}")
        self._check(boxes_s, valid_s)
        p, n = valid_s.shape
        dev = boxes_s.device
        keep = torch.empty((p, n), dtype=torch.bool, device=dev)
        if p == 0 or n == 0:
            return keep
        mask = torch.empty((mask_words(p, n),), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            self._raise(self.library.load().nms_greedy(
                boxes_s.data_ptr(), valid_s.data_ptr(), mask.data_ptr(),
                keep.data_ptr(), p, n, n_out, iou_thresh,
                torch.cuda.current_stream(dev).cuda_stream))
        self.launches += 1
        return keep

    def parts(self, boxes_s, valid_s, iou_thresh: float, n_out: int):
        """The mask pass and the walk as two callables on one scratch, for
        timing them apart on CUDA tensors: ``mask_pass()`` fills the mask,
        ``walk()`` returns the keep mask from it; each adds one launch."""
        self._check(boxes_s, valid_s)
        if boxes_s.device.type != "cuda" or not valid_s.numel():
            raise ValueError("parts: needs non-empty CUDA tensors")
        p, n = valid_s.shape
        dev = boxes_s.device
        keep = torch.empty((p, n), dtype=torch.bool, device=dev)
        mask = torch.empty((mask_words(p, n),), dtype=torch.int64, device=dev)
        lib = self.library.load()

        def mask_pass():
            with torch.cuda.device(dev):
                self._raise(lib.nms_mask(
                    boxes_s.data_ptr(), mask.data_ptr(), p, n, iou_thresh,
                    torch.cuda.current_stream(dev).cuda_stream))
            self.launches += 1

        def walk():
            with torch.cuda.device(dev):
                self._raise(lib.nms_walk(
                    mask.data_ptr(), valid_s.data_ptr(), keep.data_ptr(), p, n,
                    n_out, torch.cuda.current_stream(dev).cuda_stream))
            self.launches += 1
            return keep

        return mask_pass, walk

    @staticmethod
    def _raise(err: int):
        if err != 0:
            raise RuntimeError(f"nms_greedy launch failed: cudaError_t {err}")

    @staticmethod
    def _check(boxes_s, valid_s):
        if (boxes_s.dim() != 3 or boxes_s.shape[-1] != 4
                or boxes_s.dtype != torch.float32):
            raise ValueError("boxes_s must be (P, N, 4) float32, got "
                             f"{boxes_s.dtype} {tuple(boxes_s.shape)}")
        p, n = boxes_s.shape[:2]
        if valid_s.dtype != torch.bool or tuple(valid_s.shape) != (p, n):
            raise ValueError(f"valid_s must be (P, N) = {(p, n)} bool, got "
                             f"{valid_s.dtype} {tuple(valid_s.shape)}")
        if p > 65535 or -(-n // WORD) > 28000 or p * n >= 2**31:
            raise ValueError("P must be at most 65535, ceil(N/64) at most "
                             "28000 (the walk's removed bits in shared "
                             "memory) and P·N below 2^31")
        if valid_s.device != boxes_s.device:
            raise ValueError(f"valid_s is on {valid_s.device}, boxes_s on "
                             f"{boxes_s.device}")
        for name, t in (("boxes_s", boxes_s), ("valid_s", valid_s)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if boxes_s.data_ptr() % 16:
            raise ValueError("boxes_s must be 16-byte aligned")


nms_greedy = NmsGreedy()
