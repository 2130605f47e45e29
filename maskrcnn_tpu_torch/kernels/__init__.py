"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Each wrapper counts the calls that launch its kernel (``launches``). A CUDA
graph launches what its capture recorded, and the capture itself runs
nothing: the graphed train step and the graphed request take the capture's
counts back (:func:`take_back_launches`) and add them again at every
replay (:func:`add_launches`).
"""

from __future__ import annotations

from maskrcnn_tpu_torch.kernels.nms_cuda import nms_greedy
from maskrcnn_tpu_torch.kernels.region_scatter_cuda import region_scatter
from maskrcnn_tpu_torch.kernels.roi_align_cuda import roi_align_fwd

# the hand-written kernels a step or a request can launch
KERNELS = (roi_align_fwd, region_scatter, nms_greedy)


def launch_counts() -> list[int]:
    return [k.launches for k in KERNELS]


def take_back_launches(before: list[int]) -> list[int]:
    """The launches counted since ``before`` (a capture's), taken back from
    the counters → what each replay of that capture adds."""
    counts = [k.launches - n for k, n in zip(KERNELS, before)]
    add_launches([-n for n in counts])
    return counts


def add_launches(counts: list[int]):
    for kernel, n in zip(KERNELS, counts):
        kernel.launches += n
