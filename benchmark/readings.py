"""What a run hands the per-layer metrics' readers
(``metrics/<name>.py``, each ``read(readings) -> float | None``)."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.peaks import Peaks, card_peaks
from benchmark.trace import Trace


def device_peaks() -> Peaks | None:
    """The first card's peaks, None without a card or for one the table
    lacks."""
    return card_peaks(torch.cuda.get_device_name(0)) if torch.cuda.is_available() else None


def math_mode(config: dict) -> str:
    """The run's math mode, a field of :class:`Peaks`, from the
    configuration's file."""
    if config["model"]["dtype"] == "bfloat16":
        return "bfloat16"
    return "tf32" if config.get("tf32") else "float32"


@dataclasses.dataclass
class Readings:
    cell: str
    config: dict  # the configuration's file
    params: dict  # the workload file's traffic parameters
    peaks: Peaks | None  # the card's, None for a card the table lacks
    math: str  # the run's math mode: a field of Peaks
    window_s: float  # the measured window on the host's clock
    units: int  # steps or requests completed in the window
    unit_flops: int  # the model's FLOPs of one step or request
    reserved_peak_bytes: int  # the caching allocator's peak, graph pools included
    graphed: Trace | None  # a traced stretch of the path the window drives
    eager: Trace | None  # a traced stretch of the same work, uncaptured
    window_stats: dict = dataclasses.field(default_factory=dict)  # the
    #   window's own statistics that are not end-to-end metrics
