"""The arithmetic of a measured window, apart from any device: rates over
whole units, percentiles over every request, the union of device
intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0–100) of ``values`` by linear
    interpolation between the closest ranks (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("percentile of no values")
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def rate(units_done: int, per_unit: float, seconds: float) -> float:
    """Work a second over the window: whole units completed (chains,
    requests) times the work of one, over the window's seconds."""
    if seconds <= 0:
        raise ValueError("a window has positive length")
    return units_done * per_unit / seconds


def union_length(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: time in which
    at least one of them runs, overlaps counted once."""
    total = 0.0
    cur_start = cur_end = None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(intervals, start: float, end: float):
    """The stretches of ``[start, end]`` that no interval covers, as
    ``(gap_start, gap_end)`` in time order."""
    out = []
    at = start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]
