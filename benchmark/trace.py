"""What the profiler saw over a stretch of work: every device activity
with its interval, the host's operations, and each kernel tied to the
operations that launched it (an eager stretch; a replayed CUDA graph's
kernels carry no operation). Read by the per-layer metrics."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import NamedTuple

import torch

from benchmark.window import gaps, union_length


class Trace(NamedTuple):
    device: list  # (name, start_us, end_us) of every kernel, copy and set
    host: list  # (name, start_us, end_us) of every host operation
    kernels: list  # (kernel name, device µs, names of its op and its parents)
    wall_s: float  # the stretch on the host's clock, synchronised at both ends
    units: int  # requests or steps in the stretch
    untraced_wall_s: float  # the same work just before, untraced
    annotations: tuple = ()  # (name, start_us, end_us) of the entries of
    #   ``device`` that are the profiler's device-side copies of host
    #   ranges (``nccl:all_reduce`` and the like), not device work

    def busy_s(self) -> float:
        """Seconds in which some device activity ran: the union of their
        intervals, so overlapping ones count once."""
        return union_length((s, e) for _, s, e in self.device) / 1e6

    def device_ms_named(self, names) -> float:
        """Device ms a unit of the device activities whose name holds one
        of ``names``: a hand-written kernel launched outside any operation
        is found this way."""
        us = sum(e - s for name, s, e in self.device
                 if any(n in name for n in names))
        return us / 1e3 / self.units

    def device_ms_where(self, keep) -> float:
        """Device ms a unit of the kernels for which ``keep(kernel name,
        op names)`` holds."""
        us = sum(d for name, d, ops in self.kernels if keep(name, ops))
        return us / 1e3 / self.units


def record(work, units: int) -> Trace:
    """Run ``work()`` once untraced and timed, then again under
    ``torch.profiler`` (host and device) → :class:`Trace`. The tracer
    adds host time to every kernel it sees, so a share of wall time
    divides by the untraced run's."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    t0 = time.perf_counter()
    work()
    sync()
    untraced = time.perf_counter() - t0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        work()
        sync()
        wall = time.perf_counter() - t0
    device, host, kernels, annotations = [], [], [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append((e.name, e.time_range.start, e.time_range.end))
            if getattr(e, "is_user_annotation", False):
                annotations.append(device[-1])
            continue
        if e.is_async:
            continue
        host.append((e.name, e.time_range.start, e.time_range.end))
        if e.kernels:
            names, parent = [e.name], e.cpu_parent
            while parent is not None:
                names.append(parent.name)
                parent = parent.cpu_parent
            kernels.extend((k.name, k.duration, tuple(names)) for k in e.kernels)
    return Trace(device, host, kernels, wall, units, untraced, tuple(annotations))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, seconds each, at most ``top`` each."""
    by_name = defaultdict(float)
    for name, s, e in trace.device:
        by_name[name[:120]] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    if not trace.device:
        return {"device_ops": [], "idle_gaps": []}
    start = min(s for _, s, _ in trace.device)
    end = max(e for _, _, e in trace.device)
    idle = sorted(gaps([(s, e) for _, s, e in trace.device], start, end),
                  key=lambda g: g[0] - g[1])[:top]
    out = []
    for g0, g1 in idle:
        mid = (g0 + g1) / 2
        around = [(e - s, name) for name, s, e in trace.host if s <= mid <= e]
        label = min(around)[1] if around else "host: no operation"
        out.append([label[:120], (g1 - g0) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": out}
