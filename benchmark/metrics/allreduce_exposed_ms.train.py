"""Device ms a step of NCCL's all-reduce kernels during which no other
kernel ran on rank 0, in its uncaptured traced steps: the union of the
all-reduce kernels' and the other kernels' intervals less the other
kernels' union (``benchmark/window.py``). Copies and sets, and the
profiler's device-side copies of host ranges, are not kernels. The part of
``allreduce_device_ms.train`` that overlapping the exchange with the
backward would hide. None where no all-reduce kernel ran."""

from benchmark.window import union_length


def read(r):
    if r.eager is None:
        return None
    skip = set(r.eager.annotations)
    reduce, other = [], []
    for name, s, e in r.eager.device:
        if (name, s, e) in skip or name.startswith(("Memcpy", "Memset")):
            continue
        if name.startswith("nccl") and "AllReduce" in name:
            reduce.append((s, e))
        else:
            other.append((s, e))
    if not reduce:
        return None
    exposed_us = union_length(reduce + other) - union_length(other)
    return exposed_us / 1e3 / r.eager.units
