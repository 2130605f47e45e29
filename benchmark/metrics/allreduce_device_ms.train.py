"""Device ms a step in NCCL's all-reduce kernels (the gradients', the
losses' counts and the reported totals), matched by name, in rank 0's
uncaptured traced steps. The profiler's device-side copies of host ranges
(``nccl:all_reduce`` and the like) are not kernels. None where no such
kernel ran (gloo on the CPU)."""


def allreduce_kernels(trace) -> list:
    """(start_us, end_us) of every NCCL all-reduce kernel of ``trace``."""
    skip = set(trace.annotations)
    return [(s, e) for name, s, e in trace.device
            if name.startswith("nccl") and "AllReduce" in name and (name, s, e) not in skip]


def read(r):
    if r.eager is None:
        return None
    us = sum(e - s for s, e in allreduce_kernels(r.eager))
    return us / 1e3 / r.eager.units if us > 0 else None
