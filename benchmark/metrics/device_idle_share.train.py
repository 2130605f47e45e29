"""The share of the wall time of the path the window drives (replayed
CUDA graphs) in which no kernel, copy or set ran on the device, in %: one
minus the union of their intervals over the wall time of the same traced
stretch, a whole call of K steps. Busy and wall come from one stretch:
the tracer can lengthen the replayed kernels by more than the device
idles, so over an untraced stretch's wall time the share can fall below
zero."""


def read(r):
    if r.graphed is None or not r.graphed.device:
        return None
    return 100.0 * (1.0 - r.graphed.busy_s() / r.graphed.wall_s)
