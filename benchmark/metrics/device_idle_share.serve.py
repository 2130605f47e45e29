"""The share of the wall time of the path the window drives (replayed
CUDA graphs) in which no kernel, copy or set ran on the device, in %: one
minus the union of their intervals in a traced stretch over the wall time
of the same stretch run untraced just before it (the tracer adds host time
to each replayed kernel, so the traced stretch's own wall time is
longer)."""


def read(r):
    if r.graphed is None or not r.graphed.device:
        return None
    return 100.0 * (1.0 - r.graphed.busy_s() / r.graphed.untraced_wall_s)
