"""Device ms a step of the optimizer step and the step counter: the median over
the spanned stretch's steps of the time between the stage's two CUDA events,
captured into the replayed graph with tracing on (``benchmark/spans.py``).
None without the program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.stage_ms(r, "optimizer")
