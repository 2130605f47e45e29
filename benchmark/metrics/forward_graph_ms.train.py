"""Device ms a step of the forward pass of the backbone, the FPN and the RPN
head: the median over the spanned stretch's steps of the time between the
stage's two CUDA events, captured into the replayed graph with tracing on
(``benchmark/spans.py``). None without the program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.stage_ms(r, "forward")
