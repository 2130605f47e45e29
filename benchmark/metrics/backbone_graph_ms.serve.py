"""Device ms a request of the backbone, the FPN and the RPN head
(``model(images)``): the median over the spanned stretch's requests of the
time between the stage's two CUDA events, captured into the replayed graph
with tracing on (``benchmark/spans.py``). None without the program's tracer
or a card."""

from benchmark import spans


def read(r):
    return spans.stage_ms(r, "backbone")
