"""Device ms a request of the box branch (``roi_features``, the 7×7 pool,
``head_box`` and the softmax): the median over the spanned stretch's
requests of the time between the stage's two CUDA events, captured into the
replayed graph with tracing on (``benchmark/spans.py``). None without the
program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.stage_ms(r, "box_head")
