"""Device ms a request of pass 2 (``predict_masks``: the mask or keypoint head
on the ``head_rows`` rows of the detection slots, the last row repeated into
the slots after them): the median over the spanned stretch's requests of
the time between the stage's two CUDA events, captured into the replayed
graph with tracing on (``benchmark/spans.py``). None without the program's
tracer or a card."""

from benchmark import spans


def read(r):
    return spans.stage_ms(r, "mask_head")
