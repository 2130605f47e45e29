"""Host ms a request inside the program's predict function: the median of its
``predict`` span over the spanned stretch's requests, profiler off
(``benchmark/spans.py``). None without the program's tracer or a card."""

from benchmark import spans


def read(r):
    out = spans.result(r)
    return None if out is None else out["summary"]["spans_ms"]["predict"]["p50"]
