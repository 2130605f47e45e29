"""The share of the detection slots that pass 2's head runs on: the rows
the head computes (``head_rows``) over the slots a request returns
(``detection_slots``, ``max_detections`` an image), from the program's
counters over the spanned stretch (``benchmark/spans.py``). Below 1 where
fewer (class, box) pairs survive per-class NMS, by shape, than there are
slots. None without the program's tracer, a card, or a program that does
not count the head's rows."""

from benchmark import spans


def read(r):
    out = spans.result(r)
    if out is None or "head_rows" not in out["summary"]["counters"]:
        return None
    return spans.fill(r, "head_rows", "detection_slots")
