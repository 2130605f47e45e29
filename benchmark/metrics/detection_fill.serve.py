"""The share of padded work that is real: valid detections over the detection
slots every request computes pass 2 on (``max_detections``), from the
program's counters over the spanned stretch (``benchmark/spans.py``). None
without the program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.fill(r, "detections_valid", "detection_slots")
