"""The share of the detection slots that hold a detection: valid detections
over the slots a request returns (``max_detections``), from the program's
counters over the spanned stretch (``benchmark/spans.py``). Pass 2 runs its
head on the ``head_rows`` rows of those slots, not on every slot
(``head_row_share.serve``). None without the program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.fill(r, "detections_valid", "detection_slots")
