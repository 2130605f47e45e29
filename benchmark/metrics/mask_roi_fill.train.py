"""The share of padded work that is real: positive sampled ROIs over the mask-
head slots a step computes (``n_pos_cap`` an image), from the program's
counters over the spanned stretch (``benchmark/spans.py``). None without the
program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.fill(r, "mask_rois_pos", "mask_roi_slots")
