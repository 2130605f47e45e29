"""The share of padded work that is real: kept proposals over the proposal
slots a request computes (the RPN's ``n_post`` an image), from the program's
counters over the spanned stretch (``benchmark/spans.py``). None without the
program's tracer or a card."""

from benchmark import spans


def read(r):
    return spans.fill(r, "proposals_kept", "proposal_slots")
