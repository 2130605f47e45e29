"""The whole step's share of the card's peak, in %: the model's FLOPs of
one step (fixed in the configuration's file, counted once on the
reference: convolutions and matrix products, forward and backward; NMS
and ROIAlign left out), times the optimizer steps completed in the window, over the window's seconds, over
the dense peak of the run's math mode. None for a card the peak table
lacks."""


def read(r):
    if r.peaks is None or r.units == 0:
        return None
    return 100.0 * r.unit_flops * r.units / r.window_s / getattr(r.peaks, r.math)
