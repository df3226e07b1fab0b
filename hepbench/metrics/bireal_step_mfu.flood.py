"""Whole step: correct answers in the window x the least time the card
could spend on an image (its 1-bit operations at the frozen 1-bit rate
plus its real FLOPs at 67e12 FLOP/s, ``roofline_bireal.image_bound_s``),
over the window's seconds."""

from hepbench import roofline_bireal as rb
from hepbench.readings import correct_in_window


def read(run):
    busy = correct_in_window(run) * rb.image_bound_s(run.layers)
    return 100.0 * busy / run.seconds
