"""Whole step: correct answers in the window x operations per image, over
the window's seconds x the frozen 1-bit rate (roofline.B1_OPS_PER_S)."""

from hepbench import roofline
from hepbench.readings import correct_in_window


def read(run):
    ops = correct_in_window(run) * roofline.operations(run.layers)
    return 100.0 * ops / (run.seconds * roofline.B1_OPS_PER_S)
