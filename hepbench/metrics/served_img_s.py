"""Correct answers that reached the host in the window, over the window's
seconds."""

from hepbench.readings import correct_in_window


def read(run):
    return correct_in_window(run) / run.seconds
