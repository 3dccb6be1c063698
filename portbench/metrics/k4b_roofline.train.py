"""K4b's share of its roofline in a training window (kernels/k4b.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k4b")
