"""K5b's share of its roofline in a training window (kernels/k5b.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k5b")
