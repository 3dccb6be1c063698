"""K5f's share of its roofline in a training window (kernels/k5f.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k5f")
