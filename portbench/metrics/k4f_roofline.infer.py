"""K4f's share of its roofline in an inference window (kernels/k4f.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k4f")
