"""K9 backward's share of its roofline in a training window
(kernels/k9b.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k9b")
