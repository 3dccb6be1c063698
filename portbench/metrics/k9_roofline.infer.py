"""K9's share of its roofline in an inference window (kernels/k9.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k9")
