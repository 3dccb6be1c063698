"""K8dw's share of its roofline in a training window (kernels/k8dw.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k8dw")
