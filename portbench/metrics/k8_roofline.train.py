"""K8's share of its roofline in a training window (kernels/k8.py)."""

from portbench.lib import readers


def read(run):
    return readers.roofline(run, "k8")
