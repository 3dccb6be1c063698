"""Model FLOPs of the training window's iterations over the device's busy
time at the bf16 peak."""

from portbench.lib import readers


def read(run):
    return readers.mfu(run)
