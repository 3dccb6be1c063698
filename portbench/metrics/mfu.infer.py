"""Model FLOPs of the inference window's calls over the device's busy
time at the bf16 peak."""

from portbench.lib import readers


def read(run):
    return readers.mfu(run)
