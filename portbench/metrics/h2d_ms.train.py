"""Device ms of host-to-device copies a training iteration."""

from portbench.lib import readers


def read(run):
    return readers.h2d_ms(run)
