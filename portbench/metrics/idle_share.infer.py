"""Share of the traced inference window with no device activity."""

from portbench.lib import readers


def read(run):
    return readers.idle_share(run)
