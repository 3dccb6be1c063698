"""Host ms a training iteration spends inside ``train_step``."""

from portbench.lib import readers


def read(run):
    return readers.span_ms(run, "dispatch")
