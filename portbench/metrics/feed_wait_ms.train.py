"""Host ms a training iteration waits for its batch from the feed."""

from portbench.lib import readers


def read(run):
    return readers.span_ms(run, "feed_wait")
