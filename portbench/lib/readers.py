"""The arithmetic of the per-layer metrics, which the small readers under
``metrics/`` call.  Each returns None where its run holds nothing to read
(an entry that was not called, an untraced run), never 0."""

from __future__ import annotations

from portbench.lib.bounds import seconds
from portbench.lib.common import PEAK_BF16


def span_ms(run, name: str):
    """Host milliseconds a call in ``name``, over all of the window's
    calls."""
    return run.span_ms(name)


def roofline(run, kernel: str):
    """100 × the calls' least time ÷ their device time under the entry."""
    calls = run.bounds.get(kernel)
    if not calls or run.trace is None:
        return None
    t = run.trace["entry_s"].get(kernel, 0.0)
    if t <= 0:
        return None
    return 100.0 * sum(seconds(*c) for c in calls) / t


def idle_share(run):
    """100 × (1 − device busy ÷ traced window)."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def mfu(run):
    """100 × model FLOPs of the traced window's calls ÷ (the device's busy
    seconds in it × bf16 peak): the whole step's share of the peak while
    the device works, which the profiler's cost to the host leaves alone
    (``idle_share`` gives the rest of the window)."""
    if run.trace is None or not run.flops or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * run.flops * len(run.calls) / (run.trace["busy_s"]
                                                 * PEAK_BF16)


def h2d_ms(run):
    """Device milliseconds of host-to-device copies a call."""
    if run.trace is None or not run.calls:
        return None
    return 1e3 * run.trace["h2d_s"] / len(run.calls)
