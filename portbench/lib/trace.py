"""The traced run: op-level entries of the program wrapped in the
benchmark's own ``record_function`` ranges, the profiler's records read
back, and the checks that they are whole.

A kernel file ``portbench/kernels/<k>.py`` names the entry to wrap
(``ENTRY``: module and attribute, ``Class.method`` for an autograd
backward), the program's launch counter of that kernel (``COUNTER``) and
``bound(args, result)``, the least seconds the card could take for the
call.  Device time of an entry is the sum of the device operations whose
launching host call lies inside one of its ranges on the same thread, so
a later kernel behind the same entry keeps the metric.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.lib.common import union_seconds

ROOT = Path(__file__).resolve().parents[1]
PREFIX = "portbench."
# the benchmark loop's host spans: portbench.span.<name>
SPAN = "span."


class TraceIncomplete(RuntimeError):
    """The profiler's records disagree with the program's counters."""


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_spec(name: str):
    return load_file(ROOT / "kernels" / f"{name}.py",
                     f"portbench_kernel_{name}")


def _resolve(path: str):
    """'pkg.mod:Attr.sub' -> (owner object, attribute name)."""
    mod_name, attr = path.split(":")
    owner = importlib.import_module(mod_name)
    *parents, last = attr.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, last


def counter(spec) -> int:
    owner, last = _resolve(spec.COUNTER)
    return int(getattr(owner, last).launches)


class KernelWraps:
    """Wraps each named kernel's entry in a ``portbench.<k>`` range and
    keeps each call's bound; ``remove`` restores the entries."""

    def __init__(self, names):
        self.specs = {k: kernel_spec(k) for k in names}
        self.calls = {k: [] for k in names}
        self.active = False
        self._saved = []
        for k, spec in self.specs.items():
            owner, last = _resolve(spec.ENTRY)
            orig = owner.__dict__[last] if isinstance(owner, type) \
                else getattr(owner, last)
            self._saved.append((owner, last, orig))
            fn = orig.__func__ if isinstance(orig, staticmethod) else orig
            wrapped = self._wrap(k, spec, fn)
            setattr(owner, last, staticmethod(wrapped)
                    if isinstance(orig, staticmethod) else wrapped)

    def _wrap(self, k, spec, fn):
        def wrapped(*args, **kwargs):
            if not self.active:
                return fn(*args, **kwargs)
            with record_function(PREFIX + k):
                out = fn(*args, **kwargs)
            self.calls[k].append(spec.bound(args, out))
            return out
        return wrapped

    def counters(self) -> dict:
        return {k: counter(s) for k, s in self.specs.items()}

    def remove(self) -> None:
        for owner, last, orig in self._saved:
            setattr(owner, last, orig)


@contextmanager
def profiled():
    """The profiler over CPU and CUDA activity; yields the profile."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def read_profile(prof, wraps: KernelWraps, launches: dict,
                 main_span: str = "window") -> dict:
    """Device busy time, each wrapped entry's device time, host-to-device
    copy time and the breakdown, over the ``portbench.<main_span>`` range.
    Raises ``TraceIncomplete`` when an entry's ranges do not match its
    launch count or a range holds no device record."""
    evs = prof.profiler.kineto_results.events()
    ranges, runtime, dev = {}, {}, []
    for e in evs:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation() and name.startswith(PREFIX):
                ranges.setdefault(name[len(PREFIX):], []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(),
                     e.start_thread_id()))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = (e.start_ns(),
                                               e.start_thread_id())
        elif not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                        e.correlation_id()))
    if len(ranges.get(main_span, ())) != 1:
        raise TraceIncomplete(f"expected one {PREFIX}{main_span} range, got "
                              f"{len(ranges.get(main_span, ()))}")
    w0, w1, main_tid = ranges[main_span][0]
    window_s = (w1 - w0) / 1e9
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    busy = union_seconds([(s, e) for s, e, _, _ in dev], w0, w1) / 1e9

    entry_s = {k: 0.0 for k in wraps.specs}
    by_tid = {}
    for k in wraps.specs:
        for a, b, tid in ranges.get(k, ()):
            if w0 <= a <= w1:
                by_tid.setdefault(tid, []).append([a, b, k, 0])
    for spans in by_tid.values():
        spans.sort()
    starts = {tid: [r[0] for r in spans] for tid, spans in by_tid.items()}
    for s, e, _, corr in dev:
        host = runtime.get(corr)
        if host is None or host[1] not in by_tid:
            continue
        i = bisect.bisect_right(starts[host[1]], host[0]) - 1
        if i >= 0:
            r = by_tid[host[1]][i]
            if host[0] <= r[1]:
                entry_s[r[2]] += (e - s) / 1e9
                r[3] += 1
    n_ranges = {k: 0 for k in wraps.specs}
    empty = {k: 0 for k in wraps.specs}
    for spans in by_tid.values():
        for _, _, k, hits in spans:
            n_ranges[k] += 1
            empty[k] += hits == 0
    for k in wraps.specs:
        if n_ranges[k] != launches[k] or empty[k]:
            raise TraceIncomplete(
                f"{k}: {launches[k]} launches by the program's counter, "
                f"{n_ranges[k]} traced calls, {empty[k]} of them without a "
                "device record")

    h2d = sum((e - s) / 1e9 for s, e, name, _ in dev if "HtoD" in name)
    by_name = {}
    for s, e, name, _ in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=window_s, busy_s=busy, entry_s=entry_s, h2d_s=h2d,
                breakdown=dict(device_ops=[[n, t] for n, t in top],
                               idle_gaps=_idle_gaps(dev, ranges, main_tid,
                                                    w0, w1)))


def _idle_gaps(dev, ranges, tid, w0, w1, n: int = 10):
    """The longest stretches of the window with no device activity, each
    named by the benchmark span the host thread was in when it began."""
    ivs = sorted((max(s, w0), min(e, w1)) for s, e, _, _ in dev)
    gaps, cur = [], w0
    for s, e in ivs:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    host = sorted((a, b, k[len(SPAN):]) for k, rs in ranges.items()
                  if k.startswith(SPAN) for a, b, t in rs if t == tid)
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        label = "other"
        for s, e, k in host:
            if s <= a <= e:
                label = k
        out.append([label, (b - a) / 1e9])
    return out
