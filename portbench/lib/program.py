"""The program's own spans and copy counters in a traced window: the
``im23d.<layer>.<phase>`` ranges that ``im23d_tpu_torch.core.profiler.span``
opens inside the trainers, the feeds and the FID path, read over the
``portbench.window`` range, and its ``COUNTERS`` taken around the window.

For each span name it gives the device seconds (the device operations
launched while a range of that name was open, its children's included),
the host seconds (the ranges' length), the ranges' count and the launches
(runtime calls whose device operation is in the trace).  A device
operation belongs to the ranges open on its launching thread when the
launch happened; a launch on a thread with no open ``im23d.*`` range (the
autograd engine's, which runs ``backward()`` while the main thread waits
inside ``im23d.train.backward``) belongs to the ranges open on the
window's thread at that moment.  A program without spans or counters (an
older checkout) reads as nothing: ``read_spans`` gives no spans when asked
for no count check, ``counters`` an empty dict.
"""

from __future__ import annotations

import torch

from portbench.lib.trace import PREFIX, SPAN, TraceIncomplete

PROGRAM = "im23d."
STEP = PROGRAM + "train.step"


def counters() -> dict:
    """The program's copy counters now, or {} where it has none."""
    try:
        from im23d_tpu_torch.core.profiler import COUNTERS
    except ImportError:
        return {}
    return dict(COUNTERS)


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before if k in after}


def _chains(ranges, times):
    """For each of the ascending ``times``, the names of the ranges open at
    it, outermost first; ``ranges`` are (start, end, name), nested."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            r = ranges[i]
            while stack and stack[-1][1] < r[0]:
                stack.pop()
            stack.append(r)
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(r[2] for r in stack))
    return out


def _parse(events):
    """(window (start, end, thread), program ranges and benchmark spans by
    thread, runtime calls by correlation id, device operations)."""
    window, prog, bench, runtime, dev = [], {}, {}, {}, []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation():
                r = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
                tid = e.start_thread_id()
                if name == PREFIX + "window":
                    window.append((r[0], r[1], tid))
                elif name.startswith(PROGRAM):
                    prog.setdefault(tid, []).append(r)
                elif name.startswith(PREFIX + SPAN):
                    bench.setdefault(tid, []).append(r)
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = (e.start_ns(),
                                               e.start_thread_id())
        elif not e.is_user_annotation():
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
    if len(window) != 1:
        raise TraceIncomplete(f"expected one {PREFIX}window range, got "
                              f"{len(window)}")
    return window[0], prog, bench, runtime, dev


def _attribute(prog, runtime, dev, main_tid):
    """Each device operation with a runtime record, as (seconds, the chain
    of program ranges open at its launch)."""
    by_tid: dict = {}
    for s, e, corr in dev:
        host = runtime.get(corr)
        if host is not None:
            by_tid.setdefault(host[1], []).append((host[0], (e - s) / 1e9))
    out, orphans = [], []
    for tid, ops in by_tid.items():
        ops.sort()
        chains = _chains(prog.get(tid, ()), [t for t, _ in ops])
        for (t, sec), chain in zip(ops, chains):
            if chain or tid == main_tid:
                out.append((sec, chain))
            else:
                orphans.append((t, sec))
    orphans.sort()
    chains = _chains(prog.get(main_tid, ()), [t for t, _ in orphans])
    out += [(sec, chain) for (_, sec), chain in zip(orphans, chains)]
    return out


def read_spans(prof, calls: int = 0, count: str | None = None) -> dict:
    """The program's spans over the window of ``prof`` (see the module's
    docstring).  With ``count``, raises ``TraceIncomplete`` unless the
    window's thread holds ``calls`` ranges of that name."""
    return spans_of(prof.profiler.kineto_results.events(), calls, count)


def spans_of(events, calls: int = 0, count: str | None = None) -> dict:
    """``read_spans`` on the profiler's event records: ``spans`` (name ->
    device_s, host_s, count, launches), ``unphased_share`` (the part of
    ``im23d.train.step``'s device time launched in none of its phases,
    or None) and ``idle_by_span`` (idle seconds of the device by the
    innermost span open on the window's thread when each gap began,
    largest first)."""
    (w0, w1, main_tid), prog, bench, runtime, dev = _parse(events)
    prog = {tid: [r for r in rs if w0 <= r[0] <= w1]
            for tid, rs in prog.items()}
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    if count is not None:
        n = sum(r[2] == count for r in prog.get(main_tid, ()))
        if n != calls:
            raise TraceIncomplete(f"{count}: {n} ranges in a window of "
                                  f"{calls} calls")
    spans: dict = {}
    for rs in prog.values():
        for a, b, name in rs:
            s = spans.setdefault(name, dict(device_s=0.0, host_s=0.0,
                                            count=0, launches=0))
            s["host_s"] += (b - a) / 1e9
            s["count"] += 1
    unphased = 0.0
    for sec, chain in _attribute(prog, runtime, dev, main_tid):
        for name in set(chain):
            spans[name]["device_s"] += sec
            spans[name]["launches"] += 1
        if chain and chain[-1] == STEP:
            unphased += sec
    step_s = spans.get(STEP, {}).get("device_s", 0.0)
    return dict(spans=spans,
                unphased_share=unphased / step_s if step_s > 0 else None,
                idle_by_span=_idle_by_span(dev, prog, bench, main_tid, w0,
                                           w1))


def _idle_by_span(dev, prog, bench, tid, w0, w1):
    """[label, seconds] of the window's idle gaps summed by the innermost
    program or benchmark span open on thread ``tid`` when each began
    ("other" where none was), largest first."""
    gaps, cur = [], w0
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e, _ in dev):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    ranges = list(prog.get(tid, ())) + list(bench.get(tid, ()))
    chains = _chains(ranges, [a for a, _ in gaps])
    out: dict = {}
    for (a, b), chain in zip(gaps, chains):
        label = chain[-1] if chain else "other"
        out[label] = out.get(label, 0.0) + (b - a) / 1e9
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
