"""The metric arithmetic on synthetic records: the whole-window rate, the
95th percentile over every call, the idle share as the union of device
intervals, the roofline share, and the trace reader's attribution and its
refusal of an incomplete trace."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from portbench.lib import readers
from portbench.lib.common import p95, union_seconds
from portbench.lib.harness import Run
from portbench.lib.trace import TraceIncomplete, read_profile
from portbench.run import end_to_end


def test_p95_is_nearest_rank_over_all_calls():
    assert p95(range(1, 101)) == 95
    assert p95([5.0]) == 5.0
    assert p95([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 100]) == 100


def test_union_of_intervals():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert union_seconds(ivs, 0, 10) == pytest.approx(3 + 1 + 1)
    assert union_seconds([], 0, 1) == 0.0


def _window(durations, samples_per_call=4, tail=0.5):
    calls, t = [], 100.0
    for d in durations:
        calls.append((t, t + d, {"dispatch": d / 2}))
        t += d
    return dict(start=100.0, start_wall=1.0, window_s=t + tail - 100.0,
                calls=calls)


def test_whole_window_rates_and_tail():
    cell = SimpleNamespace(samples_per_call=4)
    w = _window([0.1] * 19 + [1.0])
    out = end_to_end("infer", cell, w, 7.0)
    assert out["setup_s"] == (7.0, "s")
    assert out["infer_samples_per_s"][0] == pytest.approx(80 / w["window_s"])
    assert out["infer_ms_p95"][0] == pytest.approx(100.0)
    out = end_to_end("train", cell, w, 7.0)
    assert out["train_samples_per_s"][0] == pytest.approx(80 / 3.4)


def test_readers_on_a_run():
    w = _window([0.2] * 10)
    trace = dict(window_s=2.0, busy_s=1.5, h2d_s=0.01,
                 entry_s={"k9": 0.004})
    run = Run(SimpleNamespace(), w, trace, {"k9": [(3.35e9, 0, 989e12)]})
    run.flops = 9.89e12
    assert readers.idle_share(run) == pytest.approx(25.0)
    assert readers.h2d_ms(run) == pytest.approx(1.0)
    assert readers.span_ms(run, "dispatch") == pytest.approx(100.0)
    assert readers.mfu(run) == pytest.approx(100 * 10 * 9.89e12
                                             / (1.5 * 989e12))
    assert readers.roofline(run, "k9") == pytest.approx(25.0)
    assert readers.roofline(run, "k8") is None
    untraced = Run(SimpleNamespace(), w, None, None)
    assert readers.idle_share(untraced) is None
    assert readers.mfu(untraced) is None


class _Ev:
    def __init__(self, name, start, dur, dev, corr=0, tid=1, ua=False):
        self._v = (name, start, dur, dev, corr, tid, ua)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _events(drop_kernel: bool = False):
    ev = [_Ev("portbench.window", 0, 1000, CPU, ua=True),
          _Ev("portbench.span.dispatch", 10, 500, CPU, ua=True),
          _Ev("portbench.k9", 100, 50, CPU, ua=True),
          _Ev("cudaLaunchKernel", 120, 5, CPU, corr=7),
          _Ev("portbench.k9", 300, 50, CPU, ua=True),
          _Ev("cudaLaunchKernel", 320, 5, CPU, corr=8),
          _Ev("cudaLaunchKernel", 400, 5, CPU, corr=9),
          _Ev("Memcpy HtoD (Pageable -> Device)", 130, 20, CUDA, corr=10),
          _Ev("other_kernel", 500, 100, CUDA, corr=9),
          _Ev("portbench.k9", 200, 30, CUDA, ua=True)]
    ev.append(_Ev("k9_kernel", 200, 30, CUDA, corr=7))
    if not drop_kernel:
        ev.append(_Ev("k9_kernel", 400, 40, CUDA, corr=8))
    return ev


def test_trace_attribution_and_busy():
    wraps = SimpleNamespace(specs={"k9": None})
    out = read_profile(_prof(_events()), wraps, {"k9": 2})
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["entry_s"]["k9"] == pytest.approx(70e-9)
    assert out["busy_s"] == pytest.approx((20 + 30 + 40 + 100) * 1e-9)
    assert out["h2d_s"] == pytest.approx(20e-9)
    names = [n for n, _ in out["breakdown"]["device_ops"]]
    assert names[0] == "other_kernel"
    gaps = out["breakdown"]["idle_gaps"]
    assert max(g for _, g in gaps) == pytest.approx(400e-9)
    assert {label for label, _ in gaps} <= {"dispatch", "other"}


def test_trace_refuses_missing_records():
    wraps = SimpleNamespace(specs={"k9": None})
    with pytest.raises(TraceIncomplete):
        read_profile(_prof(_events(drop_kernel=True)), wraps, {"k9": 2})
    with pytest.raises(TraceIncomplete):
        read_profile(_prof(_events()), wraps, {"k9": 3})


def test_roofline_never_reads_zero():
    run = Run(SimpleNamespace(), _window([0.1]), dict(
        window_s=1.0, busy_s=0.5, h2d_s=0.0, entry_s={"k4f": 0.0}),
        {"k4f": [(1.0, 0, 1.0)]})
    assert readers.roofline(run, "k4f") is None
    assert not math.isnan(readers.idle_share(run))
