"""The reading of the program's spans (``lib/program.py``) on synthetic
records, K9 backward's kernel file, and ``phases.py``'s second reading
of a traced window at a tiny size on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench.lib import program
from portbench.lib.harness import Run, metric_reader
from portbench.lib.trace import TraceIncomplete, kernel_spec
from portbench.tests.test_portbench_metrics import CPU, CUDA, _Ev, _prof

MAIN, AUTOGRAD = 1, 2


def _events(steps: int = 1):
    """A window (0–1000) on thread 1 with a benchmark span ``dispatch``
    (10–900) around ``im23d.train.step`` (20–800), which holds
    ``forward`` (30–200) and ``backward`` (300–600); ``backward()``'s
    launches run on thread 2."""
    ev = [_Ev("portbench.window", 0, 1000, CPU, ua=True),
          _Ev("portbench.span.dispatch", 10, 890, CPU, ua=True),
          _Ev("im23d.train.forward", 30, 170, CPU, ua=True),
          _Ev("im23d.train.backward", 300, 300, CPU, ua=True),
          # forward: two launches on the main thread
          _Ev("cudaLaunchKernel", 40, 5, CPU, corr=1),
          _Ev("cudaLaunchKernel", 150, 5, CPU, corr=2),
          # in the step, in no phase
          _Ev("cudaLaunchKernel", 250, 5, CPU, corr=3),
          # backward: the autograd thread, no program range open there
          _Ev("cudaLaunchKernel", 350, 5, CPU, corr=4, tid=AUTOGRAD),
          # outside the step, inside the benchmark's span
          _Ev("cudaLaunchKernel", 850, 5, CPU, corr=5),
          _Ev("k_a", 50, 100, CUDA, corr=1),
          _Ev("k_b", 160, 30, CUDA, corr=2),
          _Ev("k_c", 260, 20, CUDA, corr=3),
          _Ev("k_d", 400, 190, CUDA, corr=4),
          _Ev("k_e", 860, 10, CUDA, corr=5),
          _Ev("portbench.window", 200, 30, CUDA, ua=True)]
    ev += [_Ev("im23d.train.step", 20, 780, CPU, ua=True)] * steps
    return ev


def test_device_time_goes_to_the_innermost_span_and_its_parents():
    out = program.spans_of(_events())
    s = out["spans"]
    assert s["im23d.train.forward"]["device_s"] == pytest.approx(130e-9)
    assert s["im23d.train.forward"]["launches"] == 2
    assert s["im23d.train.step"]["device_s"] == pytest.approx(340e-9)
    assert s["im23d.train.step"]["launches"] == 4
    assert s["im23d.train.step"]["count"] == 1
    assert s["im23d.train.step"]["host_s"] == pytest.approx(780e-9)
    assert out["unphased_share"] == pytest.approx(20 / 340)
    assert set(s) == {"im23d.train.step", "im23d.train.forward",
                      "im23d.train.backward"}


def test_autograd_thread_launches_go_to_the_main_threads_span():
    s = program.spans_of(_events())["spans"]["im23d.train.backward"]
    assert s["device_s"] == pytest.approx(190e-9)
    assert s["launches"] == 1


def test_a_span_on_the_launching_thread_comes_first():
    ev = _events() + [_Ev("im23d.train.ema", 340, 30, CPU, ua=True,
                          tid=AUTOGRAD)]
    s = program.spans_of(ev)["spans"]
    assert s["im23d.train.ema"]["device_s"] == pytest.approx(190e-9)
    assert s["im23d.train.backward"]["device_s"] == 0.0


def test_count_span_must_match_the_calls():
    assert program.spans_of(_events(), 1, "im23d.train.step")
    with pytest.raises(TraceIncomplete):
        program.spans_of(_events(), 2, "im23d.train.step")
    with pytest.raises(TraceIncomplete):
        program.spans_of(_events(steps=2), 1, "im23d.train.step")
    with pytest.raises(TraceIncomplete):
        program.spans_of(_events()[1:])  # no window


def test_idle_time_is_labelled_by_the_innermost_span():
    idle = program.spans_of(_events())["idle_by_span"]
    # gaps by the span open where each begins: 0–50 none, 150–160 and
    # 190–260 forward, 280–400 the step alone, 590–860 backward (the
    # autograd thread's last kernel ended at 590), 870–1000 the
    # benchmark's span (the step ended at 800)
    assert dict(idle) == pytest.approx({
        "other": 50e-9, "im23d.train.forward": 80e-9,
        "im23d.train.step": 120e-9, "im23d.train.backward": 270e-9,
        "portbench.span.dispatch": 130e-9})
    assert [k for k, _ in idle][:2] == ["im23d.train.backward",
                                        "portbench.span.dispatch"]


def test_read_spans_reads_the_profile():
    out = program.read_spans(_prof(_events()), 1, "im23d.train.step")
    assert out["spans"]["im23d.train.step"]["launches"] == 4


def test_counters_and_their_delta():
    now = program.counters()
    assert set(now) == {"h2d_bytes", "d2h_bytes"}
    assert program.counter_delta({"h2d_bytes": 5, "d2h_bytes": 1},
                                 {"h2d_bytes": 12, "d2h_bytes": 1}) == \
        {"h2d_bytes": 7, "d2h_bytes": 0}
    assert program.counter_delta({}, now) == {}


def test_k9b_reader_reads_nothing_untraced():
    run = Run(SimpleNamespace(), dict(calls=[(0.0, 1.0, {})], window_s=1.0),
              None, None)
    assert metric_reader("k9b_roofline.train")(run) is None


def test_k9b_bound_counts_the_convs_asked_for():
    spec = kernel_spec("k9b")
    x = torch.empty((2, 32, 8, 16), dtype=torch.bfloat16)
    w = torch.empty((16, 32, 3, 3))
    a = b = torch.empty((2, 32))
    dy = torch.empty((2, 16, 8, 16), dtype=torch.bfloat16)
    per_conv = 2 * 9 * 32 * 16 * 2 * 8 * 16
    out = (x, a, b, w)  # dx, da, db, dW
    _, ops, peak = spec.bound((x, a, b, w, dy, "replicate",
                               (True, True, True, True)), out)
    assert ops == 2 * per_conv and peak == 989e12
    _, ops, _ = spec.bound((x, a, b, w, dy, "replicate",
                            (False, False, False, True)), (None,) * 3 + (w,))
    assert ops == per_conv
    nbytes, _, _ = spec.bound((x, None, None, w, dy, "replicate",
                               (True, False, False, False)),
                              (x, None, None, None))
    assert nbytes == 2 * x.nbytes + w.nbytes + dy.nbytes


def test_k9b_counts_calls_where_the_program_keeps_no_counter(monkeypatch):
    from im23d_tpu_torch.ops import conv

    def formula(*args):
        return args

    def backward(ctx, dy):
        return conv._fused_conv_bwd(ctx, dy)

    monkeypatch.setattr(conv, "_fused_conv_bwd", formula)
    monkeypatch.setattr(conv, "_fused_conv_backward", backward)
    kernel_spec("k9b")
    counted = conv._fused_conv_bwd
    assert counted is not formula and backward.launches == 0
    assert backward(1, 2) == (1, 2) and backward.launches == 1
    kernel_spec("k9b")  # a counter there already: left as it is
    assert conv._fused_conv_bwd is counted


def test_phases_reads_a_tiny_traced_window_on_the_cpu():
    from portbench.phases import measure_phases
    from portbench.tests.tiny import tiny_cell

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        files = tiny_cell("cub_gan_512.fid")
        files[1]["model"]["compute_dtype"] = "float32"
        result = measure_phases("cub_gan_512.fid", 2147483917, 1.0,
                                torch.device("cpu"),
                                [("idle_share.infer", "%")], files=files)
    finally:
        torch.set_num_threads(n)
    prog = result["program"]
    assert prog["calls"] == result["attempted"] >= 1
    assert set(prog["spans"]) == {
        "im23d.infer." + p for p in ("sample_z", "generate", "render",
                                     "embed", "to_host")}
    assert all(s["count"] == 1 for s in prog["spans"].values())
    assert prog["copies_per_call"] == {"h2d_bytes": 0, "d2h_bytes": 0}
