"""Timing helpers shared by ``chip_smoke.py`` and ``tools/kernel_times.py``,
and the K9 shapes of one generator pass that both time.

Needs only ``torch`` (imported on first use), so ``tools/kernel_times.py``
uses this copy whichever checkout it times.
"""

from __future__ import annotations

import subprocess
import time

# (name, (Cin, H, W, Cout)) of the 8 K9 calls of one pass of the CLI's 512
# generator (each ResBlockUp's conv2), in call order; chip_smoke.py holds
# them against a recorded pass
K9_PASS = (
    ("blk1", (512, 8, 4, 512)), ("blk2", (256, 16, 8, 256)),
    ("blk3a", (256, 32, 16, 256)), ("blk3b", (256, 64, 32, 256)),
    ("blk4", (128, 128, 64, 128)), ("blk5", (128, 256, 128, 128)),
    ("blk6", (64, 512, 256, 64)), ("blk3_mesh", (64, 32, 16, 64)),
)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, warm (the host's launch work included where it is
    slower than the device's)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph and replayed between events, so that no host work sits
    between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host milliseconds per call of ``fn``: the host clock over ``reps``
    calls with no synchronisation among them (what a caller's thread
    spends launching)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / reps


def spread(xs) -> dict:
    """min, median (the middle one, or the upper of two) and max."""
    xs = sorted(xs)
    return dict(min=xs[0], median=xs[len(xs) // 2], max=xs[-1])
