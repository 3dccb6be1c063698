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


def peak_mib(fn) -> float:
    """The device memory one call of ``fn`` adds at its peak, MiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def spread(xs) -> dict:
    """min, median (the middle one, or the upper of two) and max."""
    xs = sorted(xs)
    return dict(min=xs[0], median=xs[len(xs) // 2], max=xs[-1])


# peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, float32
# FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# float32 operations: per splatted point 8 corners x 4 (weights, multiply,
# add); per gathered point 8 corners x 14 (three derivative products, one
# weight product, their sums, the mask)
SPLAT_OPS, GATHER_OPS = 32, 112


def splat_backward_work(gz, gy, gx, c, size: int, K: int,
                        need_dc: bool = True) -> tuple[int, int]:
    """(bytes, float32 operations) that K6 (``K = 0``) or K7 backward (K
    taps) needs on these operands, counted from the data: the points'
    planes read and the 3 or 4 gradient planes written; of the cotangent
    only what the gathered points (every point with ``need_dc``, else
    those of weight != 0) reach: K6 reads the 32-byte sectors that hold
    their corners, K7 the z-planes that hold a corner, each once (the Y/X
    transposes run over those planes, 4 K + 1 operations a voxel); the
    splat of the points of weight != 0 and the gather."""
    import torch

    S = int(size)
    B, N = gz.shape
    live = torch.ones_like(c, dtype=torch.bool) if need_dc else c != 0
    n_gather = int(live.sum())
    coords = torch.stack((gz, gy, gx), dim=-1)[live]  # (M, 3)
    batch = torch.arange(B, device=gz.device)[:, None].expand(B, N)[live]
    base = torch.floor(coords).to(torch.int64)
    nbytes = 4 * 4 * B * N + 4 * (4 if need_dc else 3) * B * N
    ops = SPLAT_OPS * int((c != 0).sum()) + GATHER_OPS * n_gather
    if n_gather == 0:
        return nbytes, ops
    offs = torch.tensor([[dz, dy, dx] for dz in (0, 1) for dy in (0, 1)
                         for dx in (0, 1)], device=gz.device)
    idx = (base[:, None, :] + offs).clamp(0, S - 1)  # (M, 8, 3)
    plane = batch[:, None] * S + idx[..., 0]  # (M, 8)
    if K:
        planes = int(torch.unique(plane).numel())
        nbytes += 4 * planes * S * S + 4 * K
        ops += (4 * K + 1) * planes * S * S
    else:
        flat = (plane * S + idx[..., 1]) * S + idx[..., 2]
        nbytes += 32 * int(torch.unique(flat // 8).numel())
    return nbytes, ops
