#!/usr/bin/env python3
"""Where the time of the chairs eval step goes on one GPU (PyTorch port).

For each window of the eval path (the whole eval step with its loss fetch,
then its parts: host->device normalize, model forward, keep mask, the eval
loss with K1 on B*V clouds, and the candidate-sweep loss with K1 on B*V*K
clouds) it prints:

  - wall ms per iteration: host clock over ``--iters`` warm iterations,
    without the profiler, synchronised at the end;
  - device busy ms per iteration: the sum of the device time of every
    kernel, copy and memset that ``torch.profiler`` records over
    ``--iters`` more iterations;
  - idle share = 1 - busy / wall, and the device ops per iteration;
  - the ten device ops that take the most time.

Then the peak device memory of one candidate sweep.  The model has random
weights from the config's seed; the batch is synthetic.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/profile_eval.py [--iters 10]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes  # noqa: E402
from im23d_tpu_torch.losses.effective import unsupervised_loss  # noqa: E402
from im23d_tpu_torch.ops.pointcloud import keep_mask  # noqa: E402
from im23d_tpu_torch.train.shapenet_learner import (  # noqa: E402
    ShapeNetConfig,
    ShapeNetLearner,
)


def _wall_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _device_ops(fn, iters: int):
    """[(name, total device us, count)] over ``iters`` profiled calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def report(title: str, fn, iters: int) -> None:
    wall = _wall_ms(fn, iters)
    ops = _device_ops(fn, iters)
    busy = sum(us for _, us, _ in ops) / 1e3 / iters
    n_ops = sum(c for _, _, c in ops) / iters
    print(f"== {title}: wall {wall:.3f} ms/iter (no profiler), device busy "
          f"{busy:.3f} ms/iter, idle share {1.0 - busy / wall:.3f}, "
          f"{n_ops:.0f} device ops/iter")
    for name, us, _ in sorted(ops, key=lambda o: -o[1])[:10]:
        print(f"    {us / 1e3 / iters:7.3f} ms  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())

    cfg = ShapeNetConfig.chairs()
    learner = ShapeNetLearner(cfg, device="cuda")
    B, V = cfg.batch_size, cfg.num_views
    batch = SyntheticSilhouettes(B, cfg.image_size, V, n_points=512,
                                 seed=2).next_batch()
    with torch.no_grad():
        nb = learner._normalize(batch)
        out = learner.model(nb["images"], nb["pose_input"])
    p, sigma = learner._schedules(learner.step)
    gen = torch.Generator(device="cuda").manual_seed(0)
    keep_w = keep_mask(gen, B, cfg.num_points, p)

    def eval_loss(training: bool, w):
        with torch.no_grad():
            return unsupervised_loss(out, nb["masks"], sigma, w, V,
                                     voxel_size=cfg.voxel_size,
                                     training=training)

    def model_forward():
        with torch.no_grad():
            return learner.model(nb["images"], nb["pose_input"])

    it = args.iters
    report(f"eval_step + loss fetch (bs {B}: {B} + {B * V} images, K1 on "
           f"{B * V} clouds)",
           lambda: float(learner.eval_step(batch)["projection_loss"]), it)
    report("normalize (H2D copy of one uint8 batch + /255)",
           lambda: learner._normalize(batch), it)
    report("model forward (bf16 trunks)", model_forward, it)
    report(f"keep_mask ({B} x {cfg.num_points})",
           lambda: keep_mask(gen, B, cfg.num_points, p), it)
    report(f"eval loss (K1 on {B * V} clouds)",
           lambda: eval_loss(False, keep_w), it)
    report(f"candidate sweep loss (K1 on {B * V * cfg.num_candidates} "
           "clouds)", lambda: eval_loss(True, None), it)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eval_loss(True, None)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"peak MiB of the sweep {peak:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
