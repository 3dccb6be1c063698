#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``im23d_tpu_torch``) once on one GPU.

Phases:
  1. build the CUDA kernels from ``im23d_tpu_torch/csrc/`` (nvcc, sm_90a);
  2. K1 (projection forward) against its plain PyTorch chain at the chairs
     candidate-sweep shape: 480 clouds x 8000 points, 64^3 grid, at the
     schedule's sigma/keep-prob ends and midpoint;
  3. K3 (Chamfer nearest neighbour) against the plain ``nn_dist2_torch`` at
     (24, 8000) <-> (24, 2048) and (24, 8000) <-> (24, 512), both
     directions;
  4. the chairs eval slice through the port's CLI
     (``cli/evaluation_test_shape_net.main``, 3 synthetic batches) from a
     seeded, saved learner; launch counts of both kernels in that run; the
     slice's projections held against the plain chain on the same outputs;
     eval batches/s.

Prints timings beside the GPU's name and power limit, then one JSON line
with the per-kernel results, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.

Usage (from the repository root): python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# outside a checkout these imports fail before anything is printed
from im23d_tpu_torch.cli import evaluation_test_shape_net as cli
from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes, _random_shapes
from im23d_tpu_torch.losses.effective import (
    _candidate_cam,
    _downsample_masks,
    unsupervised_loss,
)
from im23d_tpu_torch.metrics.chamfer import (
    nn_dist2,
    nn_dist2_kernel,
    nn_dist2_torch,
)
from im23d_tpu_torch.ops import _build
from im23d_tpu_torch.ops.camera import world_to_camera_zyx
from im23d_tpu_torch.ops.pointcloud import keep_mask
from im23d_tpu_torch.ops.projection import (
    projection_kernel,
    projection_silhouette,
    projection_silhouette_torch,
)
from im23d_tpu_torch.ops.quaternion import qnormalize
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)

# chairs config: bs 24, 5 views, 4 pose candidates, 8000 points, 64^3 grid
B, V, K, N, S = 24, 5, 4, 8000, 64
GT_POINTS = 2048
GT_POINTS_CLI = 512  # the eval CLI's synthetic ground truth
DEVICE = "cuda"
K1_CASES = ((3.0, 0.07), (1.6, 0.535), (0.2, 1.0))  # (sigma, keep prob p)
# K1 vs plain: atomicAdd order changes between runs and the blur sums its
# taps in another order than the plain band matmul; both round at ~1e-7 of
# values <= 1, and the termination chain's sensitivity to an occupancy is
# bounded by ~1.  Read on an H100 at this shape: 1.55e-6 here, 1.13e-6 in
# the slice; the card's pytest holds K1 at 1e-5 too.  A wrong leading
# termination plane (o0 for exp(eps + log o0)) shifts a pixel by ~1e-5 o0.
K1_ATOL = 1e-5
# K3 vs plain: same formula; nvcc may contract dz*dz + dy*dy into an FMA,
# a last-ulp difference on values of order 1.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
# slice vs plain chain: losses are sums of 120 x 64 x 64 squared errors
SLICE_RTOL = 1e-4


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events, warm)."""
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


def _clouds(rng, batch: int, n: int, dev):
    return torch.as_tensor(_random_shapes(rng, batch, n), device=dev)


def phase_build():
    t0 = time.perf_counter()
    _build.load_kernels()
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.1f} s -> {_build.build_info['path']}")
    for line in _build.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")


def phase_k1(gpu: str) -> dict:
    dev = torch.device(DEVICE)
    C = B * V * K  # 480 clouds in the candidate sweep
    rng = np.random.RandomState(0)
    cloud = _clouds(rng, C, N, dev)
    quats = qnormalize(torch.as_tensor(rng.randn(C, 4).astype(np.float32),
                                       device=dev))
    planes = tuple(p.contiguous() for p in world_to_camera_zyx(cloud, quats))
    scale = torch.as_tensor(rng.uniform(0.2, 1.5, C).astype(np.float32),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    err = 0.0
    for sigma, p in K1_CASES:
        sig = torch.tensor(sigma, device=dev)
        w = keep_mask(gen, C, N, p)
        got = projection_silhouette(planes, S, sig, scale, weights=w)
        ref = projection_silhouette_torch(planes, S, sig, scale, weights=w)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        print(f"[K1] sigma {sigma} p {p}: max |kernel - plain| {e:.3e} "
              f"(atol {K1_ATOL}); silhouette mean {float(ref.mean()):.4f}")
        if not (torch.isfinite(got).all() and e <= K1_ATOL):
            raise AssertionError(f"K1 disagrees with plain: {e}")
        err = max(err, e)
    sig = torch.tensor(K1_CASES[0][0], device=dev)
    w = keep_mask(gen, C, N, K1_CASES[0][1])
    ms = _time_ms(lambda: projection_silhouette(
        planes, S, sig, scale, weights=w), 20)
    plain_ms = _time_ms(lambda: projection_silhouette_torch(
        planes, S, sig, scale, weights=w), 5)
    print(f"[K1] {C} clouds x {N} points, S={S}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms per call [{gpu}]")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_k3(gpu: str) -> dict:
    """K3 vs plain at the eval CLI's shape (GT_POINTS_CLI ground-truth
    points, the one the JSON line times) and at GT_POINTS."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(1)
    x = _clouds(rng, B, N, dev)
    err, timed = 0.0, {}
    for m in (GT_POINTS, GT_POINTS_CLI):
        y = _clouds(rng, B, m, dev)
        for name, a, b in (("pred->gt", x, y), ("gt->pred", y, x)):
            got = nn_dist2(a, b)
            ref = nn_dist2_torch(a, b)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            print(f"[K3] {name} {tuple(a.shape)} vs {tuple(b.shape)}: max "
                  f"|kernel - plain| {e:.3e}")
            if not torch.allclose(got, ref, rtol=K3_RTOL, atol=K3_ATOL):
                raise AssertionError(f"K3 disagrees with plain ({name}): {e}")
            err = max(err, e)
        ms = _time_ms(lambda: nn_dist2(x, y), 50)
        plain_ms = _time_ms(lambda: nn_dist2_torch(x, y), 5)
        print(f"[K3] ({B}, {N}) vs ({B}, {m}): kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms per call [{gpu}]")
        timed = dict(ms=ms, plain_ms=plain_ms)
    return dict(max_abs_err=err, **timed)


def phase_slice(gpu: str) -> dict:
    cfg = ShapeNetConfig.chairs()
    with tempfile.TemporaryDirectory() as tmp:
        workdir, out_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "eval")
        learner = ShapeNetLearner(cfg, device=DEVICE)
        learner.save(workdir)

        projection_kernel.launches = 0
        nn_dist2_kernel.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["--workdir", workdir, "--synthetic", "--num_batches",
                       "3", "--out_dir", out_dir, "--device", DEVICE])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(k1=projection_kernel.launches,
                        k3=nn_dist2_kernel.launches)
        with open(os.path.join(out_dir, "eval_metrics.json")) as fh:
            metrics = json.load(fh)
    print(f"[slice] CLI main rc {rc} in {cli_s:.2f} s; launches {launches}; "
          f"{metrics}")
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    for key in ("projection_loss", "total_loss", "chamfer_l2", "iou_3d"):
        if not math.isfinite(metrics[key]):
            raise AssertionError(f"{key} is not finite: {metrics[key]}")
    if metrics["student_projection_shape"] != [B * V, S, S]:
        raise AssertionError(f"student grid {metrics['student_projection_shape']}")
    if metrics["candidate_projection_shape"] != [B * V, K, S, S]:
        raise AssertionError(
            f"candidate grid {metrics['candidate_projection_shape']}")
    if launches["k1"] < 1 or launches["k3"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # the slice's values against the plain chain on the same model outputs
    batch = SyntheticSilhouettes(B, cfg.image_size, V, n_points=512,
                                 seed=1).next_batch()
    sigma = torch.tensor(0.3, device=DEVICE)
    with torch.no_grad():
        nb = learner._normalize(batch)
        out = learner.model(nb["images"], nb["pose_input"])
        masks_s = _downsample_masks(nb["masks"], S)
        for training, quats in ((False, out["student_q"].reshape(B, V, 4)),
                                (True, out["ensemble_q"].reshape(B, V * K, 4))):
            losses, aux = unsupervised_loss(out, nb["masks"], sigma, None, V,
                                            voxel_size=S, training=training)
            cam, _, sc = _candidate_cam(out["point_cloud"], quats,
                                        out["scale"], None)
            ref = projection_silhouette_torch(cam, S, sigma, sc)
            got = aux["projection"].reshape(ref.shape)
            e = float((got - ref).abs().max())
            ref_sil = ref.reshape(B * V, -1, S, S)
            per_cand = ((ref_sil - masks_s[:, None]) ** 2).sum(dim=(2, 3))
            ref_loss = float(per_cand.min(dim=1).values.sum() / (B * V))
            got_loss = float(losses["projection_loss"])
            print(f"[slice] training={training}: {ref.shape[0]} clouds, max "
                  f"|K1 - plain| {e:.3e}, projection loss {got_loss:.6f} vs "
                  f"plain {ref_loss:.6f}")
            if e > K1_ATOL or not math.isclose(got_loss, ref_loss,
                                               rel_tol=SLICE_RTOL):
                raise AssertionError("slice disagrees with the plain chain")

    data = SyntheticSilhouettes(B, cfg.image_size, V, n_points=512, seed=2)
    batches = [data.next_batch() for _ in range(3)]
    learner.evaluate(batches)  # warm
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        learner.evaluate(batches)
    torch.cuda.synchronize()
    rate = reps * len(batches) / (time.perf_counter() - t0)
    print(f"[slice] eval {rate:.2f} batches/s ({rate * B:.1f} images/s, "
          f"bs {B}, host clock incl. host->device copies) [{gpu}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # kernel-vs-plain comparisons in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = _gpu_line()
    print(f"[gpu] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase_build()
    k1 = phase_k1(gpu)
    k3 = phase_k3(gpu)
    launches = phase_slice(gpu)

    kernels = [
        dict(name="K1 projection forward", route="cuda",
             source="im23d_tpu_torch/csrc/projection.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:1080",
             launches=launches["k1"], **k1),
        dict(name="K3 nearest-neighbour dist2", route="cuda",
             source="im23d_tpu_torch/csrc/nn_dist2.cu",
             replaces="im23d_tpu/metrics/chamfer.py:56",
             launches=launches["k3"], **k3),
    ]
    print(json.dumps(dict(kernels=kernels)))
    print(_gpu_line())
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
