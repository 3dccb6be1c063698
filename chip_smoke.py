#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``im23d_tpu_torch``) once on one GPU.

Phases:
  1. build the CUDA kernels from ``im23d_tpu_torch/csrc/`` (nvcc, sm_90a);
  2. K1 (projection forward) against its plain PyTorch chain at the chairs
     candidate-sweep shape: 480 clouds x 8000 points, 64^3 grid, at the
     schedule's sigma/keep-prob ends and midpoint;
  3. K2 (projection backward) against its plain version
     (``projection_backward_torch``) at the winner shape: 120 clouds x 8000
     points, 64^3 grid, at the same three (sigma, p);
  4. K3 (Chamfer nearest neighbour) against the plain ``nn_dist2_torch`` at
     (24, 8000) <-> (24, 2048) and (24, 8000) <-> (24, 512), both
     directions;
  5. the chairs training slice through the port's training CLI
     (``cli/training_test_shape_net.main --synthetic --steps 20``) from a
     fresh workdir; launch counts of the kernels in that run; finite losses;
     a checkpoint with the optimizer state;
  6. the chairs eval slice through the port's eval CLI (3 synthetic
     batches), restoring that checkpoint; launch counts in that run; the
     slice's projections held against the plain chain on the same outputs;
     eval batches/s;
  7. a learning check: 40 train steps on one fixed chairs batch, the
     projection loss must fall; train steps/s;
  8. K4 (rasterizer forward) against the plain ``rasterize_torch`` at the
     CUB eval shape: 50 renders of 960 faces (``MeshTemplate(32, 16)``,
     structured displacement maps, seeded poses) at 256², A = 3 (u, v,
     mask), sigma 1e-4, back faces culled and drawn;
  9. K5 (texture sampler forward) against the plain
     ``grid_sample_bilinear_torch``: 50 textures of 128 x 130 x 3 sampled
     at 50 x 256² points, at phase 8's rendered UVs and at random
     coordinates in [-1.1, 1.1];
 10. the Pipeline-B eval slice through the port's
     ``cli/run_reconstruction.main([..., "--evaluate"], datasets=...)`` at
     the full CUB configuration (bs 50, 256² RGBA, 128² texture, 32² mesh
     map, 960 faces) on 110 fabricated photos (two full batches and a tail
     of 10), restoring a checkpoint saved from the seeded trainer; launch
     counts of K4 and K5 in that run; its renders held against the plain
     path on the same network outputs; eval batches/s;
 11. one ``render_multiview`` grid;
 12. K5 backward against autograd of the plain gather: at phase 9's shape
     on rendered UVs and on random coordinates, and at the visibility
     render's shape (50 x 1024² samples into 128 x 130 texels, the upstream
     gradient the hard mask); ``F.grid_sample``'s backward timed beside it;
 13. K4 backward against autograd of the plain rasterizer at 50 x 256² x
     960 faces, A = 3, sigma 1e-4, back faces culled (the plain version on
     the first 10 images; the gradients of separate images are
     independent), and with back faces drawn on 10 images;
 14. one recon training step at bs 8 through the kernels and through the
     plain path (float32 network): the loss, and the gradients of the
     network outputs, the network parameters and ``DatasetParams``;
 15. the recon training CLI (``run_reconstruction.main`` without a mode
     flag) on 110 fabricated photos for 3 epochs with every frequency at 1,
     then ``--continue_train`` for a fourth; launch counts of K4 and K5
     forward and backward in those runs; finite losses;
 16. a learning check: 40 recon train steps on one fixed batch of 50; the
     mean recon loss of the last 5 below 0.95 of the first 5; train
     steps/s at the full config;
 17. ``--generate_pseudogt`` through the CLI on 100 fabricated photos with
     their 299² and 1024² renders; the cache files checked, and the
     visibility mask and inverse render of 4 images held to the plain path.

Prints timings beside the GPU's name and power limit, then one JSON line
with the per-kernel results (each with its bound: the larger of the bytes
it must move over 3.35 TB/s and its operations over the float32 rate of
67 TFLOP/s, from this run's inputs), the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or outside a checkout of the repository.

Usage (from the repository root): python3 chip_smoke.py
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

# outside a checkout these imports fail before anything is printed
from im23d_tpu_torch.cli import evaluation_test_shape_net as cli
from im23d_tpu_torch.cli import run_reconstruction as recon_cli
from im23d_tpu_torch.cli import training_test_shape_net as train_cli
from im23d_tpu_torch.data.cmr import batch_iterator
from im23d_tpu_torch.data.fabricate import (
    StructuredPseudoGT,
    StructuredReconSet,
)
from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes, _random_shapes
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
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
    _prep_projection,
    _taps_and_scale,
    projection_backward_kernel,
    projection_backward_torch,
    projection_kernel,
    projection_silhouette,
    projection_silhouette_torch,
)
from im23d_tpu_torch.ops.quaternion import qnormalize
from im23d_tpu_torch.ops.sampling import (
    grid_sample_bilinear,
    grid_sample_bilinear_backward_kernel,
    grid_sample_bilinear_backward_torch,
    grid_sample_bilinear_kernel,
    grid_sample_bilinear_torch,
    resize_bilinear,
)
from im23d_tpu_torch.render import renderer
from im23d_tpu_torch.render.inverse import inverse_render, visibility_mask
from im23d_tpu_torch.render.rasterizer import (
    _launch_forward,
    rasterize,
    rasterize_backward_kernel,
    rasterize_backward_torch,
    rasterize_kernel,
    rasterize_torch,
    soft_margin,
)
from im23d_tpu_torch.train.recon_trainer import (
    ReconConfig,
    ReconTrainer,
    transform_vertices,
)
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
# K2 vs plain, relative L2 error per output (||kernel - plain|| / ||plain||):
# the recompute sums the splat by atomicAdd in another order than the plain
# chain, so a voxel within rounding of a clamp bound (raw <= 1, u <= 1,
# eps <= o <= 1 - eps) can flip its mask and move nearby gradients by O(1) of
# their value; a max-abs bound would read those flips, not the kernel.
K2_REL_L2 = 1e-4
# K3 vs plain: same formula; nvcc may contract dz*dz + dy*dy into an FMA,
# a last-ulp difference on values of order 1.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
# slice vs plain chain: losses are sums of 120 x 64 x 64 squared errors
SLICE_RTOL = 1e-4
TRAIN_STEPS = 20          # the training CLI's run
LEARN_STEPS, WARM = 40, 10  # the learning check; steps before the timing
# Pipeline B, CUB config: bs 50, 256² images, 128² texture (130 wide after
# the circular pad), 960 faces, sigma 1e-4
RB, RES, TEX, SIGMA = 50, 256, 128, 1e-4
RECON_IMAGES = 110  # two full batches and a tail of 10
# K4 vs plain: the same arithmetic with FMA contraction ruled out, so the
# winners agree; a pixel whose edge function rounds to the other side would
# take the other face's attributes, hence a quantile for feat (as the JAX
# package's rasterizer tests) and a count of differing hard-mask pixels;
# soft sums its log1p terms in another order (~1e-7 each).
K4_FEAT_Q999, K4_MASK_FRAC, K4_SOFT_ATOL = 1e-5, 1e-3, 1e-4
# K5 vs plain: the same operations in the same order
K5_ATOL = 1e-5
# K5 backward vs autograd of the plain gather, relative L2 per output: d img
# sums by atomicAdd in another order, d grid adds its terms in another order
K5B_REL_L2, K5B_REPEATS = 1e-5, 5
# K4 backward vs autograd of the plain rasterizer, the limits of the JAX
# package's rasterizer gradient test (tests/test_rasterizer_pallas.py:76-80):
# max |error| below K x max(max |plain|, 1), K = 1e-3 for the corners, 1e-4
# for the attributes; and relative L2 per output at most 1e-4, so that an
# error confined to a few faces cannot hide under the max of the largest.
# Per-face sums by atomicAdd in another order, the segment-parameter chain
# that vanishes at the nearest point dropped (the TPU kernel's algebra),
# d log_miss from 1 - soft: relative L2 read 4.0e-6 and below on the H100.
K4B_FV_K, K4B_ATTR_K, K4B_REL_L2 = 1e-3, 1e-4, 1e-4
K4B_PLAIN_IMAGES = 10  # images the plain backward is compared on
# one training step, kernels vs plain path, float32 network, both on the
# card: the losses, and the gradients by relative L2.  The render's
# gradients differ by the kernels' rounding and atomicAdd order (limits
# above); the network outputs' and DatasetParams' gradients sit right behind
# the render; the network parameters' pass through eight train-mode batch
# norms over 8 images, which amplify those differences (read 2.6e-5).
STEP_BS, STEP_RTOL, STEP_OUT_RL2, STEP_DP_RL2, STEP_NET_RL2 = (
    8, 1e-4, 1e-4, 1e-4, 1e-3)
RECON_TRAIN_EPOCHS = 3  # the training CLI's run, then one more resumed
PGT_IMAGES, PGT_RES = 100, 512  # pseudo-GT: photos, --pseudogt_resolution
PGT_MASK_FRAC = 1e-4  # visibility-mask pixels differing from the plain path
# peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, float32
# FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


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


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    # reads the planes, keep weights and scales, writes the silhouettes;
    # per point 8 corners x 4 operations, per voxel a 21-tap blur along
    # three axes (126) and the clamp and termination (5)
    bound = _bound(_nbytes(*planes, w, scale) + C * S * S * 4,
                   C * (32 * N + 131 * S ** 3))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound)


def _rel_l2(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def phase_k2(gpu: str) -> dict:
    dev = torch.device(DEVICE)
    C = B * V  # the 120 argmin winners of a training step
    rng = np.random.RandomState(3)
    cloud = _clouds(rng, C, N, dev)
    quats = qnormalize(torch.as_tensor(rng.randn(C, 4).astype(np.float32),
                                       device=dev))
    planes = world_to_camera_zyx(cloud, quats)
    scale = torch.as_tensor(rng.uniform(0.2, 1.5, C).astype(np.float32),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    err, rel, timed = 0.0, 0.0, []
    for sigma, p in K1_CASES:
        w = keep_mask(gen, C, N, p)
        gz, gy, gx, c = _prep_projection(planes, S, w, 1e-6)
        taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale,
                                   21, C, dev)
        gsil = torch.randn((C, S, S), device=dev, generator=gen)
        ops = [t.contiguous() for t in (gz, gy, gx, c, taps, sc, gsil)]
        got = projection_backward_kernel(*ops)
        ref = projection_backward_torch(*ops)
        torch.cuda.synchronize()
        for name, g, r in zip(("dgz", "dgy", "dgx", "dscale"), got, ref):
            e, rl = float((g - r).abs().max()), _rel_l2(g, r)
            print(f"[K2] sigma {sigma} p {p} {name}: rel L2 {rl:.3e} "
                  f"(limit {K2_REL_L2}), max |kernel - plain| {e:.3e}, "
                  f"max |plain| {float(r.abs().max()):.3e}")
            if not (torch.isfinite(g).all() and rl <= K2_REL_L2):
                raise AssertionError(f"K2 disagrees with plain ({name}): {rl}")
            err, rel = max(err, e), max(rel, rl)
        ms = _time_ms(lambda: projection_backward_kernel(*ops), 20)
        plain_ms = _time_ms(lambda: projection_backward_torch(*ops), 3)
        print(f"[K2] {C} clouds x {N} points, S={S}, p {p}: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms per call [{gpu}]")
        # reads the coordinates, weights, taps, scales and the silhouette
        # gradient, writes three coordinate gradients and d scale; per
        # voxel the blur recomputed and transposed (4 x 126) and the
        # termination VJP (10), per point the splat and its gather (64)
        timed.append(dict(ms=ms, plain_ms=plain_ms, library_ms=None, **_bound(
            _nbytes(*ops) + 3 * C * N * 4 + C * 4,
            C * (64 * N + 514 * S ** 3))))
    # the JSON line times the first case, as for K1
    return dict(max_abs_err=err, max_rel_l2=rel, **timed[0])


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
        # 3 differences, 3 products, 2 sums and a min per point pair
        timed = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **_bound(
            _nbytes(x, y) + B * N * 4, 9 * B * N * m))
    return dict(max_abs_err=err, **timed)


_KERNELS = dict(k1=projection_kernel, k2=projection_backward_kernel,
                k3=nn_dist2_kernel, k4=rasterize_kernel,
                k4b=rasterize_backward_kernel, k5=grid_sample_bilinear_kernel,
                k5b=grid_sample_bilinear_backward_kernel)


def _zero_counts() -> None:
    for fn in _KERNELS.values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in _KERNELS.items()}


def phase_train(gpu: str, workdir: str) -> dict:
    """The training CLI from a fresh workdir; its stdout ends with the final
    losses as a dict."""
    buf = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(["--synthetic", "--steps", str(TRAIN_STEPS),
                             "--workdir", workdir, "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    out = buf.getvalue().strip()
    for line in out.splitlines():
        print(f"[train] cli: {line}")
    print(f"[train] CLI main rc {rc} in {secs:.2f} s ({TRAIN_STEPS} steps "
          f"incl. host-side synthetic batches); launches {launches}")
    if rc != 0:
        raise AssertionError(f"training CLI returned {rc}")
    losses = ast.literal_eval(out.splitlines()[-1])
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite training losses: {losses}")
    if launches["k1"] < 1 or launches["k2"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    tree = torch.load(os.path.join(workdir, f"checkpoint_{TRAIN_STEPS}.pt"),
                      map_location="cpu", weights_only=True)
    n_state = len(tree["opt_state"]["state"])
    print(f"[train] checkpoint step {tree['step']}, optimizer state for "
          f"{n_state} parameters")
    if tree["step"] != TRAIN_STEPS or n_state == 0:
        raise AssertionError("checkpoint lacks its step or optimizer state")
    if not all(torch.isfinite(v).all() for v in tree["params"].values()):
        raise AssertionError("non-finite parameters after training")
    return launches


def phase_slice(gpu: str, workdir: str) -> dict:
    """The eval CLI, restoring the training phase's checkpoint."""
    cfg = ShapeNetConfig.chairs()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "eval")
        _zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(["--workdir", workdir, "--synthetic", "--num_batches",
                       "3", "--out_dir", out_dir, "--device", DEVICE])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = _counts()
        with open(os.path.join(out_dir, "eval_metrics.json")) as fh:
            metrics = json.load(fh)
        curves = sorted(f for f in os.listdir(out_dir) if "loss_curves" in f)
    print(f"[slice] CLI main rc {rc} in {cli_s:.2f} s; launches {launches}; "
          f"loss curves {curves}; {metrics}")
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    if metrics["step"] != TRAIN_STEPS:
        raise AssertionError(f"eval restored step {metrics['step']}")
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
    learner = ShapeNetLearner(cfg, device=DEVICE)
    learner.restore(workdir)

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


def phase_learn(gpu: str) -> float:
    """LEARN_STEPS train steps on one fixed chairs batch (resident on the
    card): the projection loss must fall.  Returns train steps/s over the
    steps after WARM, host clock."""
    cfg = ShapeNetConfig.chairs()
    learner = ShapeNetLearner(cfg, device=DEVICE)
    batch = learner.put_batch(SyntheticSilhouettes(
        B, cfg.image_size, V, n_points=512, seed=5).next_batch())
    losses = []
    for i in range(LEARN_STEPS):
        if i == WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(learner.train_step(batch)
                      ["projection_loss"])
    torch.cuda.synchronize()
    rate = (LEARN_STEPS - WARM) / (time.perf_counter() - t0)
    vals = [float(v) for v in losses]
    ratio = vals[-1] / vals[0]
    print(f"[learn] projection loss {vals[0]:.4f} -> {vals[-1]:.4f} over "
          f"{LEARN_STEPS} steps on one batch, ratio {ratio:.4f}")
    print(f"[learn] train {rate:.2f} steps/s ({rate * B:.1f} images/s, bs {B}, "
          f"host clock, batch on the card) [{gpu}]")
    if not (all(math.isfinite(v) for v in vals) and vals[-1] < vals[0]):
        raise AssertionError(f"the loss did not fall: {vals}")
    return rate

def _q999(d: torch.Tensor) -> float:
    """The 0.999 quantile of a tensor's values (torch.quantile refuses
    inputs of more than 2^24 values)."""
    v = d.flatten().sort().values
    return float(v[int(0.999 * (v.numel() - 1))])


def _cub_scene(template, dev):
    """RB posed CUB-template meshes from structured displacement maps and
    their (u, v, mask) face-corner attributes, as ``render_mesh`` builds
    them."""
    fab = StructuredPseudoGT(RB, TEX, n_classes=4, seed=11)
    maps = [fab.maps(i) for i in range(RB)]
    mesh = torch.as_tensor(np.stack([m["mesh"].transpose(1, 2, 0)
                                     for m in maps]), dtype=torch.float32,
                           device=dev)
    tex = torch.as_tensor(np.stack([m["texture"].transpose(1, 2, 0)
                                    for m in maps]), dtype=torch.float32,
                          device=dev)
    rng = np.random.RandomState(12)
    pose = [torch.as_tensor(a.astype(np.float32), device=dev) for a in (
        0.55 + 0.1 * rng.rand(RB), 0.1 * rng.randn(RB, 3) * [1, 1, 0],
        rng.randn(RB, 4))]
    with torch.no_grad():
        verts = transform_vertices(template.get_vertex_positions(mesh), *pose)
        uvs, tex_adj = template.adjust_uv_and_texture(tex / 2 + 0.5)
    faces = template.tensor("faces", dev)
    F = faces.shape[0]
    attrs = torch.cat([uvs[:, template.tensor("face_uvs", dev)],
                       verts.new_ones((RB, F, 3, 1))], dim=-1)
    return verts, faces, attrs, tex_adj


def _raster_pairs(verts, faces, height, width, sigma, cull=True) -> int:
    """Pixel and face pairs the rasterizer must visit for these inputs: the
    pixel centres inside each drawn face's bounding box widened by the
    sqrt(104 sigma) margin beyond which a face changes no value."""
    fv = verts[:, faces.long()]
    x, y = fv[..., 0], fv[..., 1]
    area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
            - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    drawn = area > 1e-9 if cull else area.abs() > 1e-9
    m = soft_margin(sigma)
    c_lo = torch.ceil((x.amin(-1) - m + 1) * width / 2 - 0.5).clamp(min=0)
    c_hi = torch.floor((x.amax(-1) + m + 1) * width / 2 - 0.5).clamp(
        max=width - 1)
    r_lo = torch.ceil((1 - (y.amax(-1) + m)) * height / 2 - 0.5).clamp(min=0)
    r_hi = torch.floor((1 - (y.amin(-1) - m)) * height / 2 - 0.5).clamp(
        max=height - 1)
    n = (c_hi - c_lo + 1).clamp(min=0) * (r_hi - r_lo + 1).clamp(min=0)
    return int((n * drawn).sum())


# float32 operations per pixel and nearby face: three edge functions (15),
# three segment distances (42), an exp and a log1p (2) for the forward; the
# backward recomputes them and adds the gradient algebra (22)
K4_FWD_OPS, K4_BWD_OPS = 59, 81


def phase_k4(gpu: str, template) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """K4 vs plain, back faces culled and drawn; returns the JSON entry,
    the culled render's UVs and the adjusted textures (for phase 9)."""
    dev = torch.device(DEVICE)
    verts, faces, attrs, tex_adj = _cub_scene(template, dev)
    err, uv = 0.0, None
    for cull in (True, False):
        got = rasterize(verts, faces, attrs, RES, RES, SIGMA, cull)
        ref = rasterize_torch(verts, faces, attrs, RES, RES, SIGMA, cull)
        torch.cuda.synchronize()
        d = (got[0] - ref[0]).abs()
        q = _q999(d)
        mask_frac = float(((got[0][..., 2] > 0.5) != (ref[0][..., 2] > 0.5))
                          .float().mean())
        soft_e = float((got[1] - ref[1]).abs().max())
        e = max(float(d.max()), soft_e)
        print(f"[K4] cull={cull}: feat 0.999-quantile |kernel - plain| "
              f"{q:.3e} (limit {K4_FEAT_Q999}), max {float(d.max()):.3e}; "
              f"hard-mask pixels differing {mask_frac:.3e} (limit "
              f"{K4_MASK_FRAC}); soft max {soft_e:.3e} (limit "
              f"{K4_SOFT_ATOL}); coverage {float(ref[0][..., 2].mean()):.4f}")
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
                and q <= K4_FEAT_Q999 and mask_frac <= K4_MASK_FRAC
                and soft_e <= K4_SOFT_ATOL):
            raise AssertionError(f"K4 disagrees with plain (cull={cull})")
        err = max(err, e)
        if cull:
            uv = got[0][..., :2]
    ms = _time_ms(lambda: rasterize(verts, faces, attrs, RES, RES, SIGMA), 20)
    plain_ms = _time_ms(lambda: rasterize_torch(verts, faces, attrs, RES, RES,
                                                SIGMA), 2)
    print(f"[K4] {RB} x {RES}² x {faces.shape[0]} faces, A=3, culled: kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms per call [{gpu}]")
    pairs = _raster_pairs(verts, faces, RES, RES, SIGMA)
    fv = verts[:, faces]
    bound = _bound(_nbytes(fv, attrs) + RB * RES * RES * 4 * 4,
                   K4_FWD_OPS * pairs)
    print(f"[K4] {pairs} pixel-face pairs; bound {bound}")
    return (dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                 **bound), uv, tex_adj, (verts, faces, attrs))


def phase_k5(gpu: str, uv, tex_adj) -> dict:
    """K5 vs plain at rendered UVs (the fragment shader's mapping) and at
    random coordinates."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(13)
    grids = {
        "rendered UVs": (uv * 2 - 1) * uv.new_tensor([1.0, -1.0]),
        "random in [-1.1, 1.1]": torch.rand((RB, RES, RES, 2), device=dev,
                                            generator=gen) * 2.2 - 1.1,
    }
    err = 0.0
    for name, grid in grids.items():
        got = grid_sample_bilinear(tex_adj, grid)
        ref = grid_sample_bilinear_torch(tex_adj, grid)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        print(f"[K5] {name}: {tuple(tex_adj.shape)} at {tuple(grid.shape)}: "
              f"max |kernel - plain| {e:.3e} (atol {K5_ATOL})")
        if not (torch.isfinite(got).all() and e <= K5_ATOL):
            raise AssertionError(f"K5 disagrees with plain ({name}): {e}")
        err = max(err, e)
    grid = grids["rendered UVs"].contiguous()
    ms = _time_ms(lambda: grid_sample_bilinear(tex_adj, grid), 50)
    plain_ms = _time_ms(lambda: grid_sample_bilinear_torch(tex_adj, grid), 10)
    img_nchw = tex_adj.permute(0, 3, 1, 2).contiguous()
    permute_ms = _time_ms(
        lambda: tex_adj.permute(0, 3, 1, 2).contiguous(), 50)
    library_ms = _time_ms(lambda: F.grid_sample(
        img_nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=True), 50)
    print(f"[K5] {tuple(tex_adj.shape)} at {RB} x {RES}²: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, F.grid_sample {library_ms:.3f} ms (+ "
          f"{permute_ms:.3f} ms for the NCHW permute) per call [{gpu}]")
    # reads the texture and the grid, writes C floats a sample; 4 corners x
    # C products and sums plus ~12 for the weights
    C = tex_adj.shape[-1]
    bound = _bound(_nbytes(tex_adj, grid) + grid[..., 0].numel() * C * 4,
                   grid[..., 0].numel() * (12 + 8 * C))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, permute_ms=permute_ms, **bound)


def _plain_render_path():
    """Route ``render_mesh`` through the plain rasterizer and sampler."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(renderer, "rasterize",
                                          rasterize_torch))
    stack.enter_context(mock.patch.object(renderer, "grid_sample_bilinear",
                                          grid_sample_bilinear_torch))
    return stack


def _move_mesh_head(trainer) -> None:
    """Seeded mesh-head weights that move the sphere (the random init's
    zero head would predict it unchanged)."""
    with torch.no_grad():
        w = trainer.model.conv_mesh.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(
            14)).to(w.device) * 2e-3)


def phase_recon(gpu: str, template, tmp: str) -> dict:
    """The Pipeline-B eval CLI at the CUB config on fabricated photos,
    restoring a checkpoint of the seeded trainer."""
    t0 = time.perf_counter()
    data = StructuredReconSet(template, RECON_IMAGES, RES, TEX, seed=0,
                              device=DEVICE)
    print(f"[recon] fabricated {len(data)} photos at {RES}² in "
          f"{time.perf_counter() - t0:.2f} s")
    trainer = ReconTrainer(ReconConfig(), dataset_size=len(data),
                           template=template, device=DEVICE)
    _move_mesh_head(trainer)
    name = "chip_smoke"
    trainer.save(os.path.join(tmp, "checkpoints_recon", name))
    argv = ["--name", name, "--dataset", "cub", "--evaluate", "--device",
            DEVICE]
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = recon_cli.main(argv, datasets=(data, data))
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.chdir(cwd)
    out = buf.getvalue().strip()
    print(f"[recon] CLI main rc {rc} in {cli_s:.2f} s ({RECON_IMAGES} images, "
          f"bs {RB}); launches {launches}; means {out.splitlines()[-1]}")
    if rc != 0:
        raise AssertionError(f"recon CLI returned {rc}")
    means = ast.literal_eval(out.splitlines()[-1])
    if set(means) != {"recon_loss", "flat_loss", "iou"} or not all(
            math.isfinite(v) for v in means.values()):
        raise AssertionError(f"bad eval means: {means}")
    if launches["k4"] < 1 or launches["k5"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # the slice's renders against the plain path on the same network outputs
    batch = next(iter(batch_iterator(data, RB, shuffle=False, num_workers=1)))
    nb = trainer._put(batch)
    with torch.no_grad():
        tex, mesh_map = trainer.model(nb["image"])
        got = trainer._pose_and_render(mesh_map, tex, nb)
        with _plain_render_path():
            ref = trainer._pose_and_render(mesh_map, tex, nb)
    torch.cuda.synchronize()
    d_img = (got[2] - ref[2]).abs()
    q = _q999(d_img)
    e_alpha = float((got[3] - ref[3]).abs().max())
    losses = [float(trainer._recon_loss(torch.cat([r[2], r[3]], -1),
                                        nb["image"])) for r in (got, ref)]
    print(f"[recon] renders vs plain: image 0.999-quantile |diff| {q:.3e}, "
          f"max {float(d_img.max()):.3e}; alpha max {e_alpha:.3e}; recon loss "
          f"{losses[0]:.6f} vs plain {losses[1]:.6f}; image shape "
          f"{tuple(got[2].shape)}")
    if not (q <= K4_FEAT_Q999 and e_alpha <= K4_SOFT_ATOL and math.isclose(
            losses[0], losses[1], rel_tol=SLICE_RTOL)):
        raise AssertionError("the recon slice disagrees with the plain path")
    if tuple(got[2].shape) != (RB, RES, RES, 3):
        raise AssertionError(f"render shape {tuple(got[2].shape)}")

    batches = list(batch_iterator(data, RB, shuffle=False, drop_last=False,
                                  num_workers=1))
    trainer.evaluate(batches)  # warm
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.evaluate(batches)
    torch.cuda.synchronize()
    rate = reps * len(batches) / (time.perf_counter() - t0)
    print(f"[recon] eval {rate:.2f} batches/s ({rate * RB:.1f} images/s "
          f"counting the tail batch as full, bs {RB}, host clock incl. "
          f"host->device copies) [{gpu}]")
    tex_v, mesh_v = trainer.predict(batch["image"][:2])
    grid = trainer.render_multiview(
        template.get_vertex_positions(mesh_v), tex_v, idx=1)
    print(f"[recon] render_multiview grid {grid.shape}, mean "
          f"{float(grid.mean()):.4f}")
    if grid.shape != (2 * RES, 4 * RES, 3) or not (
            np.isfinite(grid).all() and 0 <= grid.min() <= grid.max() <= 1):
        raise AssertionError("bad render_multiview grid")
    return launches


def phase_k5_backward(gpu: str, uv, tex_adj, scene) -> dict:
    """K5 backward vs autograd of the plain gather at the train render's
    shape (rendered UVs and random coordinates) and at the visibility
    render's (50 x 1024² samples, upstream gradient = the hard mask, d img
    only).  The train shape is timed with the upstream gradient the
    training step gives it, d image x hard mask: zero off the silhouette,
    where the rendered UVs of every pixel name the same corner texel."""
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    verts, faces, attrs = scene
    hard = rasterize(verts, faces, attrs, RES, RES, SIGMA)[0][..., 2:3]
    grids = {
        "rendered UVs": ((uv * 2 - 1) * uv.new_tensor([1.0, -1.0]))
        .contiguous(),
        "random in [-1.1, 1.1]": torch.rand((RB, RES, RES, 2), device=DEVICE,
                                            generator=gen) * 2.2 - 1.1,
    }
    err, timed = 0.0, None
    for name, grid in grids.items():
        dout = torch.randn(tex_adj.shape[:1] + grid.shape[1:3]
                           + tex_adj.shape[3:], device=DEVICE, generator=gen)
        if timed is None:
            unmasked_ms = _time_ms(
                lambda: grid_sample_bilinear_backward_kernel(tex_adj, grid,
                                                             dout), 10)
            print(f"[K5 bwd] {name}, upstream unmasked (every background "
                  f"pixel on one texel): kernel {unmasked_ms:.3f} ms [{gpu}]")
            dout = (dout * hard).contiguous()
        ref = grid_sample_bilinear_backward_torch(tex_adj, grid, dout)
        # d img's atomicAdd order changes from launch to launch: each of
        # K5B_REPEATS launches is held
        rls = {"d img": [], "d grid": []}
        for _ in range(K5B_REPEATS):
            got = grid_sample_bilinear_backward_kernel(tex_adj, grid, dout)
            for (what, rl), g, r in zip(rls.items(), got, ref):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"K5 backward not finite ({name})")
                rl.append(_rel_l2(g, r))
                err = max(err, float((g - r).abs().max()))
        for what, rl in rls.items():
            print(f"[K5 bwd] {name} {what}: rel L2 {min(rl):.3e} to "
                  f"{max(rl):.3e} over {K5B_REPEATS} launches (limit "
                  f"{K5B_REL_L2})")
            if max(rl) > K5B_REL_L2:
                raise AssertionError(f"K5 backward disagrees ({name}, {what})")
        print(f"[K5 bwd] {name}: max |kernel - plain| {err:.3e} so far")
        if timed is None:  # the JSON line times the train shape's UVs
            ms = _time_ms(lambda: grid_sample_bilinear_backward_kernel(
                tex_adj, grid, dout), 50)
            plain_ms = _time_ms(lambda: grid_sample_bilinear_backward_torch(
                tex_adj, grid, dout), 5)
            img_nchw = tex_adj.permute(0, 3, 1, 2).contiguous()
            dout_nchw = dout.permute(0, 3, 1, 2).contiguous()
            permute_ms = _time_ms(lambda: (
                tex_adj.permute(0, 3, 1, 2).contiguous(),
                dout.permute(0, 3, 1, 2).contiguous()), 50)
            library_ms = _time_ms(
                lambda: torch.ops.aten.grid_sampler_2d_backward(
                    dout_nchw, img_nchw, grid, 0, 0, True, [True, True]), 50)
            n, C = grid[..., 0].numel(), tex_adj.shape[-1]
            # reads texture, grid, upstream; writes d texture and d grid;
            # per sample 4 corners x C x 4 operations plus ~20
            bound = _bound(_nbytes(tex_adj, grid, dout) * 2 - _nbytes(dout),
                           n * (20 + 16 * C))
            print(f"[K5 bwd] {tuple(tex_adj.shape)} <- {RB} x {RES}², "
                  f"upstream x hard mask: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, F.grid_sample's "
                  f"backward {library_ms:.3f} ms (+ {permute_ms:.3f} ms of "
                  f"NCHW permutes) per call; bound {bound} [{gpu}]")
            timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         permute_ms=permute_ms, unmasked_ms=unmasked_ms,
                         **bound)

    # the visibility render: 1024² UVs of the same meshes, a 0/1 upstream
    vres = 1024
    feat, _ = rasterize(verts, faces, attrs, vres, vres, SIGMA)
    vgrid = ((feat[..., :2] * 2 - 1) * feat.new_tensor([1.0, -1.0])
             ).contiguous()
    dout = feat[..., 2:3].expand(-1, -1, -1, tex_adj.shape[-1]).contiguous()
    del feat
    ref, _ = grid_sample_bilinear_backward_torch(tex_adj, vgrid, dout)
    rls, same = [], True
    for _ in range(K5B_REPEATS):
        got, _ = grid_sample_bilinear_backward_kernel(tex_adj, vgrid, dout,
                                                      need_grid=False)
        rls.append(_rel_l2(got, ref))
        same = same and bool(torch.equal(got > 0, ref > 0))
    cover = float((ref > 0).float().mean())
    print(f"[K5 bwd] visibility {tuple(tex_adj.shape)} <- {RB} x {vres}²: "
          f"d img rel L2 {min(rls):.3e} to {max(rls):.3e} over {K5B_REPEATS} "
          f"launches (limit {K5B_REL_L2}); texels > 0 equal {same}; texels "
          f"touched {cover:.4f}")
    if not (same and max(rls) <= K5B_REL_L2):
        raise AssertionError("K5 backward disagrees at the visibility shape")
    vis_ms = _time_ms(lambda: grid_sample_bilinear_backward_kernel(
        tex_adj, vgrid, dout, need_grid=False), 10)
    vis_plain_ms = _time_ms(lambda: grid_sample_bilinear_backward_torch(
        tex_adj, vgrid, dout), 2)
    print(f"[K5 bwd] visibility shape: kernel {vis_ms:.3f} ms, plain "
          f"{vis_plain_ms:.3f} ms per call [{gpu}]")
    del vgrid, dout, got, ref
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, **timed, visibility_ms=vis_ms,
                visibility_plain_ms=vis_plain_ms)


def phase_k4_backward(gpu: str, scene) -> dict:
    """K4 backward vs autograd of the plain rasterizer: culled on all 50
    images (the plain version on the first K4B_PLAIN_IMAGES), back faces
    drawn on K4B_PLAIN_IMAGES images."""
    verts, faces, attrs = scene
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    n = K4B_PLAIN_IMAGES
    err, timed = 0.0, None
    for cull, rb in ((True, RB), (False, n)):
        fv = verts[:rb, faces].contiguous()
        at = attrs[:rb].contiguous()
        dfeat = torch.randn((rb, RES, RES, 3), device=DEVICE, generator=gen)
        dsoft = torch.randn((rb, RES, RES, 1), device=DEVICE, generator=gen)
        fwd = _launch_forward(fv, at, RES, RES, SIGMA, cull, True)
        got = rasterize_backward_kernel(fv, at, dfeat, dsoft, *fwd[1:], RES,
                                        RES, SIGMA, cull)
        ref = rasterize_backward_torch(fv[:n], at[:n], dfeat[:n], dsoft[:n],
                                       RES, RES, SIGMA, cull)
        torch.cuda.synchronize()
        for what, g, r, k in (("d fv", got[0][:n], ref[0], K4B_FV_K),
                              ("d attrs", got[1][:n], ref[1], K4B_ATTR_K)):
            e, rl = float((g - r).abs().max()), _rel_l2(g, r)
            limit = k * max(float(r.abs().max()), 1.0)
            print(f"[K4 bwd] cull={cull} {what} (images 0-{n - 1}): max "
                  f"|kernel - plain| {e:.3e} (limit {limit:.3e}), rel L2 "
                  f"{rl:.3e} (limit {K4B_REL_L2}), max |plain| "
                  f"{float(r.abs().max()):.3e}")
            if not (torch.isfinite(g).all() and e < limit
                    and rl <= K4B_REL_L2):
                raise AssertionError(f"K4 backward disagrees ({what}, "
                                     f"cull={cull})")
            err = max(err, e)
        if cull:
            ms = _time_ms(lambda: rasterize_backward_kernel(
                fv, at, dfeat, dsoft, *fwd[1:], RES, RES, SIGMA, cull), 20)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            plain_ms = _time_ms(lambda: rasterize_backward_torch(
                fv, at, dfeat, dsoft, RES, RES, SIGMA, cull), 1)
            print(f"[K4 bwd] plain backward's peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            pairs = _raster_pairs(verts, faces, RES, RES, SIGMA)
            bound = _bound(_nbytes(fv, at, dfeat, dsoft, *fwd[1:])
                           + _nbytes(fv, at), K4_BWD_OPS * pairs)
            print(f"[K4 bwd] {RB} x {RES}² x {faces.shape[0]} faces, A=3, "
                  f"culled: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per "
                  f"call; bound {bound} [{gpu}]")
            timed = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bound)
        del fwd, got, ref
        torch.cuda.empty_cache()
    return dict(max_abs_err=err, **timed)


def _fabricated_batch(template, n: int, seed: int, sizes=()):
    return StructuredReconSet(template, n, RES, TEX, seed=seed, device=DEVICE,
                              sizes=sizes)


def phase_train_step(gpu: str, template) -> None:
    """One recon training step at bs STEP_BS through the kernels and through
    the plain path, from the same state, with the optimizer updates left
    out: the losses and the gradients."""
    data = _fabricated_batch(template, STEP_BS, 17)
    batch = next(iter(batch_iterator(data, STEP_BS, shuffle=False,
                                     num_workers=1)))
    trainer = ReconTrainer(ReconConfig(batch_size=STEP_BS,
                                       image_resolution=RES,
                                       texture_resolution=TEX,
                                       compute_dtype="float32"),
                           dataset_size=STEP_BS, template=template,
                           device=DEVICE)
    _move_mesh_head(trainer)
    for opt in (trainer.opt, trainer.opt_dp):
        opt.step = lambda *a, **k: None  # gradients only
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    outputs = []

    def keep_output_grads(module, args, out):
        for o in out:
            o.retain_grad()
        outputs.append(out)

    trainer.model.register_forward_hook(keep_output_grads)

    def step():
        trainer.model.load_state_dict(state)
        trainer.flat_warmup, outputs[:] = 10.0, []
        losses = trainer.train_step(batch)
        grads = {n: p.grad.clone() for n, p in
                 trainer.model.named_parameters()}
        dp = {n: p.grad.clone() for n, p in
              trainer.dp_model.named_parameters()}
        return ({k: float(v) for k, v in losses.items()},
                [o.grad.clone() for o in outputs[0]], grads, dp)

    counts0 = _counts()
    got = step()
    launched = {k: v - counts0[k] for k, v in _counts().items()}
    with _plain_render_path():
        ref = step()
    torch.cuda.synchronize()

    def rl2(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
        return (num / sum(float((v ** 2).sum()) for v in b.values())) ** 0.5

    out_rl = max(_rel_l2(g, r) for g, r in zip(got[1], ref[1]))
    net_rl, dp_rl = rl2(got[2], ref[2]), rl2(got[3], ref[3])
    print(f"[step] bs {STEP_BS}, float32 network: losses {got[0]} vs plain "
          f"{ref[0]}; gradient rel L2: network outputs {out_rl:.3e} (limit "
          f"{STEP_OUT_RL2}), DatasetParams {dp_rl:.3e} (limit {STEP_DP_RL2}),"
          f" network parameters {net_rl:.3e} (limit {STEP_NET_RL2}); "
          f"launches {launched}")
    if not all(math.isclose(got[0][k], ref[0][k], rel_tol=STEP_RTOL)
               for k in ref[0]):
        raise AssertionError("the training step's losses disagree")
    if not (out_rl <= STEP_OUT_RL2 and dp_rl <= STEP_DP_RL2
            and net_rl <= STEP_NET_RL2):
        raise AssertionError("the training step's gradients disagree")
    if min(launched[k] for k in ("k4", "k4b", "k5", "k5b")) < 1:
        raise AssertionError(f"a kernel of the step never launched: "
                             f"{launched}")


def phase_recon_train(gpu: str, template, tmp: str) -> dict:
    """The recon training CLI on RECON_IMAGES fabricated photos, then
    --continue_train for one more epoch; the launches of both runs."""
    data = _fabricated_batch(template, RECON_IMAGES, 0)
    name = "chip_smoke_train"
    flags = ["--name", name, "--dataset", "cub", "--device", DEVICE,
             "--image_resolution", str(RES), "--texture_resolution", str(TEX),
             "--batch_size", str(RB), "--save_freq", "1", "--evaluate_freq",
             "1", "--image_freq", "1"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        rc = recon_cli.main([*flags, "--epochs", str(RECON_TRAIN_EPOCHS)],
                            datasets=(data, data))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rc2 = recon_cli.main([*flags, "--epochs",
                              str(RECON_TRAIN_EPOCHS + 1),
                              "--continue_train"], datasets=(data, data))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _counts()
    finally:
        os.chdir(cwd)
    workdir = os.path.join(tmp, "checkpoints_recon", name)
    with open(os.path.join(workdir, "metrics_recon.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    train = [r for r in records if "recon_loss" in r]
    val = [r for r in records if "val/recon_loss" in r]
    tree = torch.load(os.path.join(workdir, "checkpoint_latest.pt"),
                      map_location="cpu", weights_only=True)
    steps = (RECON_IMAGES // RB) * (RECON_TRAIN_EPOCHS + 1)
    print(f"[recon-train] CLI rc {rc}, {rc2} in {t1 - t0:.2f} s "
          f"({RECON_TRAIN_EPOCHS} epochs) and {t2 - t1:.2f} s (resumed "
          f"epoch); launches {launches}; train records "
          f"{[(r['step'], round(r['recon_loss'], 5)) for r in train]}; val "
          f"{[round(r['val/recon_loss'], 5) for r in val]}; images "
          f"{len(os.listdir(os.path.join(workdir, 'images')))}")
    if rc != 0 or rc2 != 0:
        raise AssertionError("the recon training CLI failed")
    if not train or not all(math.isfinite(v) for r in records
                            for k, v in r.items() if k not in ("step",
                                                               "time")):
        raise AssertionError(f"non-finite or missing losses: {records}")
    if len(val) != RECON_TRAIN_EPOCHS + 1 or tree["total_it"] != steps:
        raise AssertionError(f"{len(val)} evaluations, total_it "
                             f"{tree['total_it']} (expected {steps})")
    if not tree["opt"]["state"]:
        raise AssertionError("the checkpoint lacks the optimizer state")
    if min(launches[k] for k in ("k4", "k4b", "k5", "k5b")) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return launches


def phase_recon_learn(gpu: str, template) -> float:
    """LEARN_STEPS recon train steps on one fixed batch of RB at the full
    config (bf16 network), batch resident on the card."""
    data = _fabricated_batch(template, RB, 18)
    batch = next(iter(batch_iterator(data, RB, shuffle=False, num_workers=1)))
    trainer = ReconTrainer(ReconConfig(image_resolution=RES,
                                       texture_resolution=TEX, batch_size=RB),
                           dataset_size=RB, template=template, device=DEVICE)
    nb = trainer._put(batch)
    losses = []
    for i in range(LEARN_STEPS):
        if i == WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(trainer.train_step(nb)["recon_loss"])
    torch.cuda.synchronize()
    rate = (LEARN_STEPS - WARM) / (time.perf_counter() - t0)
    vals = [float(v) for v in losses]
    first, last = np.mean(vals[:5]), np.mean(vals[-5:])
    ratio = last / first
    print(f"[recon-learn] recon loss {vals[0]:.5f} -> {vals[-1]:.5f} over "
          f"{LEARN_STEPS} steps on one batch; mean of the last 5 / first 5 "
          f"{ratio:.4f} (limit 0.95)")
    print(f"[recon-learn] train {rate:.2f} steps/s ({rate * RB:.1f} images/s,"
          f" bs {RB}, host clock, batch on the card) [{gpu}]")
    if not (all(math.isfinite(v) for v in vals) and ratio < 0.95):
        raise AssertionError(f"the recon loss did not fall: {vals}")
    return rate


def phase_pseudogt(gpu: str, template, tmp: str) -> None:
    """--generate_pseudogt through the CLI; the cache files; the visibility
    mask and inverse render of 4 images against the plain path."""
    t0 = time.perf_counter()
    vres = max(1024, 2 * PGT_RES)
    data = _fabricated_batch(template, PGT_IMAGES, 19, sizes=(299, vres))
    print(f"[pseudogt] fabricated {PGT_IMAGES} photos at {RES}², 299² and "
          f"{vres}² in {time.perf_counter() - t0:.2f} s")
    trainer = ReconTrainer(ReconConfig(image_resolution=RES,
                                       texture_resolution=TEX, batch_size=RB),
                           dataset_size=PGT_IMAGES, template=template,
                           device=DEVICE)
    _move_mesh_head(trainer)
    name = "chip_smoke_pgt"
    trainer.save(os.path.join(tmp, "checkpoints_recon", name))
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        rc = recon_cli.main(["--name", name, "--dataset", "cub", "--device",
                             DEVICE, "--image_resolution", str(RES),
                             "--texture_resolution", str(TEX),
                             "--batch_size", str(RB), "--generate_pseudogt",
                             "--pseudogt_resolution", str(PGT_RES)],
                            datasets=(data, data))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.chdir(cwd)
    cache = os.path.join(tmp, "cache", "cub")
    pdir = os.path.join(cache, f"pseudogt_{PGT_RES}x{PGT_RES}")
    files = os.listdir(pdir)
    item = np.load(os.path.join(pdir, "1.npz"), allow_pickle=True)["data"
                                                                  ].item()
    shapes = {k: (v.shape, str(v.dtype)) for k, v in item.items()}
    covered = float(np.mean([
        (np.load(os.path.join(pdir, f), allow_pickle=True)["data"].item()
         ["texture_alpha"] > 0).mean() for f in files]))
    stats = {split: np.load(os.path.join(
        cache, f"precomputed_fid_299x299_{split}.npz"))
        for split in ("train", "testval")}
    print(f"[pseudogt] CLI rc {rc} in {secs:.2f} s ({PGT_IMAGES} photos, bs "
          f"{RB}); launches {launches}; {len(files)} npz, item {shapes}; "
          f"visible texel share {covered:.4f}; FID stats "
          f"{ {k: v['stats_m'].shape for k, v in stats.items()} }")
    if rc != 0 or len(files) != PGT_IMAGES:
        raise AssertionError("pseudo-GT generation failed")
    want = {"mesh": (3, 32, 32), "texture": (3, PGT_RES, PGT_RES),
            "texture_alpha": (1, PGT_RES, PGT_RES), "image": (3, 299, 299)}
    if ({k: v.shape for k, v in item.items()} != want
            or item["texture"].dtype != np.float16
            or item["texture_alpha"].dtype != np.float16):
        raise AssertionError(f"bad pseudo-GT item {shapes}")
    if not 0 < covered < 1:
        raise AssertionError(f"visibility covers {covered}")
    for k, v in stats.items():
        if not (np.isfinite(v["stats_m"]).all()
                and np.isfinite(v["stats_s"]).all()):
            raise AssertionError(f"non-finite FID stats ({k})")
    if min(launches[k] for k in ("k4", "k5", "k5b")) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")

    # 4 images' visibility masks and inverse renders against the plain path
    trainer.restore(os.path.join(tmp, "checkpoints_recon", name))
    sel = list(range(4))
    images = np.stack([data[i]["image"] for i in sel])
    nb = trainer._put({k: np.stack([data[i][k] for i in sel])
                       for k in ("scale", "translation", "rotation", "idx")})
    hd = torch.as_tensor(np.stack([data[i][f"image_{vres}"] for i in sel]),
                         device=DEVICE) / 2.0 + 0.5
    tex, mesh_map = trainer.predict(images)
    with torch.no_grad():
        vtx = trainer._pose(template.get_vertex_positions(mesh_map), nb)

    def run():
        def render(v, t):
            uvs, ta = template.adjust_uv_and_texture(t)
            return renderer.render_mesh(
                v, template.tensor("faces", DEVICE), uvs,
                template.tensor("face_uvs", DEVICE), ta, vres, vres)[0]

        vis = visibility_mask(render, vtx, tex)
        with torch.no_grad():
            inv = inverse_render(template, vtx, hd, PGT_RES)
            mask = (resize_bilinear(vis, PGT_RES, PGT_RES,
                                    align_corners=False) > 0).any(-1)
        return mask, inv

    got = run()
    with _plain_render_path():
        ref = run()
    torch.cuda.synchronize()
    frac = float((got[0] != ref[0]).float().mean())
    q = _q999((got[1][0] - ref[1][0]).abs())
    a = float((got[1][1] != ref[1][1]).float().mean())
    print(f"[pseudogt] images 0-3 vs plain: visibility-mask pixels differing "
          f"{frac:.3e} (limit {PGT_MASK_FRAC}), mask share "
          f"{float(ref[0].float().mean()):.4f}; inverse texture 0.999-quantile"
          f" |diff| {q:.3e} (limit {K4_FEAT_Q999}); inverse alpha pixels "
          f"differing {a:.3e} (limit {K4_MASK_FRAC})")
    if not (frac <= PGT_MASK_FRAC and q <= K4_FEAT_Q999
            and a <= K4_MASK_FRAC):
        raise AssertionError("pseudo-GT disagrees with the plain path")


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
    k2 = phase_k2(gpu)
    k3 = phase_k3(gpu)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, "train")
        train = phase_train(gpu, workdir)
        evals = phase_slice(gpu, workdir)
    phase_learn(gpu)
    template = MeshTemplate(segments=32, rings=16)
    k4, uv, tex_adj, scene = phase_k4(gpu, template)
    k5 = phase_k5(gpu, uv, tex_adj)
    k5b = phase_k5_backward(gpu, uv, tex_adj, scene)
    k4b = phase_k4_backward(gpu, scene)
    del uv, tex_adj, scene
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        recon = phase_recon(gpu, template, tmp)
    phase_train_step(gpu, template)
    with tempfile.TemporaryDirectory() as tmp:
        recon_train = phase_recon_train(gpu, template, tmp)
    phase_recon_learn(gpu, template)
    with tempfile.TemporaryDirectory() as tmp:
        phase_pseudogt(gpu, template, tmp)

    kernels = [
        dict(name="K1 projection forward", route="cuda",
             source="im23d_tpu_torch/csrc/projection.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:1080",
             launches=train["k1"], **k1),
        dict(name="K2 projection backward", route="cuda",
             source="im23d_tpu_torch/csrc/projection.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:1124",
             launches=train["k2"], **k2),
        dict(name="K3 nearest-neighbour dist2", route="cuda",
             source="im23d_tpu_torch/csrc/nn_dist2.cu",
             replaces="im23d_tpu/metrics/chamfer.py:56",
             launches=evals["k3"], **k3),
        dict(name="K4 rasterizer forward", route="cuda",
             source="im23d_tpu_torch/csrc/rasterize.cu",
             replaces="im23d_tpu/render/rasterizer_pallas.py:216",
             launches=recon["k4"], **k4),
        dict(name="K4 rasterizer backward", route="cuda",
             source="im23d_tpu_torch/csrc/rasterize.cu",
             replaces="im23d_tpu/render/rasterizer_pallas.py:346",
             launches=recon_train["k4b"], **k4b),
        dict(name="K5 texture sampler forward", route="cuda",
             source="im23d_tpu_torch/csrc/grid_sample.cu",
             replaces="im23d_tpu/ops/sampling_pallas.py:197",
             launches=recon["k5"], **k5),
        dict(name="K5 texture sampler backward", route="cuda",
             source="im23d_tpu_torch/csrc/grid_sample.cu",
             replaces="im23d_tpu/ops/sampling_pallas.py:213",
             launches=recon_train["k5b"], **k5b),
    ]
    print(json.dumps(dict(kernels=kernels)))
    print(_gpu_line())
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
