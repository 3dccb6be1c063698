#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``im23d_tpu_torch``) once on one GPU.

Phases:
  1. build the CUDA kernels from ``im23d_tpu_torch/csrc/`` (nvcc, sm_90a);
     the projection kernels' cluster plans (``projection_plan``) at every
     (S, K) below and ``cudaOccupancyMaxActiveClusters`` of each;
  2. K1 (projection forward, one thread-block cluster a cloud) against its
     plain PyTorch chain at the chairs candidate-sweep shape: 480 clouds x
     8000 points, 64^3 grid, at the schedule's sigma/keep-prob ends and
     midpoint; the peak memory of one call (below a quarter of the
     (B, S, S, S) grid it no longer allocates); then at the card tests'
     (S, K) (``PROJ_SHAPES``: the generic kernel instance), on clouds at
     the edges of the cluster layout (points on the planes between two
     CTAs' slabs and at z = S - 1, a blob past the splat's clamp, dropped
     and culled clouds: ``_edge_operands``), on clouds without points and
     on clouds with weights of either sign (``_mixed_sign_operands``);
  3. K2 (projection backward) against its plain version
     (``projection_backward_torch``) at the winner shape: 120 clouds x 8000
     points, 64^3 grid, at the same three (sigma, p); dscale bit-equal
     over 3 launches and one call's peak memory at the first; then the
     cases of phase 2;
  4. K3 (Chamfer nearest neighbour) against the plain ``nn_dist2_torch`` at
     (24, 8000) <-> (24, 2048) and (24, 8000) <-> (24, 512): the pair mode
     (``chamfer_distance``: both directions from one launch, 3 launches
     bit-equal) and the rows-only mode in both roles, each with its plan;
  5. the chairs training slice through the port's training CLI
     (``cli/training_test_shape_net.main --synthetic --steps 10``) from a
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
     mask), sigma 1e-4, back faces culled and drawn, and its winner cache
     bit-equal to the plain winner rule (``rasterize_winners_torch``);
  9. K5 (texture sampler forward) against the plain
     ``grid_sample_bilinear_torch``: 50 textures of 128 x 130 x 3 sampled
     at 50 x 256² points, at phase 8's rendered UVs and at random
     coordinates in [-1.1, 1.1]; at the rendered UVs its event time over
     50 back-to-back calls (the kernels line's ``ms``, as for every
     kernel), its device-only time (a CUDA graph of 50 calls:
     ``device_ms``), its wrapper's host time, and ``F.grid_sample``'s
     event time (``library_ms``) and device time with and without the
     NCHW permute, each over 5 repeats (min / median / max);
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
     gradient the hard mask), each with the plan it took (runs of
     neighbouring samples a thread) and whether its launches are
     bit-equal; ``F.grid_sample``'s backward timed beside it at both
     shapes, with the bound at both (the grid read only where the upstream
     is not 0); then at a 256 x 258 x 3 texture and at 5 channels (a
     thread a sample);
 13. K4 backward against autograd of the plain rasterizer at 50 x 256² x
     960 faces, A = 3, sigma 1e-4, back faces culled (the plain version on
     the first 10 images; the gradients of separate images are
     independent), bit-equal over 3 launches there, and with back faces
     drawn on 10 images; then on 2 images of 40 random faces with one face
     covering the whole image and faces partly off-screen, both cull
     modes;
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
     visibility mask and inverse render of 4 images held to the plain path;
 18. K8 forward (the GAN's texture-head conv) against its plain version at
     the head's shape, 32 x 64 x 512 x 256 -> 3, in bfloat16 and float32,
     replicate and circular padding; cuDNN's conv + bias + tanh timed
     beside it; the bfloat16 (tensor-core) kernel also at 8 and 128 input
     channels, ragged H and W (40: one partial column tile; 45: the plain
     loads) and an x that is not 16-byte aligned, both paddings;
 19. K8 dW against its float64 plain version (the upstream dy·(1 − y²)
     rounded to x's type first, as the JAX VJP rounds it) at that shape,
     on each of 3 launches, bit-equal between them, then at phase 18's
     other shapes (8 and 128 input channels, ragged sizes, plain loads, an
     unaligned x); cuDNN's weight gradient timed beside it;
 20. one 1G + 2D group at bs 8 in float32 through K8 and K9 and through
     the plain head and plain folded conv, from the same state: the
     losses, the head's output, the gradients of the generator's and
     critics' parameters, and, with the plain run's G step handed the
     kernel's head output, the head's upstream gradient and its own dW, db
     and dx; at least 24 K9 launches (8 ResBlockUps a generator pass);
 21. the GAN CLI (``cli/main.main``) on phase 17's cache (100 items at
     512²) at the full CUB configuration (bs 32, 3 critics, bf16, class
     conditioning): 2 epochs with every frequency at 1, ``--continue_train``
     for a third, then ``--evaluate`` and ``--save_results``; launch counts
     of K8 forward and dW, K9, K4 and K5; finite losses and FIDs, the
     files;
 22. a learning check: 40 D steps on one fixed batch against a frozen G,
     then 40 G steps against the frozen critics;
 23. 1G + 2D groups/s at the full configuration, the batch on the card;
 24. (run after phase 4) K6 (the standalone splat) against its plain
     version at the candidate sweep's shape (480 x 8000 at 64^3, keep-prob
     0.07: the generic path) and at the eval CLI's IoU shape ((24, 8000)
     at 32^3: the shared path, a cluster of CTAs a cloud), each with its
     plan and timed; K6 backward (one launch of tiles of z-planes, each
     with its plan) against autograd of the plain splat at 120 x 8000 at
     64^3, keep-prob 0.07, and at the IoU's shape: 3 launches' hashes
     (equal: the integer splat), the outputs without dc (the other three
     bit for bit), event and device-only (CUDA graph) times with and
     without dc, and the bound of what the data needs (the cotangent's
     32-byte sectors at the gathered points' corners);
 25. (after phase 24) K7 (splat, clamp, Y/X blur; a CTA a slab of
     z-planes, each with its plan) forward and backward against the plain
     versions at 480 x 8000 at 64^3 at sigma 3.0 and 0.2, and at the
     meshing shapes (1, 8000) at 96^3 and 128^3, forward also at 170^3;
     the backward as K6's in phase 24 (its bound reads the cotangent's
     planes that hold a corner); then clouds with weights of either sign
     (uniform in (-1.5, 1.5): the clamp binds at 0 and 1): K7 forward at
     the sweep's, 96^3, 128^3 and 170^3 shapes, and K6 and K7 backward at
     S = 16, 40 and 96 (K7's at K = 21, 8 and 16), with and without dc;
 26. (in phase 6) the eval CLI's launch counts include K6, and its 3D IoU
     is held against the plain splat on the same clouds;
 27. (after phase 6) the meshing CLI (``cli/pointcloud_to_mesh.main
     --input``) on a cloud the port predicts from phase 5's checkpoint, at
     its defaults (96^3, sigma 1.5): its K7 launch and wall, the occupancy
     and the vertex and face counts against the plain path on the same
     cloud;
 28. (before phase 20) K9 (the ResBlockUp's folded affine + leaky ReLU +
     3 x 3 conv) against its plain version at blk6's shapes in bfloat16,
     32 x 128 x 512 x 256 -> 64 without the affine (the conv1 of
     ``benchmarks/fusedconv_bench.py``) and 32 x 64 x 512 x 256 -> 64 with
     it (the ResBlockUp's conv2), at each of the 8 ResBlockUp conv2
     shapes of the CLI's 512 generator at bs 32 in bfloat16 with the
     affine and replicate padding (blk1's 512 x 8 x 4 -> 512 up to blk6),
     each timed against its bound and cuDNN's pad + conv, at 8 x 64 x
     128 x 64 -> 64 in both types and pad modes, and at 2 x 32 x 12 x 40
     -> 48 (a partial last column tile) in bfloat16, both pad modes, with
     and without the affine; its
     autograd Function's dx, da, db and dW against autograd of the plain
     version there in float32, and in bfloat16 (with some pre exactly 0)
     against float64 autograd of the plain version; cuDNN's pad + conv,
     with and without the affine + leaky ReLU chain, timed beside it;
 29. (after phase 28) the bf16 generator at the CLI's configuration, bs 8,
     against the float32 one with the same weights: the K9 route's
     relative L2 error at most 1.5x that of the unfused chain it replaced
     (norm1, leaky ReLU, pad and cuDNN's conv2, each rounding to bf16);
 30. (after phase 7) the chairs training CLI without ``--synthetic``
     (``main(argv, datasets=...)``) on an in-memory render set at the
     chairs config (``ShapeNetRenderSet``: 24 train and 48 valid models of
     5 views at 128², each a random cloud of 2048 points) for 20 steps with
     ``--profile_dir``: launch counts of K1 and K2 and the (S, K) plans
     they took, finite losses, the trace file; then ``--category planes``
     for 3 steps at its config (64², N = 4000, 32³, bs 16) on 16 models:
     K1 and K2 at their (32, 21) instance;
 31. (after phase 30) the eval CLI's real-data path on that set's valid
     split with 2048-point ground truth (``--gt_points``): K3 one pair
     launch a GT batch and K6 launched; each batch's Chamfer and IoU held
     against the plain ``nn_dist2`` pair and the plain splat on the same
     clouds (phase 4's and phase 26's limits), the CLI's means against
     the plain ones;
 32. (after phase 16) ``batch_iterator`` with 2 decode processes
     (``process_workers``) on 110 fabricated CUB photos, CUDA already
     initialised: one epoch's batches bit-equal to the serial path's;
     then ``run_reconstruction --data_processes 2`` for one epoch; each
     within a bounded wait;
 33. (after phase 23) ``DeviceGANCache`` on phase 17's cache (100 items
     at 512²): the staged bytes, its batches bit-equal on the card to the
     host iterator's for two epochs; one epoch of the GAN CLI with
     ``--device_cache`` (launch counts of K8 forward, K8 dW and K9); 1G +
     2D groups/s fed from the cache and from the host iterator, in turns,
     beside phase 23's rate with the batch resident on the card;
 34. (after phase 33) the text-conditional GAN at the CLI's CUB
     configuration for a 512² cache with ``--conditional_text`` (bs 32,
     bf16, 3 critics, ``text_embedding_dim`` 256, captions of 18 tokens)
     on phase 17's cache beside a fabricated caption cache (100 items x 10
     captions, a vocabulary of 5450, seeded): one 1G + 2D group with the
     batch resident (finite losses, 3 K8, 1 K8 dW and 24 K9 launches) and
     its groups/s beside phase 23's; then the GAN CLI for one epoch with
     ``--conditional_text`` and ``--text_pretrained_encoder`` (a seeded
     AttnGAN-shaped state dict written in the phase): the encoder loaded
     and checkpointed, ``sample captions:`` in its log, its launches;
 35. (after phase 34) the serving artifacts (``serve/export.py``): the
     EMA generator of phase 34's trainer exported for CUDA, loaded and
     run on 32 latents against ``trainer.generate`` (1 K8 and 8 K9
     launches a call, through the custom ops); the reconstruction network
     at ``ReconConfig()`` (bs 50, 256² RGBA) against
     ``ReconTrainer.predict``; export, load and call times;
 36. (after phase 35) the chairs training CLI with ``--multihost`` in a
     one-rank NCCL group (the launcher's environment set as ``torchrun``
     sets it) at ``ShapeNetConfig.chairs()``: the backend, K1 and K2
     launches, finite losses, the checkpoint, the group left at the end;
 37. (after phase 36) 2 gloo ranks on the one card (``parallel/launch.py``),
     each stage of ``parallel/stages.py`` against the one-process stage on
     the same global batch: the chairs step at bs 24 in float32 at dp 2
     (12 a rank) and at dp 1 x tp 2, the recon step at ``ReconConfig()``
     in float32 (25 a rank) and a 1G + 2D group of the GAN CLI's 512
     configuration in bfloat16 (16 a rank): losses, gradients by relative
     L2 per network, the batch-norm statistics, each rank's launches of
     K1, K2, K4, K5 (forward and backward), K8, K8 dW and K9, and walls
     (the ranks time-slice one card: not a scaling result), with the
     gradient all-reduce's share;
 38. (after phase 37) ``graft_entry.dryrun_multichip(2)``: the JAX dry
     run's stages on 2 gloo ranks on the card (a tiny chairs step at dp 1
     x tp 2, a GAN and a recon step at dp 2, the production chairs step at
     tp 2), each stage's "ok" line.

Prints timings beside the GPU's name and power limit, then one JSON line
with the per-kernel results (each with its bound: the larger of the bytes
it must move over 3.35 TB/s and its operations over the peak rate of
their type, 67 TFLOP/s for float32 and 989 for bfloat16, from this run's
inputs), the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or outside a checkout of the repository.

Usage (from the repository root): python3 chip_smoke.py
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import io
import json
import math
import os
import socket
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

# outside a checkout these imports fail before anything is printed
from im23d_tpu_torch.cli import evaluation_test_shape_net as cli
from im23d_tpu_torch.cli import main as gan_cli
from im23d_tpu_torch.cli import pointcloud_to_mesh as mesh_cli
from im23d_tpu_torch.cli import run_reconstruction as recon_cli
from im23d_tpu_torch.cli import training_test_shape_net as train_cli
from im23d_tpu_torch.data import cmr
from im23d_tpu_torch.data.cmr import batch_iterator
from im23d_tpu_torch.data.device_cache import DeviceGANCache
from im23d_tpu_torch.data.fabricate import (
    ShapeNetRenderSet,
    StructuredPseudoGT,
    StructuredReconSet,
)
from im23d_tpu_torch.data.pseudogt import CubGANDataset, gan_batch_iterator
from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes, _random_shapes
from im23d_tpu_torch.geometry.marching import point_cloud_to_mesh
from im23d_tpu_torch.graft_entry import dryrun_multichip
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.losses.effective import (
    _candidate_cam,
    _downsample_masks,
    unsupervised_loss,
)
from im23d_tpu_torch.metrics.chamfer import (
    chamfer_kernel,
    chamfer_limits,
    chamfer_plan,
    nn_dist2,
    nn_dist2_kernel,
    nn_dist2_pair_torch,
    nn_dist2_torch,
)
from im23d_tpu_torch.metrics.iou import iou_3d
from im23d_tpu_torch.models import gan as gan_models
from im23d_tpu_torch.models.gan import GANConfig
from im23d_tpu_torch.models.reconstruction import replicate_pad_w
from im23d_tpu_torch.ops import _build
from im23d_tpu_torch.ops.camera import world_to_camera_zyx
from im23d_tpu_torch.ops.conv import (
    fused_affine_conv3x3_kernel,
    fused_affine_conv3x3_torch,
    head_conv_dw_kernel,
    head_conv_dw_torch,
    head_conv_dx,
    head_conv_kernel,
    head_conv_tanh_torch,
)
from im23d_tpu_torch.ops.pointcloud import keep_mask
from im23d_tpu_torch.ops.projection import (
    _prep_projection,
    _taps_and_scale,
    projection_backward_kernel,
    projection_backward_torch,
    projection_grid_torch,
    projection_kernel,
    projection_limits,
    projection_occupancy,
    projection_plan,
    projection_silhouette,
    projection_silhouette_torch,
)
from im23d_tpu_torch.ops.quaternion import qnormalize
from im23d_tpu_torch.parallel import mesh as pmesh
from im23d_tpu_torch.parallel import stages
from im23d_tpu_torch.parallel.launch import launch
from im23d_tpu_torch.ops.splat import (
    _prep_splat,
    splat_backward_kernel,
    splat_backward_torch,
    splat_blur,
    splat_blur_backward_kernel,
    splat_blur_backward_torch,
    splat_blur_grid_torch,
    splat_blur_kernel,
    splat_blur_limits,
    splat_blur_plan,
    splat_blur_torch,
    splat_backward_plan,
    splat_grid_torch,
    splat_kernel,
    splat_limits,
    splat_plan,
    trilinear_splat_torch,
)
from im23d_tpu_torch.ops.sampling import (
    grid_sample_backward_plan,
    grid_sample_bilinear,
    grid_sample_bilinear_backward_kernel,
    grid_sample_bilinear_backward_torch,
    grid_sample_bilinear_kernel,
    grid_sample_bilinear_torch,
    k5b_limits,
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
    rasterize_winners_torch,
    soft_margin,
)
from im23d_tpu_torch.serve import (
    export_gan_inference,
    export_reconstruction_inference,
    load_artifact,
)
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from im23d_tpu_torch.train.recon_trainer import (
    ReconConfig,
    ReconTrainer,
    transform_vertices,
)
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)
from tools.gpu_timing import K9_PASS
from tools.gpu_timing import events_ms as _time_ms
from tools.gpu_timing import gpu_line as _gpu_line
from tools.gpu_timing import graph_ms as _graph_ms
from tools.gpu_timing import host_ms as _host_ms
from tools.gpu_timing import peak_mib as _peak_mib
from tools.gpu_timing import GATHER_OPS, SPLAT_OPS, splat_backward_work
from tools.gpu_timing import spread as _spread

# chairs config: bs 24, 5 views, 4 pose candidates, 8000 points, 64^3 grid
B, V, K, N, S = 24, 5, 4, 8000, 64
GT_POINTS = 2048
GT_POINTS_CLI = 512  # the eval CLI's synthetic ground truth
DEVICE = "cuda"
K1_CASES = ((3.0, 0.07), (1.6, 0.535), (0.2, 1.0))  # (sigma, keep prob p)
# K1 vs plain: the kernel's splat sums in signed 64-bit fixed point (exact
# but for corner weights below 2^-17 in magnitude; weights of either sign,
# as the plain chain sums them), the blurs sum their taps in another order
# than the plain band matmul and the termination runs as a product, not
# exp of a log sum; all round at ~1e-7 of values <= 1, and the termination
# chain's sensitivity to an occupancy is bounded by ~1.  Read on an H100 at
# this shape: 1.85e-6 (the atomicAdd kernel before it 1.55e-6); the card's
# pytest holds K1 at 1e-5 too.  A wrong leading termination plane (o0 for
# exp(eps + log o0)) shifts a pixel by ~1e-5 o0.
K1_ATOL = 1e-5
# K2 vs plain, relative L2 error per output (||kernel - plain|| / ||plain||):
# the recompute rounds the splat and the blurs otherwise than the plain
# chain, so a voxel within rounding of a clamp bound (raw <= 1, u <= 1,
# eps <= o <= 1 - eps) can flip its mask and move nearby gradients by O(1) of
# their value; a max-abs bound would read those flips, not the kernel.  (A
# 2^-24 fixed-point splat, absolute where float32 is relative, flipped a
# u ~ eps = 1e-5 clip at sigma 0.2, p 1.0 and read 2.6e-4 on dgz.)
K2_REL_L2 = 1e-4
# (S, K, sigma) of the card tests' K1 and K2 cases beside the main path's
# (64, 21): the generic kernel instance (S = 60: its splat in two passes),
# and the specialised one at sigma 0.2
PROJ_SHAPES = ((16, 9, 0.8), (32, 21, 3.0), (64, 21, 0.2), (20, 7, 1.3),
               (20, 8, 1.3), (1, 1, 1.0), (9, 64, 2.0), (60, 5, 1.0),
               (64, 9, 1.0))
# K3 vs plain: same formula; nvcc may contract dz*dz + dy*dy into an FMA,
# a last-ulp difference on values of order 1.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
# slice vs plain chain: losses are sums of 120 x 64 x 64 squared errors
SLICE_RTOL = 1e-4
TRAIN_STEPS = 20  # the training CLI's run on real-data paths (phase 30)
SYNTH_STEPS = 10  # its --synthetic run (phase 5: a numpy render a batch)
LEARN_STEPS, WARM = 40, 10  # the learning check; steps before the timing
# Pipeline B, CUB config: bs 50, 256² images, 128² texture (130 wide after
# the circular pad), 960 faces, sigma 1e-4
RB, RES, TEX, SIGMA = 50, 256, 128, 1e-4
RECON_IMAGES = 110  # two full batches and a tail of 10
# K4 vs plain: the same arithmetic with FMA contraction ruled out, so the
# winners agree (the winner cache is held bit-equal to the plain rule); a
# pixel whose edge function rounds to the other side would take the other
# face's attributes, hence a quantile for feat (as the JAX package's
# rasterizer tests) and a count of differing hard-mask pixels; soft sums
# its log1p terms in another order and takes the segment parameters and
# d2 / sigma by products with reciprocals (~1e-7 each).
K4_FEAT_Q999, K4_MASK_FRAC, K4_SOFT_ATOL = 1e-5, 1e-3, 1e-4
# K5 vs plain: the same operations in the same order
K5_ATOL = 1e-5
K5_REPEATS = 5  # repeats of each K5 forward time, reported as their spread
# K5 backward vs autograd of the plain gather, relative L2 per output: d img
# sums by atomicAdd in another order, d grid adds its terms in another order
K5B_REL_L2, K5B_REPEATS = 1e-5, 5
# K4 backward vs autograd of the plain rasterizer, the limits of the JAX
# package's rasterizer gradient test (tests/test_rasterizer_pallas.py:76-80):
# max |error| below K x max(max |plain|, 1), K = 1e-3 for the corners, 1e-4
# for the attributes; and relative L2 per output at most 1e-4, so that an
# error confined to a few faces cannot hide under the max of the largest.
# Per-face sums in another order (each lane's pixels in registers, then a
# warp reduction), the segment-parameter chain that vanishes at the
# nearest point dropped (the TPU kernel's algebra), d log_miss from
# 1 - soft: relative L2 read 4.0e-6 and below on the H100.
K4B_FV_K, K4B_ATTR_K, K4B_REL_L2 = 1e-3, 1e-4, 1e-4
K4B_PLAIN_IMAGES = 10  # images the plain backward is compared on
K4B_REPEATS = 3  # launches at the main path's shape, bit-equal
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
# the CUB GAN at the CLI's defaults for a 512² cache: bs 32, 3 critics,
# 64 channels into the head, whose output is the 512 x 256 half texture
GAN_B, GAN_RES, GAN_CIN = 32, 512, 64
# K8 forward vs plain: 25·64 products per output summed in another order
# than cuDNN's (~1e-7 of values <= 1 in float32); in bfloat16 both round
# the tanh output, one bfloat16 ulp near 1 is 2^-7
K8_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (B, C, H, W) of the bfloat16 kernel's other shapes: 8 and 128 channels,
# ragged H, a partial last column tile (W = 40), plain loads (W = 45)
K8_EDGE_SHAPES = ((2, 8, 64, 256), (2, 128, 48, 128), (3, 64, 37, 40),
                  (2, 64, 19, 45))
# K8 dW vs the float64 plain version of the upstream rounded to x's type,
# relative L2 per launch: 4.2 M-term sums in float32 partial rows (read
# 1.9e-6 on the H100; cuDNN's float32 weight gradient reads 2.2e-2 at this
# shape, hence the float64 reference)
K8_DW_REL_L2, K8_DW_REPEATS = 1e-4, 3
# one 1G + 2D group, K8 vs the plain head, float32, cuDNN deterministic so
# the other convs agree bit for bit: the losses, parameter gradients by
# relative L2 per network, the texture by K8's float32 limit.  In the plain
# run's G step the rest of the step takes the kernel's head output, so the
# texture's gradient into the head is the same on both paths (the critics'
# leaky-ReLU kinks would flip under the head's float32 rounding); that
# gradient and the head's own dW, db and dx are held by relative L2 each.
GROUP_BS, GROUP_RTOL, GROUP_PARAM_RL2, GROUP_HEAD_RL2 = 8, 1e-4, 1e-3, 1e-4
GAN_EPOCHS = 2  # the GAN CLI's run, then one more resumed
# K9 vs plain, max |kernel - plain| over max(1, max |y|): 9·Cin products
# per output summed in another order than cuDNN's (~1e-7 relative in
# float32); the plain version rounds the activation to x's type as the
# kernel does, so in bfloat16 only the order and y's own rounding (2^-8
# relative) differ
K9_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# its autograd Function (the JAX VJP's formula, cuDNN in float32) against
# autograd of the plain version, relative L2 per gradient, float32
K9B_REL_L2 = 1e-4
# the same in bfloat16 against float64 autograd of the plain version: the
# backward's convs take bf16 operands and round their outputs to bf16
# (2.7e-3 to 3.5e-3 on the CPU; a dropped W-pad fold reads 1.4e-1 and the
# slope at pre = 0 9.0e-2)
K9B_BF16_REL_L2 = 6e-3
# blk6 of the 512 generator at bs 32, bf16: (Cin, Cout, affine) of the
# fused-conv benchmark's conv1 (no affine) and of the ResBlockUp's conv2
K9_MAIN = ((128, 64, False), (64, 64, True))
K9_SMALL = (8, 64, 128, 64, 64)  # B, Cin, H, W, Cout
# a width that the 32-column tile does not divide: a partial last tile
K9_PARTIAL = (2, 32, 12, 40, 48)
# the bf16 generator's relative L2 error to the float32 one: the K9 route
# at most this times the unfused chain's
K9_GEN_RATIO, K9_GEN_BS = 1.5, 8
# K6 and K7 vs plain: atomicAdd order changes between runs and K7 blurs in
# another order than the plain band matmul; values <= 1, rounding ~1e-7
K6_ATOL = K7_ATOL = 1e-5
# their backward vs autograd of the plain forward, relative L2 per output:
# the recomputed splat adds in another order, so a voxel within rounding of
# the clamp's bound can flip its mask (as K2)
K6B_REL_L2 = K7B_REL_L2 = 1e-4
IOU_S, IOU_ATOL = 32, 1e-3  # the eval CLI's 3D IoU grid; one flipped voxel
# at the 0.1 threshold moves an IoU by 1 / union (~2e-4 here)
MESH_S, MESH_SIGMA = 96, 1.5  # the meshing CLI's defaults
# Pipeline A on real-data paths: the in-memory render set's splits (a
# train batch's models; one valid batch, 2 x bs) and the planes run
RD_TRAIN, RD_VALID, PLANES_MODELS, PLANES_STEPS = 24, 48, 16, 3
WAIT_S = 300  # bound on a run fed by decode processes
# the text GAN: captions a cache item, tokens a caption, the vocabulary
# (the CUB caption cache's size), the AttnGAN encoder's embedding width
CAPTIONS, TEXT_LEN, TEXT_VOCAB, TEXT_EMB = 10, 18, 5450, 300
TEXT_GROUPS = 5  # timed 1G + 2D groups with the batch resident
# an artifact against the eager module it was traced from: the same ops on
# the same operands, so within one bfloat16 spacing near 1 (2^-7) of the
# texture; the mesh map (float32 from bf16 convs) by the same spacing of
# its largest value
SERVE_TEX_ATOL = 2.0 ** -7
CACHE_EPOCHS = 3  # epochs of one 1G + 2D group each, per timed feed
# peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, float32
# FLOP/s outside the tensor cores, dense bfloat16 FLOP/s on them
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
MULTIHOST_STEPS = 5  # phase 36: the --multihost CLI's synthetic steps
MR_WORLD = 2  # phases 37 and 38: gloo ranks on the one card
# phase 37, each multi-rank step against one process on the global batch.
# Float32 chairs and recon: cuDNN picks other algorithms at half the batch
# and the gradient average adds in another order (~1e-6 relative); the
# recon render's hard decisions (rasterizer winners) flip under such
# changes (the CPU test reads 1.6e-3 per array at dp 2).  The bfloat16
# GAN: a convolution's output moves by bf16 rounding (2^-8) where the
# algorithm differs, and the critics' leaky ReLUs and hinges pass such
# moves on as flipped slopes.  Gradients by relative L2 over a network's
# parameters; batch-norm running statistics by max |difference|.  Read on
# an H100: chairs 6.2e-5 (dp 2) and 1.0e-6 (tp 2), recon 7.4e-4 and
# 1.2e-7, the GAN's losses 6.4e-4 relative, gradients 8.7e-3 (G) and
# 5.1e-3 (D), statistics 1.4e-4.  The faults these limits are for, read
# on the same card: batch-norm moments taken per rank move the GAN's
# losses by 7.1e-3, G's gradients by 0.13 and the statistics by 2.3e-2,
# the recon step's losses by 3.7e-3 and statistics by 4.2e-3; gradients
# left unaveraged move the GAN's by 0.49.
MR_LIMITS = dict(
    chairs=dict(loss_rtol=1e-4, grad_rl2=1e-3),
    recon=dict(loss_rtol=1e-4, grad_rl2=1e-2, stats_atol=1e-4),
    gan=dict(loss_rtol=5e-3, grad_rl2=5e-2, stats_atol=1e-3))
# the kernels each multi-rank step must launch on every rank, and how often
MR_LAUNCHES = dict(chairs=dict(k1=1, k2=1),
                   recon=dict(k4=1, k4b=1, k5=1, k5b=1),
                   gan=dict(k8=3, k8b=1, k9=24))


def _bound(nbytes: float, ops: float, peak: float = PEAK_F32) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type (float32 unless given),
    whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
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
    # the projection kernels' cluster layouts, and how many clusters of
    # each the card holds at once
    lim = projection_limits(torch.device(DEVICE))
    print(f"[build] projection limits {lim}")
    for S_, K_ in [(S, 21)] + [(s_, k_) for s_, k_, _ in PROJ_SHAPES]:
        plan = projection_plan(S_, K_, lim)
        occ = [projection_occupancy(plan, S_, K_, bwd) for bwd in (False,
                                                                   True)]
        print(f"[build] projection S={S_} K={K_}: {plan}; "
              f"cudaOccupancyMaxActiveClusters K1 {occ[0]}, K2 {occ[1]}")
        if min(occ) < 1:
            raise AssertionError(f"no cluster of {plan} fits the card")


def _grid_operands(S_: int, K_: int, sigma: float, b: int, n: int,
                   seed: int, dev) -> list:
    """K1's and K2's operands on grid-coordinate planes: ``b`` random
    clouds of ``n`` camera-space points (some culled, 30 % dropped), the
    taps, scales and a random silhouette cotangent."""
    rng = np.random.RandomState(seed)
    pts = torch.as_tensor(((rng.rand(b, n, 3) - 0.5) * 1.1).astype(
        np.float32), device=dev)
    w = torch.as_tensor((rng.rand(b, n) > 0.3).astype(np.float32),
                        device=dev)
    scale = torch.as_tensor((0.2 + 1.3 * rng.rand(b)).astype(np.float32),
                            device=dev)
    gz, gy, gx, c = _prep_projection(pts, S_, w, 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale, K_,
                               b, dev)
    gsil = torch.as_tensor(rng.randn(b, S_, S_).astype(np.float32),
                           device=dev)
    return [t.contiguous() for t in (gz, gy, gx, c, taps, sc, gsil)]


def _edge_operands(S_: int, K_: int, sigma: float, planes: int, dev,
                   n: int = 512) -> list:
    """Clouds at the edges of the cluster layout, on grid coordinates:
    (0) points on the planes between two CTAs' slabs (z = kP - 0.5, kP,
    kP - 0.001 for every slab boundary kP); (1) points at the far side,
    z = S - 1 and S - 1.5, y and x at 0 or S - 1 or anywhere; (2) a blob
    that straddles a slab boundary, dense enough that the splat's clamp
    binds; (3) every point dropped (c = 0, coordinates anywhere); (4)
    every point culled (the cull of ``_prep_projection``); (5) a random
    cloud.  Returns the operands as ``_grid_operands``."""
    rng = np.random.RandomState(S_ + K_)
    f = np.float32
    cz, cy, cx = (np.zeros((6, n), f) for _ in range(3))
    c = np.ones((6, n), f)
    bounds = [k * planes + d for k in range(1, -(-S_ // planes))
              for d in (-0.5, 0.0, -0.001)] or [0.0]
    cz[0] = np.resize(np.asarray(bounds, f), n)
    cy[0], cx[0] = rng.uniform(0, S_ - 1, (2, n))
    cz[1] = np.where(rng.rand(n) < 0.5, S_ - 1, max(S_ - 1.5, 0.0))
    cy[1] = rng.choice([0.0, S_ - 1.0, rng.uniform(0, S_ - 1)], n)
    cx[1] = rng.choice([0.0, S_ - 1.0, rng.uniform(0, S_ - 1)], n)
    mid = min(planes, S_ - 1) if S_ > 1 else 0.0
    cz[2] = np.clip(mid + rng.uniform(-1.0, 1.0, n), 0, S_ - 1)
    cy[2], cx[2] = np.clip(S_ / 2 + rng.uniform(-1.0, 1.0, (2, n)), 0, S_ - 1)
    cz[3], cy[3], cx[3] = rng.uniform(0, S_ - 1, (3, n))
    c[3] = 0.0
    cz[5], cy[5], cx[5] = rng.uniform(0, S_ - 1, (3, n))
    c[5] = rng.uniform(0.0, 1.5, n)
    gz, gy, gx, cc = (torch.as_tensor(a, device=dev) for a in (cz, cy, cx, c))
    culled = torch.full((1, n, 3), 0.6, device=dev)
    g4 = _prep_projection(culled, S_, None, 1e-6)
    for t, t4 in zip((gz, gy, gx, cc), g4):
        t[4] = t4[0]
    scale = torch.as_tensor(rng.uniform(0.2, 1.5, 6).astype(f), device=dev)
    scale[2] = 1.0
    taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale, K_, 6,
                               dev)
    gsil = torch.as_tensor(rng.randn(6, S_, S_).astype(f), device=dev)
    return [t.contiguous() for t in (gz, gy, gx, cc, taps, sc, gsil)]


def _mixed_sign_operands(S_: int, K_: int, sigma: float, dev,
                         n: int = 2000) -> list:
    """Clouds with weights of either sign, on grid coordinates: points of
    weight <= 0 are pinned to coordinate 0 (``_prep_projection``), where a
    tenth of the points, of positive weight, also sit, so the signed sum
    before the clamp to [0, 1] decides the corner voxels."""
    rng = np.random.RandomState(S_ * K_)
    pts = ((rng.rand(4, n, 3) - 0.5) * 1.05).astype(np.float32)
    w = rng.uniform(-1.0, 1.0, (4, n)).astype(np.float32)
    pts[:, :n // 10] = -0.5 + rng.uniform(0.0, 0.03, (4, n // 10, 3))
    w[:, :n // 10] = np.abs(w[:, :n // 10]) + 0.5
    scale = torch.as_tensor(rng.uniform(0.2, 1.5, 4).astype(np.float32),
                            device=dev)
    gz, gy, gx, c = _prep_projection(torch.as_tensor(pts, device=dev), S_,
                                     torch.as_tensor(w, device=dev), 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale, K_, 4,
                               dev)
    gsil = torch.as_tensor(rng.randn(4, S_, S_).astype(np.float32),
                           device=dev)
    return [t.contiguous() for t in (gz, gy, gx, c, taps, sc, gsil)]


def _proj_cases(dev) -> list:
    """(tag, operands) of the checks beside the main shape: the card
    tests' (S, K), the edge clouds at the main (S, K) and at a generic
    one, a batch of empty clouds (no points) and clouds with weights of
    either sign."""
    lim = projection_limits(dev)
    cases = [(f"S={s_} K={k_} sigma={sg}",
              _grid_operands(s_, k_, sg, 3, 1000, i, dev))
             for i, (s_, k_, sg) in enumerate(PROJ_SHAPES)]
    for s_, k_, sg in ((S, 21, 3.0), (S, 21, 0.2), (20, 7, 1.3)):
        planes = projection_plan(s_, k_, lim)["planes"]
        cases.append((f"edge clouds S={s_} K={k_} sigma={sg}",
                      _edge_operands(s_, k_, sg, planes, dev)))
    empty = _grid_operands(S, 21, 3.0, 2, 0, 9, dev)
    cases.append(("empty clouds (N = 0)", empty))
    for s_, k_, sg in ((S, 21, 3.0), (16, 9, 0.8)):
        cases.append((f"mixed-sign weights S={s_} K={k_} sigma={sg}",
                      _mixed_sign_operands(s_, k_, sg, dev)))
    return cases


def _check_no_grid(tag: str, fn, clouds: int) -> float:
    """The peak memory of one call, which must stay below a quarter of the
    (clouds, S, S, S) float32 grid the kernel no longer allocates."""
    peak = _peak_mib(fn)
    grid = clouds * S ** 3 * 4 / 2**20
    print(f"[{tag}] one call at {clouds} clouds adds {peak:.2f} MiB at its "
          f"peak (the (B, S, S, S) grid would be {grid:.0f} MiB)")
    if peak >= grid / 4:
        raise AssertionError(f"{tag} allocates a grid: {peak:.1f} MiB")
    return peak


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
    gz, gy, gx, c = _prep_projection(planes, S, w, 1e-6)
    taps, sc = _taps_and_scale(sig, scale, 21, C, dev)
    k1_ops = [t.contiguous() for t in (gz, gy, gx, c, taps, sc)]
    peak = _check_no_grid("K1", lambda: projection_kernel(*k1_ops, S), C)
    for tag, ops in _proj_cases(dev):
        S_ = ops[6].shape[-1]
        got = projection_kernel(*ops[:6], S_)
        ref = projection_grid_torch(*ops[:6], S_)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        print(f"[K1] {tag}: max |kernel - plain| {e:.3e} (atol {K1_ATOL})")
        if not (torch.isfinite(got).all() and e <= K1_ATOL):
            raise AssertionError(f"K1 disagrees with plain ({tag}): {e}")
        err = max(err, e)
    # reads the planes, keep weights and scales, writes the silhouettes;
    # per point 8 corners x 4 operations, per voxel a 21-tap blur along
    # three axes (126) and the clamp and termination (5)
    bound = _bound(_nbytes(*planes, w, scale) + C * S * S * 4,
                   C * (32 * N + 131 * S ** 3))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                peak_mib=peak, **bound)


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
        if len(timed) == 1:
            # dscale is a fixed-order reduction: bit-equal launches
            ds = [projection_backward_kernel(*ops)[3] for _ in range(3)]
            same = all(torch.equal(d, ds[0]) for d in ds)
            print(f"[K2] dscale bit-equal over 3 launches: {same}")
            if not same:
                raise AssertionError("K2's dscale differs between launches")
            peak = _check_no_grid(
                "K2", lambda: projection_backward_kernel(*ops), C)
    for tag, ops in _proj_cases(dev):
        got = projection_backward_kernel(*ops)
        ref = projection_backward_torch(*ops)
        torch.cuda.synchronize()
        for name, g, r in zip(("dgz", "dgy", "dgx", "dscale"), got, ref):
            if r.numel() == 0:  # no points: nothing to compare
                if g.shape != r.shape:
                    raise AssertionError(f"K2 {name} shape {g.shape}")
                continue
            e = float((g - r).abs().max())
            rl = _rel_l2(g, r) if float(r.norm()) > 0 else e
            print(f"[K2] {tag} {name}: rel L2 {rl:.3e} (limit {K2_REL_L2}), "
                  f"max |kernel - plain| {e:.3e}")
            if not (torch.isfinite(g).all() and rl <= K2_REL_L2):
                raise AssertionError(f"K2 disagrees with plain ({tag}, "
                                     f"{name}): {rl}")
            rel = max(rel, rl)
    # the JSON line times the first case, as for K1
    return dict(max_abs_err=err, max_rel_l2=rel, peak_mib=peak, **timed[0])


def _k3_check(tag: str, got, ref) -> float:
    e = float((got - ref).abs().max())
    print(f"[K3] {tag}: max |kernel - plain| {e:.3e}")
    if not torch.allclose(got, ref, rtol=K3_RTOL, atol=K3_ATOL):
        raise AssertionError(f"K3 disagrees with plain ({tag}): {e}")
    return e


def phase_k3(gpu: str) -> dict:
    """K3 vs plain at the eval CLI's shape (GT_POINTS_CLI ground-truth
    points, whose pair the JSON line times) and at GT_POINTS: the pair
    mode (both directions from one launch; 3 launches bit-equal) and the
    rows-only mode in both roles."""
    dev = torch.device(DEVICE)
    rng = np.random.RandomState(1)
    x = _clouds(rng, B, N, dev)
    lim = chamfer_limits(dev)
    err, timed = 0.0, {}
    for m in (GT_POINTS, GT_POINTS_CLI):
        y = _clouds(rng, B, m, dev)
        for role, (n1, n2) in (("pair, pred->gt rows", (N, m)),
                               ("gt->pred rows", (m, N))):
            print(f"[K3] ({B}, {n1}) x ({B}, {n2}) {role}: plan "
                  f"{chamfer_plan(B, n1, n2, lim)}")
        ref = nn_dist2_pair_torch(x, y)
        pairs = [chamfer_kernel(x, y) for _ in range(3)]
        torch.cuda.synchronize()
        for name, got, r in zip(("pred->gt", "gt->pred"), pairs[0], ref):
            err = max(err, _k3_check(f"pair {name} ({B}, {N}) <-> ({B}, "
                                     f"{m})", got, r))
        same = all(torch.equal(a, b) for p in pairs[1:]
                   for a, b in zip(p, pairs[0]))
        print(f"[K3] pair at M={m}: 3 launches bit-equal {same}")
        if not same:
            raise AssertionError("K3's pair launches differ")
        for name, a, b, r in (("pred->gt", x, y, ref[0]),
                              ("gt->pred", y, x, ref[1])):
            got = nn_dist2(a, b)
            err = max(err, _k3_check(f"rows {name} {tuple(a.shape)} vs "
                                     f"{tuple(b.shape)}", got, r))
        ms = _time_ms(lambda: chamfer_kernel(x, y), 50)
        plain_ms = _time_ms(lambda: nn_dist2_pair_torch(x, y), 3)
        rows_ms = [_time_ms(lambda a=a, b=b: nn_dist2(a, b), 50)
                   for a, b in ((x, y), (y, x))]
        # reads both clouds, writes both outputs; per pair 3 differences,
        # 3 products, 2 sums and the row's and the column's min
        bound = _bound(_nbytes(x, y) + B * (N + m) * 4, 10 * B * N * m)
        print(f"[K3] ({B}, {N}) <-> ({B}, {m}): pair kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms; rows only pred->gt {rows_ms[0]:.4f}"
              f", gt->pred {rows_ms[1]:.4f}; bound {bound} [{gpu}]")
        timed = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bound)
    return dict(max_abs_err=err, **timed)


def _sweep_points(seed: int, clouds: int, dev) -> torch.Tensor:
    """(clouds, N, 3) camera-space points of random clouds under random
    rotations, as the candidate sweep projects them."""
    rng = np.random.RandomState(seed)
    cloud = _clouds(rng, clouds, N, dev)
    quats = qnormalize(torch.as_tensor(rng.randn(clouds, 4).astype(
        np.float32), device=dev))
    return torch.stack(world_to_camera_zyx(cloud, quats), dim=-1)


def _splat_ops(c: torch.Tensor) -> int:
    """Splat operations this run's data needs: zero-weight points add
    nothing."""
    return SPLAT_OPS * int((c != 0).sum())


def _check_grads(tag: str, got, ref, limit: float) -> tuple[float, float]:
    err = rel = 0.0
    for name, g, r in zip(("dgz", "dgy", "dgx", "dc"), got, ref):
        if g is None:  # dc not asked for
            continue
        e, rl = float((g - r).abs().max()), _rel_l2(g, r)
        print(f"[{tag}] {name}: rel L2 {rl:.3e} (limit {limit}), max "
              f"|kernel - plain| {e:.3e}, max |plain| "
              f"{float(r.abs().max()):.3e}")
        if not (torch.isfinite(g).all() and rl <= limit):
            raise AssertionError(f"{tag} disagrees with plain ({name}): {rl}")
        err, rel = max(err, e), max(rel, rl)
    return err, rel


def phase_k6(gpu: str) -> tuple[dict, dict]:
    """K6 forward against ``splat_grid_torch`` at the candidate sweep's
    shape (480 x 8000 at 64^3, keep-prob 0.07) and at the eval CLI's IoU
    shape ((24, 8000) at 32^3, the one the JSON line times); K6 backward
    (``_backward_check``) against autograd of the plain splat at the
    winners' shape (120 x 8000 at 64^3, keep-prob 0.07, which the JSON
    line times) and the IoU's, each with its plan."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(6)
    err, timed = 0.0, None
    for tag, pts, size, p in (
            ("sweep", _sweep_points(6, B * V * K, dev), S, 0.07),
            ("iou", _clouds(np.random.RandomState(7), B, N, dev), IOU_S,
             None)):
        w = None if p is None else keep_mask(gen, pts.shape[0], N, p)
        gz, gy, gx, c = _prep_splat(pts, size, w, 1e-6)
        plan = splat_plan(pts.shape[0], size, splat_limits(dev))
        print(f"[K6] {tag} {tuple(pts.shape)} at {size}^3: plan {plan}")
        got = splat_kernel(gz, gy, gx, c, size)
        ref = splat_grid_torch(gz, gy, gx, c, size)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        print(f"[K6] {tag} {tuple(pts.shape)} at {size}^3: max |kernel - "
              f"plain| {e:.3e} (atol {K6_ATOL}); occupied voxels "
              f"{float((ref > 0).float().mean()):.4f}, at the clamp "
              f"{float((ref == 1).float().mean()):.2e}")
        if not (torch.isfinite(got).all() and e <= K6_ATOL):
            raise AssertionError(f"K6 disagrees with plain ({tag}): {e}")
        err = max(err, e)
        del got, ref
        ms = _time_ms(lambda: splat_kernel(gz, gy, gx, c, size), 20)
        plain_ms = _time_ms(lambda: splat_grid_torch(gz, gy, gx, c, size), 5)
        # reads the planes and weights, writes the grid (the generic path's
        # clamp pass reads and writes it again, which the bound does not
        # count)
        bound = _bound(_nbytes(gz, gy, gx, c) + pts.shape[0] * size ** 3 * 4,
                       _splat_ops(c) + pts.shape[0] * size ** 3)
        print(f"[K6] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms per "
              f"call; bound {bound} [{gpu}]")
        timed = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bound)
    fwd = dict(max_abs_err=err, **timed)

    errs, bwd = [], None
    for tag, pts, size, p in (
            ("winners", _sweep_points(8, B * V, dev), S, 0.07),
            ("iou", _clouds(np.random.RandomState(7), B, N, dev), IOU_S,
             None)):
        w = None if p is None else keep_mask(gen, pts.shape[0], N, p)
        gz, gy, gx, c = _prep_splat(pts, size, w, 1e-6)
        g = torch.randn((pts.shape[0], size, size, size), device=dev,
                        generator=gen)
        plan = splat_backward_plan(pts.shape[0], size, 0,
                                   splat_blur_limits(dev))
        print(f"[K6 bwd] {tag} {tuple(pts.shape)} at {size}^3: plan {plan}")
        timed = _backward_check(
            f"K6 bwd {tag}",
            lambda dc=True: splat_backward_kernel(gz, gy, gx, c, g,
                                                  need_dc=dc),
            lambda: splat_backward_torch(gz, gy, gx, c, g), K6B_REL_L2,
            splat_backward_work(gz, gy, gx, c, size, 0), gpu)
        errs.append(timed)
        bwd = bwd or timed
    bwd = dict(bwd, max_abs_err=max(t["max_abs_err"] for t in errs),
               max_rel_l2=max(t["max_rel_l2"] for t in errs))
    return fwd, bwd


def _digest(t: torch.Tensor) -> str:
    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def _backward_check(tag: str, kernel, plain, limit: float, work,
                    gpu: str, reps: int = 20) -> dict:
    """K6 or K7 backward (``kernel(dc)``) against autograd of its plain
    version (relative L2 per output <= ``limit``); 3 launches' hashes,
    which must be equal (weights >= 0: the integer splat); without dc,
    dc None and the other three outputs bit for bit; event and
    device-only (CUDA graph) times with and without dc, the plain
    version's, and the bound of ``work`` (bytes, operations) with dc."""
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err, rel = _check_grads(tag, got, ref, limit)
    del ref
    digests = [[_digest(t) for t in got]] + [
        [_digest(t) for t in kernel()] for _ in range(2)]
    print(f"[{tag}] 3 launches' hashes {digests}")
    if any(d != digests[0] for d in digests[1:]):
        raise AssertionError(f"{tag}: launches differ")
    part = kernel(False)
    if part[3] is not None or not all(
            torch.equal(a, b) for a, b in zip(part[:3], got[:3])):
        raise AssertionError(f"{tag}: need_dc=False changed the gradients")
    del got, part
    ms, dev_ms = _time_ms(kernel, reps), _graph_ms(kernel, reps)
    no_dc_ms = _time_ms(lambda: kernel(False), reps)
    no_dc_dev_ms = _graph_ms(lambda: kernel(False), reps)
    plain_ms = _time_ms(plain, 3)
    bound = _bound(*work)
    print(f"[{tag}] kernel {ms:.4f} ms by events, {dev_ms:.4f} device-only "
          f"(CUDA graph); without dc {no_dc_ms:.4f} / {no_dc_dev_ms:.4f}; "
          f"plain {plain_ms:.3f} ms per call; bound {bound} [{gpu}]")
    return dict(max_abs_err=err, max_rel_l2=rel, ms=ms, device_ms=dev_ms,
                no_dc_ms=no_dc_ms, no_dc_device_ms=no_dc_dev_ms,
                plain_ms=plain_ms, library_ms=None, **bound)


def _k7_bound(gz, c, taps, size: int) -> dict:
    """K7 forward: reads the planes, weights and taps, writes the grid;
    per voxel 2 K operations along each of Y and X and the clamp; the
    splat.  (Its backward's: ``splat_backward_work``.)"""
    clouds, n = gz.shape
    voxels = clouds * size ** 3
    nbytes = 4 * (4 * clouds * n + taps.numel()) + 4 * voxels
    ops = (4 * taps.numel() + 1) * voxels + _splat_ops(c)
    return _bound(nbytes, ops)


def _signed_clouds(seed: int, clouds: int, n: int, size: int, dev):
    """Grid-coordinate planes of random points in [-0.45, 0.45] with
    weights uniform in (-1.5, 1.5): the splat's clamp binds at 0 and 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand((clouds, n, 3), device=dev, generator=gen) * 0.9 - 0.45
    w = torch.rand((clouds, n), device=dev, generator=gen) * 3.0 - 1.5
    return _prep_splat(pts, size, w, 1e-6)


def _k7_taps(sigma: float, clouds: int, dev) -> torch.Tensor:
    taps, _ = _taps_and_scale(torch.tensor(sigma, device=dev), 1.0, 21,
                              clouds, dev)
    return taps.contiguous()


def _k7_forward_check(tag: str, ops, taps, size: int) -> float:
    plan = splat_blur_plan(ops[0].shape[0], size, taps.numel(),
                           splat_blur_limits(ops[0].device))
    got = splat_blur_kernel(*ops, taps, size)
    ref = splat_blur_grid_torch(*ops, taps, size)
    torch.cuda.synchronize()
    e = float((got - ref).abs().max())
    print(f"[K7] {tag} {tuple(ops[0].shape)} at {size}^3: plan {plan}; max "
          f"|kernel - plain| {e:.3e} (atol {K7_ATOL}); max "
          f"{float(ref.max()):.4f}")
    if not (torch.isfinite(got).all() and e <= K7_ATOL):
        raise AssertionError(f"K7 disagrees with plain ({tag}): {e}")
    return e


def phase_k7(gpu: str) -> tuple[dict, dict]:
    """K7 forward and backward against the plain splat + clamp + Y/X blur
    at the candidate sweep's shape (480 x 8000 at 64^3, keep-prob 0.07) at
    the sigma schedule's ends, and at the meshing shapes ((1, 8000) at 96^3,
    the CLI's default, which the JSON line times, and at 128^3), forward
    also at 170^3; the backward by ``_backward_check`` with its plan; then
    with weights of either sign: K7 forward at those grids, and K6 and K7
    backward at S = 16, 40 and 96, K7's at K = 21, 8 and 16, with and
    without dc."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(7)
    sweep = _sweep_points(9, B * V * K, dev)
    sweep_w = keep_mask(gen, B * V * K, N, 0.07)
    cloud = _clouds(np.random.RandomState(10), 1, N, dev)
    errs, rels, timed = [], [], {}
    for tag, pts, w, size, sigma in (
            ("sweep", sweep, sweep_w, S, 3.0),
            ("sweep", sweep, sweep_w, S, 0.2),
            ("mesh", cloud, None, MESH_S, MESH_SIGMA),
            ("mesh", cloud, None, 128, MESH_SIGMA)):
        gz, gy, gx, c = _prep_splat(pts, size, w, 1e-6)
        taps = _k7_taps(sigma, pts.shape[0], dev)
        e = _k7_forward_check(f"{tag} sigma {sigma}", (gz, gy, gx, c), taps,
                              size)
        g = torch.randn((pts.shape[0], size, size, size), device=dev,
                        generator=gen)
        reps = 20 if tag == "sweep" else 50
        ms = _time_ms(lambda: splat_blur_kernel(gz, gy, gx, c, taps, size),
                      reps)
        plain_ms = _time_ms(
            lambda: splat_blur_grid_torch(gz, gy, gx, c, taps, size), 3)
        bound = _k7_bound(gz, c, taps, size)
        print(f"[K7] {tag} at {size}^3, sigma {sigma}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms per call; bound {bound} [{gpu}]")
        fwd = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bound)
        if tag == "mesh":
            dev_ms = _graph_ms(lambda: splat_blur_kernel(gz, gy, gx, c, taps,
                                                         size), reps)
            print(f"[K7] mesh at {size}^3: kernel {dev_ms:.4f} ms "
                  f"device-only (CUDA graph) [{gpu}]")
        plan = splat_backward_plan(pts.shape[0], size, taps.numel(),
                                   splat_blur_limits(dev))
        print(f"[K7 bwd] {tag} at {size}^3: plan {plan}")
        bwd = _backward_check(
            f"K7 bwd {tag} {size} {sigma}",
            lambda dc=True: splat_blur_backward_kernel(gz, gy, gx, c, taps, g,
                                                       need_dc=dc),
            lambda: splat_blur_backward_torch(gz, gy, gx, c, taps, g),
            K7B_REL_L2, splat_backward_work(gz, gy, gx, c, size,
                                            taps.numel()), gpu, reps)
        errs.append((e, bwd["max_abs_err"]))
        rels.append(bwd["max_rel_l2"])
        timed.setdefault((tag, size), (fwd, bwd))
        del g
        torch.cuda.empty_cache()
    ops = _prep_splat(cloud, 170, None, 1e-6)
    errs.append((_k7_forward_check("mesh", ops, _k7_taps(MESH_SIGMA, 1, dev),
                                   170), 0.0))
    # weights of either sign: the clamp binds at both ends
    for seed, clouds, size, sigma in ((11, B * V * K, S, 3.0),
                                      (12, 1, MESH_S, MESH_SIGMA),
                                      (13, 1, 128, MESH_SIGMA),
                                      (14, 1, 170, MESH_SIGMA)):
        ops = _signed_clouds(seed, clouds, N, size, dev)
        errs.append((_k7_forward_check("signed", ops, _k7_taps(
            sigma, clouds, dev), size), 0.0))
    for size in (16, 40, MESH_S):
        gz, gy, gx, c = _signed_clouds(20 + size, 2, 3000, size, dev)
        g = torch.randn((2, size, size, size), device=dev, generator=gen)
        cases = [("K6 bwd", lambda dc: splat_backward_kernel(
                      gz, gy, gx, c, g, need_dc=dc),
                  lambda: splat_backward_torch(gz, gy, gx, c, g))]
        for ks in (21, 8, 16):
            taps, _ = _taps_and_scale(torch.tensor(MESH_SIGMA, device=dev),
                                      1.0, ks, 2, dev)
            taps = taps.contiguous()
            cases.append((f"K7 bwd K={ks}", lambda dc, taps=taps:
                          splat_blur_backward_kernel(gz, gy, gx, c, taps, g,
                                                     need_dc=dc),
                          lambda taps=taps: splat_blur_backward_torch(
                              gz, gy, gx, c, taps, g)))
        for name, kernel, plain in cases:
            ref = plain()
            for dc in (True, False):
                got = kernel(dc)
                if dc == (got[3] is None):
                    raise AssertionError(f"{name}: dc {got[3] is not None}")
                e_b, rel = _check_grads(
                    f"{name} signed {size}{'' if dc else ' without dc'}",
                    got, ref, K7B_REL_L2)
                errs.append((0.0, e_b))
                rels.append(rel)
    fwd, bwd = timed[("mesh", MESH_S)]
    return (dict(fwd, max_abs_err=max(e for e, _ in errs)),
            dict(bwd, max_abs_err=max(e for _, e in errs),
                 max_rel_l2=max(rels)))


_KERNELS = dict(k1=projection_kernel, k2=projection_backward_kernel,
                k3=chamfer_kernel, k3r=nn_dist2_kernel, k4=rasterize_kernel,
                k4b=rasterize_backward_kernel, k5=grid_sample_bilinear_kernel,
                k5b=grid_sample_bilinear_backward_kernel,
                k6=splat_kernel, k6b=splat_backward_kernel,
                k7=splat_blur_kernel, k7b=splat_blur_backward_kernel,
                k8=head_conv_kernel, k8b=head_conv_dw_kernel,
                k9=fused_affine_conv3x3_kernel)


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
        rc = train_cli.main(["--synthetic", "--steps", str(SYNTH_STEPS),
                             "--workdir", workdir, "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    out = buf.getvalue().strip()
    for line in out.splitlines():
        print(f"[train] cli: {line}")
    print(f"[train] CLI main rc {rc} in {secs:.2f} s ({SYNTH_STEPS} steps "
          f"incl. host-side synthetic batches); launches {launches}")
    if rc != 0:
        raise AssertionError(f"training CLI returned {rc}")
    losses = ast.literal_eval(out.splitlines()[-1])
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite training losses: {losses}")
    if launches["k1"] < 1 or launches["k2"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    tree = torch.load(os.path.join(workdir, f"checkpoint_{SYNTH_STEPS}.pt"),
                      map_location="cpu", weights_only=True)
    n_state = len(tree["opt_state"]["state"])
    print(f"[train] checkpoint step {tree['step']}, optimizer state for "
          f"{n_state} parameters")
    if tree["step"] != SYNTH_STEPS or n_state == 0:
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
    if metrics["step"] != SYNTH_STEPS:
        raise AssertionError(f"eval restored step {metrics['step']}")
    for key in ("projection_loss", "total_loss", "chamfer_l2", "iou_3d"):
        if not math.isfinite(metrics[key]):
            raise AssertionError(f"{key} is not finite: {metrics[key]}")
    if metrics["student_projection_shape"] != [B * V, S, S]:
        raise AssertionError(f"student grid {metrics['student_projection_shape']}")
    if metrics["candidate_projection_shape"] != [B * V, K, S, S]:
        raise AssertionError(
            f"candidate grid {metrics['candidate_projection_shape']}")
    if min(launches[k] for k in ("k1", "k3", "k6")) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if (launches["k3"], launches["k3r"]) != (1, 0):
        raise AssertionError("the eval CLI's Chamfer is not one pair launch: "
                             f"{launches}")
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
        # the CLI's 3D IoU (K6) against the plain splat on the same clouds
        gt = torch.as_tensor(_random_shapes(np.random.RandomState(123), B,
                                            GT_POINTS_CLI), device=DEVICE)
        pred = out["point_cloud"]
        iou_k = iou_3d(pred, gt, voxel_size=IOU_S)
        va, vb = (trilinear_splat_torch(x, IOU_S) > 0.1 for x in (pred, gt))
        iou_p = ((va & vb).float().sum(dim=(1, 2, 3))
                 / (va | vb).float().sum(dim=(1, 2, 3)).clamp(min=1.0))
    e = float((iou_k - iou_p).abs().max())
    e_cli = abs(metrics["iou_3d"] - float(iou_p.mean()))
    print(f"[slice] 3D IoU at {IOU_S}^3: per cloud max |K6 - plain| {e:.3e}, "
          f"CLI mean {metrics['iou_3d']:.6f} vs plain "
          f"{float(iou_p.mean()):.6f} (atol {IOU_ATOL})")
    if not (e <= IOU_ATOL and e_cli <= IOU_ATOL):
        raise AssertionError("the 3D IoU disagrees with the plain splat")

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


def phase_mesh(gpu: str, workdir: str) -> dict:
    """The meshing CLI on the cloud the port predicts from the training
    phase's checkpoint (``--input``: this machine has no PIL for
    ``--workdir --image``), at its defaults (96^3, sigma 1.5, level 0.2);
    its K7 launches and wall; the occupancy and the mesh against the plain
    path on the same cloud."""
    cfg = ShapeNetConfig.chairs()
    learner = ShapeNetLearner(cfg, device=DEVICE)
    learner.restore(workdir)
    batch = SyntheticSilhouettes(B, cfg.image_size, V, n_points=512,
                                 seed=3).next_batch()
    with torch.no_grad():
        nb = learner._normalize(batch)
        cloud = learner.model(nb["images"], nb["pose_input"])["point_cloud"]
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "cloud.npy"), os.path.join(tmp, "m.obj")
        np.save(src, cloud[0].float().cpu().numpy())
        _zero_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mesh_cli.main(["--input", src, "--output", out,
                                "--voxel_size", str(MESH_S), "--sigma",
                                str(MESH_SIGMA), "--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        with open(out) as fh:
            lines = fh.read().splitlines()
        pts = mesh_cli.load_points(src)
    print(f"[mesh] cli: {buf.getvalue().strip()}")
    n_v = sum(line.startswith("v ") for line in lines)
    n_f = sum(line.startswith("f ") for line in lines)
    pts_d = torch.as_tensor(pts, device=DEVICE)[None]
    one = torch.ones(1, device=DEVICE)
    with torch.no_grad():
        occ = splat_blur(pts_d, MESH_S, MESH_SIGMA, one)
        ref = splat_blur_torch(pts_d, MESH_S, MESH_SIGMA, one)
    torch.cuda.synchronize()
    e = float((occ - ref).abs().max())
    verts, faces = point_cloud_to_mesh(pts, MESH_S, MESH_SIGMA, device="cpu")
    print(f"[mesh] CLI rc {rc} in {wall:.3f} s ({N} points, {MESH_S}^3, "
          f"host marching tetrahedra included); launches {launches}; "
          f"occupancy max |K7 path - plain| {e:.3e} (atol {K7_ATOL}); "
          f"{n_v} vertices, {n_f} faces vs plain path on the CPU "
          f"{len(verts)}, {len(faces)} [{gpu}]")
    if rc != 0 or n_f == 0:
        raise AssertionError(f"the meshing CLI returned {rc}, {n_f} faces")
    if launches["k7"] != 1:
        raise AssertionError(f"K7 launched {launches['k7']} times, not 1")
    if e > K7_ATOL or (n_v, n_f) != (len(verts), len(faces)):
        raise AssertionError("the meshing path disagrees with the plain path")
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
        # the winner cache K4 writes for its backward: the plain rule's bits
        cache = _launch_forward(verts[:, faces], attrs, RES, RES, SIGMA,
                                cull, True)[2:]
        rule = rasterize_winners_torch(verts, faces, RES, RES, cull)
        same = [torch.equal(a, b) for a, b in zip(cache, rule)]
        print(f"[K4] cull={cull}: winner cache (win, wz) bit-equal to the "
              f"plain winner rule: {same}")
        if not all(same):
            raise AssertionError(f"K4's winner cache differs (cull={cull})")
        del cache, rule
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
    img_nchw = tex_adj.permute(0, 3, 1, 2).contiguous()

    def kernel():
        return grid_sample_bilinear_kernel(tex_adj, grid)

    def library():
        return F.grid_sample(img_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    def library_permute():
        return F.grid_sample(tex_adj.permute(0, 3, 1, 2).contiguous(), grid,
                             mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    # event times of 50 back-to-back calls (as every other kernel is
    # timed), device-only times (CUDA graphs of 50 calls) and the
    # wrapper's host time, each repeated
    runs = {k: [] for k in ("event", "device", "library_event", "library",
                            "library_permute", "host")}
    for _ in range(K5_REPEATS):
        runs["event"].append(_time_ms(kernel, 50))
        runs["device"].append(_graph_ms(kernel, 50))
        runs["library_event"].append(_time_ms(library, 50))
        runs["library"].append(_graph_ms(library, 50))
        runs["library_permute"].append(_graph_ms(library_permute, 50))
        runs["host"].append(_host_ms(kernel, 500))
    spread = {k: _spread(v) for k, v in runs.items()}
    plain_ms = _time_ms(lambda: grid_sample_bilinear_torch(tex_adj, grid), 10)
    for k, v in spread.items():
        print(f"[K5] {tuple(tex_adj.shape)} at {RB} x {RES}², {k} ms per call "
              f"over {K5_REPEATS} repeats: min {v['min']:.4f} / median "
              f"{v['median']:.4f} / max {v['max']:.4f} [{gpu}]")
    print(f"[K5] plain {plain_ms:.3f} ms per call [{gpu}]")
    if spread["device"]["median"] > spread["library"]["median"]:
        print(f"[K5] note: device time above F.grid_sample's [{gpu}]")
    # reads the texture and the grid, writes C floats a sample; 4 corners x
    # C products and sums plus ~12 for the weights
    C = tex_adj.shape[-1]
    bound = _bound(_nbytes(tex_adj, grid) + grid[..., 0].numel() * C * 4,
                   grid[..., 0].numel() * (12 + 8 * C))
    return dict(max_abs_err=err, ms=spread["event"]["median"],
                plain_ms=plain_ms,
                library_ms=spread["library_event"]["median"],
                device_ms=spread["device"]["median"],
                library_device_ms=spread["library"]["median"],
                library_permute_device_ms=spread["library_permute"]["median"],
                host_ms=spread["host"]["median"], spread=spread, **bound)


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


def _contributing(dout: torch.Tensor) -> int:
    """Samples whose upstream is not 0 on every channel: the others add
    nothing to d texture, and their d grid is 0."""
    return int((dout != 0).any(dim=-1).sum())


def _k5_backward_other_shapes() -> None:
    """K5 backward at a texture of ``--texture_resolution 256`` (256 x 258
    x 3, the runs kernel takes any size) and at 5 channels (a thread a
    sample), 4 images x 256² random samples each: d img and d grid by
    relative L2 against the plain version, and under a 0/1 upstream the
    texels with d img > 0 exactly."""
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    for shape in ((4, 256, 258, 3), (4, 64, 66, 5)):
        B, C = shape[0], shape[-1]
        img = torch.rand(shape, device=DEVICE, generator=gen)
        grid = (torch.rand((B, RES, RES, 2), device=DEVICE, generator=gen)
                * 2.2 - 1.1)
        plan = grid_sample_backward_plan(*shape, RES * RES, True,
                                         k5b_limits())
        for what, dout in (
                ("random", torch.randn((B, RES, RES, C), device=DEVICE,
                                       generator=gen)),
                ("0/1", (torch.rand((B, RES, RES, 1), device=DEVICE,
                                    generator=gen) > 0.5).float()
                 .expand(-1, -1, -1, C).contiguous())):
            got = grid_sample_bilinear_backward_kernel(img, grid, dout)
            ref = grid_sample_bilinear_backward_torch(img, grid, dout)
            rls = [_rel_l2(g, r) for g, r in zip(got, ref)]
            same = bool(torch.equal(got[0] > 0, ref[0] > 0))
            print(f"[K5 bwd] {shape} <- {B} x {RES}², {what} upstream: plan "
                  f"{plan}; rel L2 d img {rls[0]:.3e}, d grid {rls[1]:.3e} "
                  f"(limit {K5B_REL_L2}); texels > 0 equal {same}")
            if max(rls) > K5B_REL_L2 or (what == "0/1" and not same):
                raise AssertionError(f"K5 backward disagrees at {shape}")


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
        plan = grid_sample_backward_plan(*tex_adj.shape, RES * RES, True,
                                         k5b_limits())
        print(f"[K5 bwd] {name} {tuple(tex_adj.shape)} <- {RB} x {RES}²: "
              f"plan {plan}")
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
        # d img's atomic order changes from launch to launch: each of
        # K5B_REPEATS launches is held; d grid has no atomics
        rls = {"d img": [], "d grid": []}
        first, same = None, [True, True]
        for _ in range(K5B_REPEATS):
            got = grid_sample_bilinear_backward_kernel(tex_adj, grid, dout)
            first = got if first is None else first
            same = [a and bool(torch.equal(g, f))
                    for a, g, f in zip(same, got, first)]
            for (what, rl), g, r in zip(rls.items(), got, ref):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"K5 backward not finite ({name})")
                rl.append(_rel_l2(g, r))
                err = max(err, float((g - r).abs().max()))
        print(f"[K5 bwd] {name}: bit-equal over {K5B_REPEATS} launches: "
              f"d img {same[0]}, d grid {same[1]}")
        del first
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
            n, C = _contributing(dout), tex_adj.shape[-1]
            # reads texture, upstream and the grid of the samples whose
            # upstream is not 0 on every channel (no other sample adds
            # anything); writes d texture and d grid; per contributing
            # sample 4 corners x C x 4 operations plus ~20
            bound = _bound(_nbytes(tex_adj, dout) + 8 * n
                           + _nbytes(tex_adj, grid), n * (20 + 16 * C))
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
    plan = grid_sample_backward_plan(*tex_adj.shape, vres * vres, True,
                                     k5b_limits())
    print(f"[K5 bwd] visibility {tuple(tex_adj.shape)} <- {RB} x {vres}²: "
          f"plan {plan}")
    ref, _ = grid_sample_bilinear_backward_torch(tex_adj, vgrid, dout)
    rls, same, first, equal = [], True, None, True
    for _ in range(K5B_REPEATS):
        got, _ = grid_sample_bilinear_backward_kernel(tex_adj, vgrid, dout,
                                                      need_grid=False)
        rls.append(_rel_l2(got, ref))
        same = same and bool(torch.equal(got > 0, ref > 0))
        first = got if first is None else first
        equal = equal and bool(torch.equal(got, first))
    cover = float((ref > 0).float().mean())
    print(f"[K5 bwd] visibility {tuple(tex_adj.shape)} <- {RB} x {vres}²: "
          f"d img rel L2 {min(rls):.3e} to {max(rls):.3e} over {K5B_REPEATS} "
          f"launches (limit {K5B_REL_L2}); texels > 0 equal {same}; texels "
          f"touched {cover:.4f}; launches bit-equal {equal}; samples "
          f"contributing {_contributing(dout) / dout[..., 0].numel():.4f}")
    del first
    if not (same and max(rls) <= K5B_REL_L2):
        raise AssertionError("K5 backward disagrees at the visibility shape")
    vis_ms = _time_ms(lambda: grid_sample_bilinear_backward_kernel(
        tex_adj, vgrid, dout, need_grid=False), 10)
    vis_plain_ms = _time_ms(lambda: grid_sample_bilinear_backward_torch(
        tex_adj, vgrid, dout), 2)
    del got, ref
    img_nchw = tex_adj.permute(0, 3, 1, 2).contiguous()
    dout_nchw = dout.permute(0, 3, 1, 2).contiguous()
    vis_library_ms = _time_ms(
        lambda: torch.ops.aten.grid_sampler_2d_backward(
            dout_nchw, img_nchw, vgrid, 0, 0, True, [True, False]), 10)
    n, C = _contributing(dout), tex_adj.shape[-1]
    # reads the upstream and the grid of the contributing samples, writes
    # d texture; per contributing sample 4 corners x C products and sums
    # plus ~12 for the weights
    vis_bound = _bound(_nbytes(dout, tex_adj) + 8 * n, n * (12 + 8 * C))
    print(f"[K5 bwd] visibility shape: kernel {vis_ms:.3f} ms, plain "
          f"{vis_plain_ms:.3f} ms, grid_sampler_2d_backward (d input "
          f"only, NCHW) {vis_library_ms:.3f} ms per call; bound {vis_bound} "
          f"[{gpu}]")
    del vgrid, dout, img_nchw, dout_nchw
    torch.cuda.empty_cache()
    _k5_backward_other_shapes()
    return dict(max_abs_err=err, **timed, visibility_ms=vis_ms,
                visibility_plain_ms=vis_plain_ms,
                visibility_library_ms=vis_library_ms,
                visibility_bound_ms=vis_bound["bound_ms"],
                visibility_bound_by=vis_bound["bound_by"])


def _k4b_check(tag: str, got, ref) -> float:
    """K4 backward's (d fv, d attrs) against the plain version's, at the
    K4B limits; returns the larger max |error|."""
    err = 0.0
    for what, g, r, k in (("d fv", got[0], ref[0], K4B_FV_K),
                          ("d attrs", got[1], ref[1], K4B_ATTR_K)):
        e, rl = float((g - r).abs().max()), _rel_l2(g, r)
        limit = k * max(float(r.abs().max()), 1.0)
        print(f"[K4 bwd] {tag} {what}: max |kernel - plain| {e:.3e} (limit "
              f"{limit:.3e}), rel L2 {rl:.3e} (limit {K4B_REL_L2}), max "
              f"|plain| {float(r.abs().max()):.3e}")
        if not (torch.isfinite(g).all() and e < limit and rl <= K4B_REL_L2):
            raise AssertionError(f"K4 backward disagrees ({tag}, {what})")
        err = max(err, e)
    return err


def _k4b_edge_scene(dev):
    """2 images of 40 random faces of both windings (corners in
    [-0.9, 0.9]), face 3 covering the whole image (its corners far
    outside, z lowest), faces 5-12 reaching past the image's right or top
    edge, random attributes."""
    rng = np.random.RandomState(17)
    B, F = 2, 40
    fv = rng.uniform(-0.9, 0.9, (B, F, 3, 3)).astype(np.float32)
    fv[:, 3, :, :2] = [[-4.0, -4.0], [4.0, -4.0], [0.0, 5.0]]
    fv[:, 3, :, 2] = -0.95
    fv[:, 5:9, :, 0] += 0.9
    fv[:, 9:13, :, 1] += 0.9
    attrs = rng.rand(B, F, 3, 3).astype(np.float32)
    return (torch.from_numpy(fv).to(dev), torch.from_numpy(attrs).to(dev))


def phase_k4_backward(gpu: str, scene) -> dict:
    """K4 backward vs autograd of the plain rasterizer: culled on all 50
    images (the plain version on the first K4B_PLAIN_IMAGES), bit-equal
    over K4B_REPEATS launches, back faces drawn on K4B_PLAIN_IMAGES images;
    then the edge scene in both cull modes."""
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
        err = max(err, _k4b_check(f"cull={cull} (images 0-{n - 1})",
                                  (got[0][:n], got[1][:n]), ref))
        if cull:
            again = [rasterize_backward_kernel(
                fv, at, dfeat, dsoft, *fwd[1:], RES, RES, SIGMA, cull)
                for _ in range(K4B_REPEATS - 1)]
            same = all(torch.equal(a[i], got[i]) for a in again
                       for i in range(2))
            print(f"[K4 bwd] {K4B_REPEATS} launches at {rb} x {RES}² "
                  f"bit-equal: {same}")
            if not same:
                raise AssertionError("K4 backward differs between launches")
            del again
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
    fv, at = _k4b_edge_scene(torch.device(DEVICE))
    for cull in (True, False):
        dfeat = torch.randn((2, RES, RES, 3), device=DEVICE, generator=gen)
        dsoft = torch.randn((2, RES, RES, 1), device=DEVICE, generator=gen)
        fwd = _launch_forward(fv, at, RES, RES, SIGMA, cull, True)
        got = rasterize_backward_kernel(fv, at, dfeat, dsoft, *fwd[1:], RES,
                                        RES, SIGMA, cull)
        ref = rasterize_backward_torch(fv, at, dfeat, dsoft, RES, RES, SIGMA,
                                       cull)
        torch.cuda.synchronize()
        err = max(err, _k4b_check(f"edge scene, cull={cull}", got, ref))
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


def _head_operands(dtype, seed: int):
    """K8's operands at the head's shape: a leaky-ReLU activation like
    blk6's output, LeCun-scaled weights rounded to ``dtype``, a bias."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = F.leaky_relu(torch.randn((GAN_B, GAN_CIN, GAN_RES, GAN_RES // 2),
                                 device=DEVICE, generator=gen), 0.2).to(dtype)
    w = (torch.randn((3, GAN_CIN, 5, 5), device=DEVICE, generator=gen)
         / math.sqrt(25 * GAN_CIN)).to(dtype).float().contiguous()
    b = torch.randn(3, device=DEVICE, generator=gen) * 0.1
    return x, w, b


def _head_ops(x) -> int:
    """2 x 25 x C x 3 operations per output pixel of the head conv."""
    return 2 * 25 * 3 * x.numel()


def phase_k8(gpu: str) -> dict:
    """K8 forward vs plain at the head's shape, both types and pad modes;
    times at the main path's (bfloat16, replicate)."""
    errs, timed = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b = _head_operands(dtype, 20)
        for mode in ("replicate", "circular"):
            got = head_conv_kernel(x, w, b, mode)
            ref = head_conv_tanh_torch(x, w, b, mode)
            torch.cuda.synchronize()
            e = float((got.float() - ref.float()).abs().max())
            print(f"[K8] {str(dtype)[6:]} {mode}: max |kernel - plain| "
                  f"{e:.3e} (atol {K8_ATOL[dtype]}); |y| mean "
                  f"{float(ref.float().abs().mean()):.4f}")
            if not (torch.isfinite(got).all() and e <= K8_ATOL[dtype]):
                raise AssertionError(f"K8 disagrees with plain: {e}")
            errs[dtype, mode] = e
            del got, ref
        if dtype == torch.bfloat16:
            wd, bd = w.to(dtype), b.to(dtype)
            ms = _time_ms(lambda: head_conv_kernel(x, w, b), 20)
            plain_ms = _time_ms(lambda: head_conv_tanh_torch(x, w, b), 3)
            library_ms = _time_ms(lambda: torch.tanh(F.conv2d(
                replicate_pad_w(x, 2), wd, bd, padding=(2, 0))), 10)
            # reads x, w, b, writes y (3 of x's C channels, in x's type)
            bound = _bound(_nbytes(x, w, b) + x.numel() // GAN_CIN * 3
                           * x.element_size(), _head_ops(x), PEAK_BF16)
            print(f"[K8] {tuple(x.shape)} bf16 -> 3: kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms, cuDNN pad + conv + bias + tanh "
                  f"{library_ms:.3f} ms per call; bound {bound} [{gpu}]")
            timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         **bound)
        del x
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(23)
    for shape in K8_EDGE_SHAPES + ("unaligned",):
        if shape == "unaligned":  # x 2 bytes past a 16-byte boundary
            shape = (2, 16, 24, 64)
            n = math.prod(shape)
            x = torch.empty(n + 1, dtype=torch.bfloat16,
                            device=DEVICE)[1:].view(shape)
            x.copy_(torch.randn(shape, device=DEVICE, generator=gen))
        else:
            x = torch.randn(shape, device=DEVICE, generator=gen).to(
                torch.bfloat16)
        w = (torch.randn((3, shape[1], 5, 5), device=DEVICE, generator=gen)
             / math.sqrt(25 * shape[1]))
        b = torch.randn(3, device=DEVICE, generator=gen) * 0.1
        for mode in ("replicate", "circular"):
            got = head_conv_kernel(x, w, b, mode)
            ref = head_conv_tanh_torch(x, w, b, mode)
            torch.cuda.synchronize()
            e = float((got.float() - ref.float()).abs().max())
            print(f"[K8] bfloat16 {tuple(shape)} x at {x.data_ptr() % 16} "
                  f"mod 16, {mode}: max |kernel - plain| {e:.3e} (atol "
                  f"{K8_ATOL[torch.bfloat16]})")
            if not (torch.isfinite(got).all()
                    and e <= K8_ATOL[torch.bfloat16]):
                raise AssertionError(f"K8 disagrees with plain at {shape}")
    return dict(max_abs_err=errs[torch.bfloat16, "replicate"], **timed)


def phase_k8_dw(gpu: str) -> dict:
    """K8 dW vs its float64 plain version on each of K8_DW_REPEATS launches,
    bit-equal between them; times at the main path's (bfloat16,
    replicate)."""
    out, timed = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b = _head_operands(dtype, 21)
        gen = torch.Generator(device=DEVICE).manual_seed(22)
        for mode in ("replicate", "circular"):
            y = head_conv_kernel(x, w, b, mode).float()
            g = (torch.randn(y.shape, device=DEVICE, generator=gen)
                 * (1.0 - y * y)).contiguous()
            del y
            ref = head_conv_dw_torch(x, g, mode)
            got = [head_conv_dw_kernel(x, g, mode)
                   for _ in range(K8_DW_REPEATS)]
            torch.cuda.synchronize()
            rels = [_rel_l2(d, ref) for d in got]
            same = all(torch.equal(d, got[0]) for d in got)
            e = float((got[0] - ref).abs().max())
            print(f"[K8 dW] {str(dtype)[6:]} {mode}: relative L2 vs float64 "
                  f"plain {[f'{r:.3e}' for r in rels]} (limit {K8_DW_REL_L2})"
                  f", bit-equal launches {same}, max |diff| {e:.3e} of "
                  f"max |dW| {float(ref.abs().max()):.3e}")
            if not (max(rels) <= K8_DW_REL_L2 and same):
                raise AssertionError("K8 dW disagrees with plain or between "
                                     "launches")
            out[dtype, mode] = (e, max(rels))
            if dtype == torch.bfloat16 and mode == "replicate":
                gd = g.to(dtype)
                ms = _time_ms(lambda: head_conv_dw_kernel(x, g), 10)
                plain_ms = _time_ms(lambda: head_conv_dw_torch(x, g), 2)
                library_ms = _time_ms(lambda: torch.nn.grad.conv2d_weight(
                    replicate_pad_w(x, 2), w.shape, gd, padding=(2, 0)), 10)
                # the function the TPU kernel computes: the JAX VJP casts
                # the upstream to x's type, so bf16 products summed in
                # float32; reads x and that upstream, writes dW (the port
                # keeps the upstream in float32, its own choice)
                bound = _bound(_nbytes(x, gd, got[0]), _head_ops(x),
                               PEAK_BF16)
                print(f"[K8 dW] {tuple(x.shape)} bf16: kernel {ms:.3f} ms, "
                      f"plain (float64) {plain_ms:.3f} ms, cuDNN pad + weight "
                      f"gradient {library_ms:.3f} ms per call; bound {bound} "
                      f"[{gpu}]")
                timed = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             **bound)
                del gd
            del g, ref, got
        del x
        torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    for shape in K8_EDGE_SHAPES + ("unaligned",):
        if shape == "unaligned":  # x 2 bytes past a 16-byte boundary
            shape = (2, 16, 24, 64)
            x = torch.empty(math.prod(shape) + 1, dtype=torch.bfloat16,
                            device=DEVICE)[1:].view(shape)
            x.copy_(torch.randn(shape, device=DEVICE, generator=gen))
        else:
            x = torch.randn(shape, device=DEVICE, generator=gen).to(
                torch.bfloat16)
        g = torch.randn((shape[0], 3, *shape[2:]), device=DEVICE,
                        generator=gen)
        for mode in ("replicate", "circular"):
            got = [head_conv_dw_kernel(x, g, mode) for _ in range(2)]
            ref = head_conv_dw_torch(x, g, mode)
            torch.cuda.synchronize()
            r = _rel_l2(got[0], ref)
            print(f"[K8 dW] bfloat16 {tuple(shape)} x at "
                  f"{x.data_ptr() % 16} mod 16, {mode}: relative L2 {r:.3e} "
                  f"(limit {K8_DW_REL_L2}), bit-equal launches "
                  f"{torch.equal(got[0], got[1])}")
            if not (r <= K8_DW_REL_L2 and torch.equal(got[0], got[1])):
                raise AssertionError(f"K8 dW disagrees with plain at {shape}")
    e, rel = out[torch.bfloat16, "replicate"]
    return dict(max_abs_err=e, max_rel_l2=rel, **timed)


def _k9_operands(B, cin, H, W, cout, affine, dtype, seed):
    """K9's operands: x, per-(batch, channel) affine rows like a folded
    batch norm's, LeCun-scaled weights."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn((B, cin, H, W), device=DEVICE, generator=gen).to(dtype)
    w = torch.randn((cout, cin, 3, 3), device=DEVICE,
                    generator=gen) / math.sqrt(9 * cin)
    a = b = None
    if affine:
        a = 1.0 + 0.3 * torch.randn((B, cin), device=DEVICE, generator=gen)
        b = 0.3 * torch.randn((B, cin), device=DEVICE, generator=gen)
    return x, a, b, w


def _k9_check(x, a, b, w, mode) -> float:
    """K9 against its plain version; returns max |kernel - plain|."""
    got = fused_affine_conv3x3_kernel(x, a, b, w, mode)
    ref = fused_affine_conv3x3_torch(x, a, b, w, mode)
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.float().abs().max()))
    e = float((got.float() - ref.float()).abs().max())
    limit = K9_RTOL[x.dtype] * scale
    print(f"[K9] {tuple(x.shape)} -> {w.shape[0]} {str(x.dtype)[6:]} "
          f"{mode}{' affine' if a is not None else ''}: max |kernel - "
          f"plain| {e:.3e} (limit {limit:.3e})")
    if not (torch.isfinite(got).all() and e <= limit):
        raise AssertionError(f"K9 disagrees with plain: {e}")
    return e


def _k9_path_shapes() -> list[tuple[int, int, int, int]]:
    """(Cin, H, W, Cout) of every K9 call in one pass of the CLI's 512
    generator (bf16), read from a bs-1 pass."""
    seen = []
    fused = gan_models.fused_affine_conv3x3

    def record(x, a, b, w, mode):
        seen.append((x.shape[1], x.shape[2], x.shape[3], w.shape[0]))
        return fused(x, a, b, w, mode)

    g = gan_models.Generator(_gan_config("bfloat16"))
    gan_models.gan_init_(g, torch.Generator().manual_seed(36))
    g = g.to(DEVICE)
    with mock.patch.object(gan_models, "fused_affine_conv3x3", record), \
            torch.no_grad():
        g(torch.zeros((1, 64), device=DEVICE),
          torch.zeros((1, 1), dtype=torch.long, device=DEVICE))
    if seen != [shape for _, shape in K9_PASS]:
        raise AssertionError(f"K9 calls of a generator pass {seen}, not "
                             f"tools/gpu_timing.py's K9_PASS")
    del g
    return seen


def _k9_bf16_backward(mode: str) -> list[float]:
    """The K9 op's bf16 backward at K9_SMALL, with pre exactly 0 on a
    quarter of channel 0's pixels, against float64 autograd of the plain
    version on the same values: relative L2 of dx, da, db, dW."""
    B, cin, H, W, cout = K9_SMALL
    x, a, b, w = _k9_operands(B, cin, H, W, cout, True, torch.bfloat16, 37)
    b[:, 0] = 0.0
    x[:, 0, ::2, ::2] = 0.0
    co = torch.randn((B, cout, H, W), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(38))
    args = [t.clone().requires_grad_() for t in (x, a, b, w)]
    got = torch.autograd.grad((gan_models.fused_affine_conv3x3(
        *args, mode).float() * co).sum(), args)
    if [g.dtype for g in got] != [torch.bfloat16] + [torch.float32] * 3:
        raise AssertionError(f"K9 bf16 gradient types {[g.dtype for g in got]}")
    args = [t.double().requires_grad_() for t in (x, a, b, w)]
    ref = torch.autograd.grad((fused_affine_conv3x3_torch(*args, mode)
                               * co.double()).sum(), args)
    torch.cuda.synchronize()
    return [_rel_l2(g.double(), r) for g, r in zip(got, ref)]


def phase_k9(gpu: str) -> dict:
    """K9 forward vs plain at blk6's bf16 shapes (replicate), at each
    conv2 shape of the CLI generator at bs 32 in bf16, at K9_SMALL in
    both types and pad modes and at K9_PARTIAL in bf16; its autograd Function vs autograd of the
    plain version there in float32, and in bf16 vs float64; times at
    blk6."""
    out = {}
    for cin, cout, affine in K9_MAIN:
        x, a, b, w = _k9_operands(GAN_B, cin, GAN_RES, GAN_RES // 2, cout,
                                  affine, torch.bfloat16, 30)
        e = _k9_check(x, a, b, w, "replicate")
        wd = w.to(x.dtype)
        ms = _time_ms(lambda: fused_affine_conv3x3_kernel(x, a, b, w), 20)
        plain_ms = _time_ms(lambda: fused_affine_conv3x3_torch(x, a, b, w),
                            3)
        conv_ms = _time_ms(lambda: F.conv2d(replicate_pad_w(x, 1), wd,
                                            padding=(1, 0)), 10)
        chain_ms = None
        if affine:
            a4, b4 = a[:, :, None, None], b[:, :, None, None]
            chain_ms = _time_ms(lambda: F.conv2d(replicate_pad_w(
                F.leaky_relu(x.float() * a4 + b4, 0.2).to(x.dtype), 1), wd,
                padding=(1, 0)), 10)
        # reads x, a, b and the weights in x's type, writes y
        bound = _bound(_nbytes(x, a, b, wd) + x.numel() // cin * cout
                       * x.element_size(),
                       2 * 9 * cin * cout * x.numel() // cin, PEAK_BF16)
        print(f"[K9] {tuple(x.shape)} bf16 -> {cout}"
              f"{' affine' if affine else ''}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, cuDNN pad + conv {conv_ms:.3f} ms"
              + (f", with the float32 affine + leaky ReLU chain "
                 f"{chain_ms:.3f} ms" if affine else "")
              + f" per call; bound {bound} [{gpu}]")
        out[affine] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                           library_ms=chain_ms if affine else conv_ms,
                           conv_ms=conv_ms, **bound)
        del x, a, b, w, wd
        torch.cuda.empty_cache()
    path = []
    for i, (cin, H, W, cout) in enumerate(_k9_path_shapes()):
        x, a, b, w = _k9_operands(GAN_B, cin, H, W, cout, True,
                                  torch.bfloat16, 40 + i)
        e = _k9_check(x, a, b, w, "replicate")
        wd = w.to(x.dtype)
        reps = 10 if H * W >= 128 * 64 else 50
        ms = _time_ms(lambda: fused_affine_conv3x3_kernel(x, a, b, w), reps)
        conv_ms = _time_ms(lambda: F.conv2d(replicate_pad_w(x, 1), wd,
                                            padding=(1, 0)), reps)
        bound = _bound(_nbytes(x, a, b, wd) + x.numel() // cin * cout
                       * x.element_size(),
                       2 * 9 * cin * cout * x.numel() // cin, PEAK_BF16)
        print(f"[K9] conv2 {K9_PASS[i][0]} {(GAN_B, cin, H, W)} -> {cout}: "
              f"kernel {ms:.4f} ms, cuDNN pad + conv {conv_ms:.4f} ms per "
              f"call; bound {bound} [{gpu}]")
        path.append(dict(name=K9_PASS[i][0], shape=[GAN_B, cin, H, W,
                                                      cout],
                         ms=ms, conv_ms=conv_ms, max_abs_err=e, **bound))
        del x, a, b, w, wd
    torch.cuda.empty_cache()
    B, cin, H, W, cout = K9_SMALL
    rels = []
    for dtype in (torch.float32, torch.bfloat16):
        for affine in (True, False):
            x, a, b, w = _k9_operands(B, cin, H, W, cout, affine, dtype, 31)
            for mode in ("replicate", "circular"):
                _k9_check(x, a, b, w, mode)
    for affine in (True, False):
        x, a, b, w = _k9_operands(*K9_PARTIAL, affine, torch.bfloat16, 38)
        for mode in ("replicate", "circular"):
            _k9_check(x, a, b, w, mode)
    x, a, b, w = _k9_operands(B, cin, H, W, cout, True, torch.float32, 32)
    co = torch.randn((B, cout, H, W), device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(33))
    for mode in ("replicate", "circular"):
        def grads(fn):
            args = [t.clone().requires_grad_() for t in (x, a, b, w)]
            return torch.autograd.grad((fn(*args, mode) * co).sum(), args)
        got = grads(gan_models.fused_affine_conv3x3)
        ref = grads(fused_affine_conv3x3_torch)
        torch.cuda.synchronize()
        rel = [_rel_l2(g, r) for g, r in zip(got, ref)]
        print(f"[K9 bwd] {tuple(x.shape)} float32 {mode}: rel L2 vs "
              f"autograd of plain, dx / da / db / dW "
              f"{[f'{r:.3e}' for r in rel]} (limit {K9B_REL_L2})")
        if not max(rel) <= K9B_REL_L2:
            raise AssertionError("K9's autograd Function disagrees")
        rels += rel
        rel16 = _k9_bf16_backward(mode)
        print(f"[K9 bwd] {K9_SMALL[:4]} bf16 {mode}: rel L2 vs float64 "
              f"autograd of plain, dx / da / db / dW "
              f"{[f'{r:.3e}' for r in rel16]} (limit {K9B_BF16_REL_L2})")
        if not max(rel16) <= K9B_BF16_REL_L2:
            raise AssertionError("K9's bf16 backward disagrees")
    res = dict(out[True])
    res.update(max_rel_l2=max(rels), path=path, no_affine_ms=out[False]["ms"],
               no_affine_bound_ms=out[False]["bound_ms"],
               no_affine_conv_ms=out[False]["conv_ms"])
    return res


def _unfused_block(self, x, z):
    """``ResBlockUp.forward`` before K9: norm1, its leaky ReLU, the pad and
    cuDNN's conv2, each rounding to the compute dtype."""
    shortcut = x if self.shortcut is None else self.shortcut(x)
    h = gan_models.leaky_relu(self.norm1(self.conv1(self.pad_fn(x, 1)), z))
    h = gan_models.leaky_relu(self.norm2(self.conv2(self.pad_fn(h, 1)), z))
    return h + shortcut


def phase_gen_bf16(gpu: str) -> None:
    """The bf16 generator (CLI configuration, train mode, bs K9_GEN_BS)
    against the float32 one with the same weights: the K9 route's error
    at most K9_GEN_RATIO times the unfused chain's."""
    g32 = gan_models.Generator(_gan_config("float32"))
    init = torch.Generator().manual_seed(34)
    gan_models.gan_init_(g32, init)
    with torch.no_grad():  # a non-zero mesh map, so blk3_mesh shows
        g32.conv_mesh.weight.normal_(0.0, 0.02, generator=init)
    state = {k: v.to(DEVICE) for k, v in g32.state_dict().items()}
    g32 = g32.to(DEVICE)
    g16 = gan_models.Generator(_gan_config("bfloat16")).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(35)
    z = torch.randn((K9_GEN_BS, 64), device=DEVICE, generator=gen)
    c = torch.randint(0, 200, (K9_GEN_BS, 1), device=DEVICE, generator=gen)

    def run(g):
        g.load_state_dict(state)
        g.train()
        with torch.no_grad():
            return [t.float() for t in g(z, c)]

    ref = run(g32)
    n0 = fused_affine_conv3x3_kernel.launches
    k9 = run(g16)
    launched = fused_affine_conv3x3_kernel.launches - n0
    with mock.patch.object(gan_models.ResBlockUp, "forward", _unfused_block):
        old = run(g16)
    torch.cuda.synchronize()
    for name, r, got, unfused in zip(("texture", "mesh map"), ref, k9, old):
        e_k9, e_old = _rel_l2(got, r), _rel_l2(unfused, r)
        print(f"[gen-bf16] {name}, bs {K9_GEN_BS}: rel L2 to float32, K9 "
              f"route {e_k9:.4e}, unfused chain {e_old:.4e} (ratio "
              f"{e_k9 / e_old:.3f}, limit {K9_GEN_RATIO}); K9 launches "
              f"{launched} [{gpu}]")
        if not e_k9 <= K9_GEN_RATIO * e_old:
            raise AssertionError(f"the K9 route's bf16 error is too large "
                                 f"({name})")
    if launched < 8:
        raise AssertionError(f"K9 launched {launched} times in a pass")
    del g32, g16, state
    torch.cuda.empty_cache()


class _PlainHead(torch.autograd.Function):
    """The head through its plain pieces: the plain forward, dx by the
    transpose conv K8's op uses, dW by the float64 plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad_mode):
        w = weight.detach().to(x.dtype).float()
        y = head_conv_tanh_torch(x, w, bias.detach(), pad_mode)
        ctx.save_for_backward(x, w, y)
        ctx.pad_mode = pad_mode
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        g = (dy.float() * (1.0 - y.float() ** 2)).contiguous()
        return (head_conv_dx(g, w, x.dtype, ctx.pad_mode),
                head_conv_dw_torch(x, g, ctx.pad_mode), g.sum(dim=(0, 2, 3)),
                None)


def _plain_head(x, weight, bias, pad_mode="replicate"):
    return _PlainHead.apply(x, weight, bias, pad_mode)


def _gan_config(dtype: str) -> GANConfig:
    """The CLI's CUB configuration for a 512² cache."""
    return GANConfig(texture_resolution=GAN_RES, num_discriminators=3,
                     conditional_class=True, compute_dtype=dtype)


def _gan_batch(n: int, seed: int) -> dict:
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return dict(
        texture=torch.rand((n, GAN_RES, GAN_RES, 3), device=DEVICE,
                           generator=gen) * 2 - 1,
        alpha=(torch.rand((n, GAN_RES, GAN_RES, 1), device=DEVICE,
                          generator=gen) > 0.4).float(),
        mesh=torch.randn((n, 32, 32, 3), device=DEVICE, generator=gen) * 0.02,
        c=torch.randint(0, 200, (n, 1), device=DEVICE, generator=gen))


class _Take(torch.autograd.Function):
    """``value`` forward; the gradient goes to ``like`` unchanged."""

    @staticmethod
    def forward(ctx, like, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def phase_gan_group(gpu: str, template) -> None:
    """One 1G + 2D group at bs GROUP_BS in float32 through K8 and through
    the plain head, from the same state, optimizer updates left out: the
    losses, the gradients, and the head's output, upstream and own
    gradients in the G step."""
    trainer = GANTrainer(GANTrainConfig(model=_gan_config("float32"),
                                        batch_size=GROUP_BS),
                         template=template, device=DEVICE)
    for opt in (trainer.opt_g, trainer.opt_d):
        opt.step = lambda *a, **k: None  # gradients only
    nets = (trainer.generator, trainer.discriminator, trainer.g_ema)
    state = [{k: v.clone() for k, v in m.state_dict().items()} for m in nets]
    nb = trainer.put_batch(_gan_batch(GROUP_BS, 23))
    z = trainer.sample_z(GROUP_BS)
    head = {}  # the G step's head: output, its upstream, dx

    def keep_head(module, args, out):
        """In the G step keep the head's output and gradients; once the
        kernel run's output is kept, hand it to the rest of the step."""
        if not out.requires_grad:
            return None
        args[0].register_hook(lambda g: head.__setitem__("dx", g.clone()))
        head["y"] = out.detach().clone()
        if "y_kernel" in head:
            out = _Take.apply(out, head["y_kernel"])
        out.retain_grad()
        head["out"] = out
        return out

    trainer.generator.conv_final.register_forward_hook(keep_head)

    def group():
        for m, sd in zip(nets, state):
            m.load_state_dict(sd)
        steps = []
        for i, step in enumerate((trainer.g_step, trainer.d_step,
                                  trainer.d_step)):
            losses = step(nb, z)
            net = nets[0] if i == 0 else nets[1]
            steps.append(({k: float(v) for k, v in losses.items()},
                          {n: p.grad.clone()
                           for n, p in net.named_parameters()}))
        grads = steps[0][1]
        return steps, head["y"], {
            "dy": head.pop("out").grad.clone(), "dW":
            grads["conv_final.weight"], "db": grads["conv_final.bias"],
            "dx": head.pop("dx")}

    def rl2(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
        return (num / sum(float((v ** 2).sum()) for v in b.values())) ** 0.5

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the other convs agree
    try:
        counts0 = _counts()
        got = group()
        launched = {k: v - counts0[k] for k, v in _counts().items()}
        head["y_kernel"] = got[1]
        with mock.patch.object(gan_models, "head_conv_tanh", _plain_head), \
                mock.patch.object(gan_models, "fused_affine_conv3x3",
                                  fused_affine_conv3x3_torch):
            ref = group()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    tex_err = float((got[1] - ref[1]).abs().max())
    for i, ((gl, gg), (rl, rg)) in enumerate(zip(got[0], ref[0])):
        prl = rl2(gg, rg)
        print(f"[gan-group] step {i} ({'G' if i == 0 else 'D'}), bs "
              f"{GROUP_BS}, float32: losses {gl} vs plain {rl}; parameter "
              f"gradient rel L2 {prl:.3e} (limit {GROUP_PARAM_RL2})")
        if not all(math.isclose(gl[k], rl[k], rel_tol=GROUP_RTOL)
                   for k in rl):
            raise AssertionError("the group's losses disagree")
        if not prl <= GROUP_PARAM_RL2:
            raise AssertionError("the group's gradients disagree")
    head_rl = {k: _rel_l2(got[2][k], ref[2][k]) for k in ref[2]}
    print(f"[gan-group] head output max |K8 - plain| {tex_err:.3e} (limit "
          f"{K8_ATOL[torch.float32]}); G step, K8 vs plain head, rel L2 "
          f"(limit {GROUP_HEAD_RL2}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in head_rl.items())
          + f"; launches {launched}")
    if not (tex_err <= K8_ATOL[torch.float32]
            and max(head_rl.values()) <= GROUP_HEAD_RL2):
        raise AssertionError("the head's output or gradients disagree")
    if launched["k8"] < 3 or launched["k8b"] < 1 or launched["k9"] < 24:
        raise AssertionError(f"K8 or K9 missing in the group: {launched}")
    del trainer, state
    torch.cuda.empty_cache()


def _cub_labels(tmp: str) -> None:
    """CUB's image and class lists for the cache's photos (the fabricated
    photos carry no labels: 200 classes round robin)."""
    with np.load(os.path.join(tmp, "cache", "cub", "poses_metadata.npz"),
                 allow_pickle=True) as f:
        paths = f["data"].item()["path"]
    cub = os.path.join(tmp, "datasets", "cub", "CUB_200_2011")
    os.makedirs(cub, exist_ok=True)
    with open(os.path.join(cub, "images.txt"), "w") as fh:
        fh.writelines(f"{i + 1} {p}\n" for i, p in enumerate(paths))
    with open(os.path.join(cub, "image_class_labels.txt"), "w") as fh:
        fh.writelines(f"{i + 1} {i % 200 + 1}\n" for i in range(len(paths)))


def phase_gan_cli(gpu: str, tmp: str) -> dict:
    """The GAN CLI on phase 17's cache: GAN_EPOCHS epochs, one more
    resumed, --evaluate, --save_results; the launches of the training
    runs."""
    _cub_labels(tmp)
    name = "chip_smoke_gan"
    flags = ["--name", name, "--dataset", "cub", "--device", DEVICE,
             "--texture_resolution", str(PGT_RES), "--batch_size",
             str(GAN_B), "--conditional_class",
             "--save_freq", "1", "--checkpoint_freq", "1", "--evaluate_freq",
             "1"]
    cwd = os.getcwd()
    os.chdir(tmp)
    walls, launches = [], []
    buf = io.StringIO()
    try:
        for argv in ([*flags, "--epochs", str(GAN_EPOCHS)],
                     [*flags, "--epochs", str(GAN_EPOCHS + 1),
                      "--continue_train"],
                     [*flags, "--evaluate"], [*flags, "--save_results"]):
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = gan_cli.main(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches.append(_counts())
            if rc != 0:
                raise AssertionError(f"the GAN CLI returned {rc}: {argv}")
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    for line in out.splitlines():
        if line.startswith(("epoch", "fid", "exported")):
            print(f"[gan-cli] cli: {line}")
    train = {k: launches[0][k] + launches[1][k] for k in launches[0]}
    workdir = os.path.join(tmp, "gan_weights", name)
    with open(os.path.join(workdir, "metrics_gan.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    values = [v for r in records for k, v in r.items()
              if k not in ("step", "time")]
    fids = {line.split(": ")[0]: float(line.split(": ")[1])
            for line in out.splitlines() if line.startswith("fid")}
    iters = (PGT_IMAGES // GAN_B) * (GAN_EPOCHS + 1)
    g_steps = -(-iters // 3)
    tree = torch.load(os.path.join(workdir, "checkpoints",
                                   f"checkpoint_{iters}.pt"),
                      map_location="cpu", weights_only=True)
    res = os.path.join(tmp, "results", name)
    files = sorted(os.listdir(res))
    grid = os.path.join(tmp, "results", f"{name}.png")
    print(f"[gan-cli] wall: {walls[0]:.2f} s ({GAN_EPOCHS} epochs of "
          f"{PGT_IMAGES // GAN_B} iterations, FID and grids every epoch), "
          f"{walls[1]:.2f} s (resumed epoch), {walls[2]:.2f} s (--evaluate), "
          f"{walls[3]:.2f} s (--save_results) [{gpu}]")
    print(f"[gan-cli] launches: training runs {train}; --evaluate "
          f"{launches[2]}; --save_results {launches[3]}")
    print(f"[gan-cli] {len(records)} metric records, losses "
          f"{[(r['step'], round(r['g_loss'], 4)) for r in records if 'g_loss' in r]}"
          f" / {[(r['step'], round(r['d_fake'] + r['d_real'], 4)) for r in records if 'd_fake' in r]}"
          f"; --evaluate FIDs {fids}; {len(files)} result files + grid "
          f"{os.path.exists(grid)}")
    if not (values and all(math.isfinite(v) for v in values)):
        raise AssertionError(f"non-finite or missing losses: {records}")
    if len(fids) != 6 or not all(math.isfinite(v) for v in fids.values()):
        raise AssertionError(f"--evaluate FIDs: {fids}")
    if tree["total_it"] != iters or not tree["opt_g"]["state"]:
        raise AssertionError(f"checkpoint total_it {tree['total_it']}, "
                             f"expected {iters}")
    want = sorted(f"mesh_{i}.{e}" for i in range(GAN_B)
                  for e in ("obj", "mtl", "png"))
    if files != want or not os.path.exists(grid):
        raise AssertionError(f"--save_results wrote {files}")
    if (train["k8"] < iters or train["k8b"] < g_steps
            or train["k9"] < 8 * iters):
        raise AssertionError(f"K8 launched {train['k8']} / {train['k8b']} "
                             f"and K9 {train['k9']} times in {iters} "
                             f"iterations")
    if min(train[k] for k in ("k4", "k5")) < 1 or min(
            launches[2][k] for k in ("k4", "k5", "k8", "k9")) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return train


def phase_gan_learn(gpu: str, tmp: str, template) -> float:
    """LEARN_STEPS D steps on one fixed cache batch against a frozen G, then
    LEARN_STEPS G steps against the frozen critics, at the full
    configuration; then 1G + 2D groups/s with the batch on the card."""
    ds = CubGANDataset(os.path.join(tmp, "cache", "cub"),
                       texture_resolution=PGT_RES, conditional_class=True)
    batch = next(gan_batch_iterator(ds, GAN_B, seed=0, num_workers=1))
    trainer = GANTrainer(GANTrainConfig(model=_gan_config("bfloat16"),
                                        batch_size=GAN_B),
                         template=template, device=DEVICE)
    nb = trainer.put_batch(batch)
    z = trainer.sample_z(GAN_B)
    d = [trainer.d_step(nb, z) for _ in range(LEARN_STEPS)]
    d_vals = [float(x["d_fake"] + x["d_real"]) for x in d]
    g_vals = [float(trainer.g_step(nb, z)["g_loss"])
              for _ in range(LEARN_STEPS)]
    d_ratio = np.mean(d_vals[-5:]) / np.mean(d_vals[:5])
    g_first, g_last = np.mean(g_vals[:5]), np.mean(g_vals[-5:])
    g_need = 0.05 * max(1.0, abs(g_first))
    print(f"[gan-learn] d_fake + d_real {d_vals[0]:.4f} -> {d_vals[-1]:.4f} "
          f"over {LEARN_STEPS} D steps on one batch; mean of the last 5 / "
          f"first 5 {d_ratio:.4f} (limit 0.95)")
    print(f"[gan-learn] g_loss {g_vals[0]:.4f} -> {g_vals[-1]:.4f} over "
          f"{LEARN_STEPS} G steps; mean of the first 5 - last 5 "
          f"{g_first - g_last:.4f} (at least {g_need:.4f})")
    if not (all(math.isfinite(v) for v in d_vals + g_vals)
            and d_ratio < 0.95 and g_first - g_last >= g_need):
        raise AssertionError(f"the GAN did not learn: {d_vals} {g_vals}")
    for _ in range(3):  # one warm 1G + 2D group
        trainer.train_step(nb)
    torch.cuda.synchronize()
    groups = 5
    t0 = time.perf_counter()
    for _ in range(3 * groups):
        losses = trainer.train_step(nb)
    float(next(iter(losses.values())))
    rate = groups / (time.perf_counter() - t0)
    print(f"[gan-rate] {rate:.3f} 1G + 2D groups/s ({1e3 / rate:.1f} ms a "
          f"group, {rate * GAN_B:.1f} images/s per step kind, bs {GAN_B}, "
          f"{GAN_RES}², bf16, 3 critics, host clock, batch on the card) "
          f"[{gpu}]")
    del trainer
    torch.cuda.empty_cache()
    return rate


def _plans_taken(run):
    """Run ``run()``; return its result and the (S, K) of every projection
    plan taken (each K1 / K2 launch takes one)."""
    from im23d_tpu_torch.ops import projection

    with mock.patch.object(projection, "projection_plan",
                           wraps=projection.projection_plan) as spy:
        out = run()
    return out, sorted({c.args[:2] for c in spy.call_args_list})


def _quiet_cli(main, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(*args, **kw)
    torch.cuda.synchronize()
    return rc, buf.getvalue().strip().splitlines()


def phase_real_train(gpu: str, workdir: str) -> tuple:
    """The chairs training CLI without --synthetic on the in-memory render
    set, with --profile_dir; then the planes config on its own set.
    Returns the chairs run's launches and the (train, valid) pair."""
    cfg = ShapeNetConfig.chairs()
    t0 = time.perf_counter()
    pair = tuple(ShapeNetRenderSet(n, cfg.image_size, V, GT_POINTS, seed=s)
                 for s, n in enumerate((RD_TRAIN, RD_VALID)))
    render_s = time.perf_counter() - t0
    prof = os.path.join(workdir, "profile")
    _zero_counts()
    t0 = time.perf_counter()
    (rc, out), plans = _plans_taken(lambda: _quiet_cli(
        train_cli.main, ["--steps", str(TRAIN_STEPS), "--workdir", workdir,
                         "--profile_dir", prof, "--device", DEVICE],
        datasets=pair))
    secs = time.perf_counter() - t0
    launches = _counts()
    traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    print(f"[real-train] {RD_TRAIN} + {RD_VALID} models of {V} views at "
          f"{cfg.image_size}² rendered in {render_s:.2f} s; CLI rc {rc} in "
          f"{secs:.2f} s ({TRAIN_STEPS} steps, DataBunch's prefetch thread, "
          f"trace included); launches {launches}; plans (S, K) {plans}; "
          f"trace {traces}; cli: {out[-1] if out else ''} [{gpu}]")
    if rc != 0:
        raise AssertionError(f"the training CLI returned {rc}")
    losses = ast.literal_eval(out[-1])
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite training losses: {losses}")
    if min(launches["k1"], launches["k2"]) < TRAIN_STEPS or plans != [
            (S, 21)]:
        raise AssertionError(f"K1 / K2 launches {launches}, plans {plans}")
    if len(traces) != 1 or not traces[0].endswith(".json"):
        raise AssertionError(f"--profile_dir wrote {traces}")

    planes = ShapeNetConfig.planes()
    data = ShapeNetRenderSet(PLANES_MODELS, planes.image_size, V, GT_POINTS,
                             seed=2)
    _zero_counts()
    t0 = time.perf_counter()
    (rc, out), plans = _plans_taken(lambda: _quiet_cli(
        train_cli.main, ["--category", "planes", "--steps",
                         str(PLANES_STEPS), "--workdir",
                         os.path.join(workdir, "planes"), "--device",
                         DEVICE], datasets=(data, data)))
    secs = time.perf_counter() - t0
    p_launches = _counts()
    print(f"[real-train] planes: CLI rc {rc} in {secs:.2f} s ({PLANES_STEPS}"
          f" steps, bs {planes.batch_size}, {planes.image_size}², N "
          f"{planes.num_points}, {planes.voxel_size}³); launches "
          f"{p_launches}; plans (S, K) {plans}; cli: "
          f"{out[-1] if out else ''} [{gpu}]")
    if rc != 0 or not all(math.isfinite(v) for v in
                          ast.literal_eval(out[-1]).values()):
        raise AssertionError(f"the planes run failed: rc {rc}, {out[-1:]}")
    if (min(p_launches["k1"], p_launches["k2"]) < PLANES_STEPS
            or plans != [(planes.voxel_size, 21)]):
        raise AssertionError(f"planes: K1 / K2 launches {p_launches}, "
                             f"plans {plans}")
    return launches, pair


def phase_real_eval(gpu: str, workdir: str, pair) -> dict:
    """The eval CLI on the render set's valid split with GT_POINTS-point
    ground truth; each GT batch's Chamfer and IoU against the plain pair
    and splat on the clouds the CLI scored."""
    seen = {"chamfer": [], "iou": []}

    def recorded(name, fn):
        def call(a, b, *args, **kw):
            out = fn(a, b, *args, **kw)
            seen[name].append((a.detach().clone(), b.detach().clone(),
                               (out[0] if name == "chamfer" else out)
                               .detach().clone()))
            return out
        return call

    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "eval")
        _zero_counts()
        t0 = time.perf_counter()
        with mock.patch.object(cli, "chamfer_distance",
                               recorded("chamfer", cli.chamfer_distance)), \
                mock.patch.object(cli, "iou_3d",
                                  recorded("iou", cli.iou_3d)):
            rc, out = _quiet_cli(
                cli.main, ["--workdir", workdir, "--gt_points",
                           str(GT_POINTS), "--out_dir", out_dir, "--device",
                           DEVICE], datasets=pair)
        secs = time.perf_counter() - t0
        launches = _counts()
        with open(os.path.join(out_dir, "eval_metrics.json")) as fh:
            metrics = json.load(fh)
    n, batches = metrics.get("n_scored", 0), len(seen["chamfer"])
    print(f"[real-eval] CLI rc {rc} in {secs:.2f} s; {n} models scored in "
          f"{batches} GT batches; launches {launches}; chamfer_l2 "
          f"{metrics.get('chamfer_l2')}, iou_3d {metrics.get('iou_3d')} "
          f"[{gpu}]")
    if rc != 0 or n != RD_VALID or metrics["gt_points"] != GT_POINTS:
        raise AssertionError(f"the eval CLI returned {rc}: {metrics}")
    if (launches["k3"], launches["k3r"]) != (batches, 0) or batches != -(
            -n // B) or launches["k6"] < 1:
        raise AssertionError(f"K3 / K6 launches {launches} for {batches} "
                             f"GT batches")
    e_ch = e_iou = 0.0
    totals, ious = [], []
    with torch.no_grad():
        for (pred, gt, got), (pred_i, gt_i, got_i) in zip(seen["chamfer"],
                                                         seen["iou"]):
            if not (torch.equal(pred, pred_i) and torch.equal(gt, gt_i)):
                raise AssertionError("Chamfer and IoU scored other clouds")
            d_ab, d_ba = nn_dist2_pair_torch(pred, gt)
            ref = d_ab.mean(-1) + d_ba.mean(-1)
            va, vb = (trilinear_splat_torch(x, IOU_S) > 0.1
                      for x in (pred, gt))
            ref_i = ((va & vb).float().sum(dim=(1, 2, 3))
                     / (va | vb).float().sum(dim=(1, 2, 3)).clamp(min=1.0))
            e_ch = max(e_ch, float((got - ref).abs().max()))
            e_iou = max(e_iou, float((got_i - ref_i).abs().max()))
            if not torch.allclose(got, ref, rtol=K3_RTOL, atol=K3_ATOL):
                raise AssertionError(f"Chamfer disagrees with the plain "
                                     f"pair: {e_ch}")
            totals.append(ref)
            ious.append(ref_i)
    ref_ch = float(torch.cat(totals)[:n].mean())
    ref_iou = float(torch.cat(ious)[:n].mean())
    print(f"[real-eval] per model max |K3 path - plain| {e_ch:.3e} (rtol "
          f"{K3_RTOL}, atol {K3_ATOL}), 3D IoU {e_iou:.3e} (atol {IOU_ATOL}); "
          f"CLI means {metrics['chamfer_l2']:.6f} / {metrics['iou_3d']:.6f} "
          f"vs plain {ref_ch:.6f} / {ref_iou:.6f}")
    if e_iou > IOU_ATOL or abs(metrics["iou_3d"] - ref_iou) > IOU_ATOL or (
            not math.isclose(metrics["chamfer_l2"], ref_ch, rel_tol=K3_RTOL,
                             abs_tol=K3_ATOL)):
        raise AssertionError("the real-data eval disagrees with the plain "
                             "path")
    return launches


def _bounded(fn, seconds: float):
    """``fn()`` on a thread, waited for at most ``seconds``; past that the
    decode processes are terminated and the phase fails."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised on the caller's thread
            box["err"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        for pool in list(cmr._PROC_POOLS.values()):
            for proc in pool._processes.values():
                proc.terminate()
        raise AssertionError(f"not done within {seconds} s")
    if "err" in box:
        raise box["err"]
    return box["out"]


def phase_data_processes(gpu: str, template, tmp: str) -> dict:
    """One epoch of batch_iterator with 2 decode processes against the
    serial path, then the recon CLI with --data_processes 2 for one epoch;
    CUDA is initialised before either starts a process."""
    data = _fabricated_batch(template, RECON_IMAGES, 0)
    keys = ("image", "scale", "translation", "rotation", "idx")

    def epoch(**kw):
        return list(batch_iterator(data, RB, seed=1, keys=keys, **kw))

    serial = epoch(num_workers=1)
    t0 = time.perf_counter()
    try:
        procs = _bounded(lambda: epoch(num_workers=4, process_workers=2),
                         WAIT_S)
    except BaseException:
        cmr.close_process_pools(data)
        raise
    secs = time.perf_counter() - t0
    same = len(procs) == len(serial) and all(
        np.array_equal(a[k], b[k]) for a, b in zip(procs, serial) for k in a)
    print(f"[data-procs] {len(procs)} batches of {RB} from 2 spawned decode "
          f"processes in {secs:.2f} s (start-up included), bit-equal to the "
          f"serial path: {same}")
    if not same:
        cmr.close_process_pools(data)
        raise AssertionError("the decode processes' batches differ")
    # the CLI takes over this dataset's pool and ends it
    flags = ["--name", "chip_smoke_procs", "--dataset", "cub", "--device",
             DEVICE, "--image_resolution", str(RES), "--texture_resolution",
             str(TEX), "--batch_size", str(RB), "--epochs", "1",
             "--data_processes", "2"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        rc, out = _bounded(lambda: _quiet_cli(recon_cli.main, flags,
                                              datasets=(data, data)), WAIT_S)
        secs = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.chdir(cwd)
    print(f"[data-procs] recon CLI --data_processes 2: rc {rc}, one epoch "
          f"of {RECON_IMAGES // RB} steps in {secs:.2f} s (the running "
          f"processes reused); launches {launches}; pools left "
          f"{len(cmr._PROC_POOLS)} [{gpu}]")
    if rc != 0 or cmr._PROC_POOLS:
        raise AssertionError(f"the recon CLI returned {rc}")
    if min(launches[k] for k in ("k4", "k4b", "k5", "k5b")) < 1:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    return launches


def _groups_per_s(trainer, batches, epochs: int) -> float:
    """1G + 2D groups/s over ``epochs`` epochs of ``batches(epoch)`` (one
    group an epoch), host clock, the last loss fetched."""
    t0 = time.perf_counter()
    for e in range(epochs):
        for batch in batches(e):
            losses = trainer.train_step(batch)
    float(next(iter(losses.values())))
    return epochs * (PGT_IMAGES // GAN_B) / 3 / (time.perf_counter() - t0)


def phase_device_cache(gpu: str, tmp: str, template, resident: float
                       ) -> dict:
    """DeviceGANCache on phase 17's cache: the staged bytes, batches against
    the host iterator's for two epochs, the GAN CLI with --device_cache for
    one epoch, then groups/s fed from the cache and from the host."""
    cache_dir = os.path.join(tmp, "cache", "cub")
    ds = CubGANDataset(cache_dir, texture_resolution=PGT_RES,
                       conditional_class=True)
    t0 = time.perf_counter()
    dev = DeviceGANCache(ds, GAN_B, DEVICE)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    first = ds.load_pseudo_ground_truth(0, with_image=False)
    want = len(ds) * sum(a.nbytes for a in first.values())
    same = True
    for epoch in (0, 1):
        got = list(dev.epoch_batches(epoch))
        host = list(gan_batch_iterator(ds, GAN_B, seed=epoch))
        same &= len(got) == len(host) == PGT_IMAGES // GAN_B
        same &= ds._epoch == epoch
        for g, h in zip(got, host):
            same &= g.keys() == h.keys() and all(
                g[k].device.type == DEVICE
                and torch.equal(g[k].cpu(), torch.as_tensor(h[k])) for k in g)
    print(f"[dev-cache] staged {len(ds)} items, {dev.nbytes()} bytes "
          f"(expected {want}: maps "
          f"{[(a.shape, str(a.dtype)) for a in first.values()]}"
          f"; fits_in_hbm {DeviceGANCache.fits_in_hbm(ds)}) "
          f"in {stage_s:.2f} s; epochs 0 and 1 bit-equal to the host "
          f"iterator on the card: {same}")
    if dev.nbytes() != want or not same:
        raise AssertionError("the device cache's batches or size differ")

    name = "chip_smoke_cache"
    flags = ["--name", name, "--dataset", "cub", "--device", DEVICE,
             "--texture_resolution", str(PGT_RES), "--batch_size",
             str(GAN_B), "--conditional_class", "--device_cache", "--epochs",
             "1", "--evaluate_freq", "100", "--save_freq", "100",
             "--checkpoint_freq", "100"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        rc, out = _quiet_cli(gan_cli.main, flags)
        secs = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.chdir(cwd)
    iters = PGT_IMAGES // GAN_B
    staged = [line for line in out if line.startswith("device_cache")]
    print(f"[dev-cache] GAN CLI --device_cache: rc {rc}, one epoch of "
          f"{iters} iterations in {secs:.2f} s (models and staging "
          f"included); launches {launches}; {staged} [{gpu}]")
    if rc != 0 or not staged:
        raise AssertionError(f"the GAN CLI returned {rc}")
    if (launches["k8"] < iters or launches["k8b"] < 1
            or launches["k9"] < 8 * iters):
        raise AssertionError(f"K8 / K9 launches {launches}")

    trainer = GANTrainer(GANTrainConfig(model=_gan_config("bfloat16"),
                                        batch_size=GAN_B),
                         template=template, device=DEVICE)
    feeds = {"cache": dev.epoch_batches,
             "host": lambda e: gan_batch_iterator(ds, GAN_B, seed=e)}
    _groups_per_s(trainer, feeds["cache"], 1)  # warm
    rates = {k: [] for k in feeds}
    for key in ("host", "cache", "cache", "host"):
        rates[key].append(_groups_per_s(trainer, feeds[key], CACHE_EPOCHS))
    print(f"[dev-cache] 1G + 2D groups/s over {CACHE_EPOCHS} epochs each, "
          f"in turns host / cache / cache / host: fed from the device cache "
          f"{rates['cache'][0]:.3f}, {rates['cache'][1]:.3f}; from the host "
          f"iterator (npz reads, pageable copies) {rates['host'][0]:.3f}, "
          f"{rates['host'][1]:.3f}; phase 23, one batch resident on the "
          f"card: {resident:.3f} (bs {GAN_B}, {GAN_RES}², bf16, 3 critics, "
          f"host clock) [{gpu}]")
    del trainer, dev
    torch.cuda.empty_cache()
    return launches


def _caption_cache(cache_dir: str) -> None:
    """A fabricated ``captions_tokens.npz`` for the cache's items, as
    ``data/captions.py`` writes it: CAPTIONS captions an item of 4 to
    TEXT_LEN words drawn from a TEXT_VOCAB-word vocabulary, 0-padded."""
    with np.load(os.path.join(cache_dir, "poses_metadata.npz"),
                 allow_pickle=True) as f:
        n = len(f["data"].item()["path"])
    rng = np.random.RandomState(34)
    lengths = rng.randint(4, TEXT_LEN + 1, (n, CAPTIONS)).astype(np.int32)
    tokens = rng.randint(1, TEXT_VOCAB, (n, CAPTIONS, TEXT_LEN))
    tokens = np.where(np.arange(TEXT_LEN) < lengths[..., None], tokens,
                      0).astype(np.int32)
    vocab = np.array(["<pad>"] + [f"w{i}" for i in range(1, TEXT_VOCAB)])
    np.savez(os.path.join(cache_dir, "captions_tokens.npz"), tokens=tokens,
             lengths=lengths, n_words=TEXT_VOCAB, vocab=vocab)


def _attngan_encoder(path: str) -> dict:
    """A seeded AttnGAN ``RNN_Encoder`` state dict (TEXT_VOCAB words,
    TEXT_EMB-wide embedding, 128 hidden units a direction), saved."""
    gen = torch.Generator().manual_seed(35)
    H = 128
    sd = {"encoder.weight": torch.randn((TEXT_VOCAB, TEXT_EMB),
                                        generator=gen) * 0.1}
    for sfx in ("", "_reverse"):
        for name, shape in (("weight_ih", (4 * H, TEXT_EMB)),
                            ("weight_hh", (4 * H, H)), ("bias_ih", (4 * H,)),
                            ("bias_hh", (4 * H,))):
            sd[f"rnn.{name}_l0{sfx}"] = torch.randn(shape,
                                                    generator=gen) * 0.05
    torch.save(sd, path)
    return sd


def _text_config() -> GANConfig:
    """The CLI's CUB configuration for a 512² cache with
    ``--conditional_text`` (no class conditioning: the critics' text term
    runs)."""
    return GANConfig(texture_resolution=GAN_RES, num_discriminators=3,
                     conditional_text=True, compute_dtype="bfloat16")


def phase_text_gan(gpu: str, tmp: str, template, resident: float):
    """The text-conditional GAN: a resident-batch 1G + 2D group and its
    rate, then the GAN CLI for one epoch with the pretrained encoder.
    Returns the trainer (for phase 35) and the CLI's launches."""
    cache_dir = os.path.join(tmp, "cache", "cub")
    _caption_cache(cache_dir)
    ds = CubGANDataset(cache_dir, texture_resolution=PGT_RES,
                       conditional_text=True)
    batch = next(gan_batch_iterator(ds, GAN_B, seed=0, num_workers=1))
    trainer = GANTrainer(GANTrainConfig(
        model=_text_config(), batch_size=GAN_B, text_vocab_size=ds.n_words,
        text_max_length=TEXT_LEN), template=template, device=DEVICE)
    nb = trainer.put_batch(batch)
    _zero_counts()
    group = [trainer.train_step(nb) for _ in range(3)]
    losses = {k: float(v) for step in group for k, v in step.items()}
    torch.cuda.synchronize()
    launched = _counts()
    t0 = time.perf_counter()
    for _ in range(3 * TEXT_GROUPS):
        last = trainer.train_step(nb)
    float(next(iter(last.values())))
    rate = TEXT_GROUPS / (time.perf_counter() - t0)
    print(f"[text-gan] one 1G + 2D group, bs {GAN_B}, {GAN_RES}², bf16, 3 "
          f"critics, captions (B, {TEXT_LEN}) from a {ds.n_words}-word "
          f"cache: losses {losses}; launches {launched}")
    print(f"[text-gan] {rate:.3f} 1G + 2D groups/s ({1e3 / rate:.1f} ms a "
          f"group, host clock, batch on the card; phase 23's unconditional "
          f"group {resident:.3f}) [{gpu}]")
    if not (batch["caption"].shape == (GAN_B, TEXT_LEN)
            and all(math.isfinite(v) for v in losses.values())):
        raise AssertionError(f"the text group: {losses}")
    if (launched["k8"] != 3 or launched["k8b"] != 1
            or launched["k9"] != 24):
        raise AssertionError(f"K8 / K9 launches in the text group: "
                             f"{launched}")

    pth = os.path.join(tmp, "text_encoder200.pth")
    sd = _attngan_encoder(pth)
    name = "chip_smoke_text"
    flags = ["--name", name, "--dataset", "cub", "--device", DEVICE,
             "--texture_resolution", str(PGT_RES), "--batch_size",
             str(GAN_B), "--conditional_text", "--text_pretrained_encoder",
             pth, "--epochs", "1", "--evaluate_freq", "1", "--save_freq",
             "100", "--checkpoint_freq", "100"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        rc, out = _quiet_cli(gan_cli.main, flags)
        secs = time.perf_counter() - t0
        launches = _counts()
    finally:
        os.chdir(cwd)
    workdir = os.path.join(tmp, "gan_weights", name)
    with open(os.path.join(workdir, "log.txt")) as fh:
        log = fh.read()
    iters = PGT_IMAGES // GAN_B
    tree = torch.load(os.path.join(workdir, "checkpoints",
                                   f"checkpoint_{iters}.pt"),
                      map_location="cpu", weights_only=True)
    loaded = [line for line in out if line.startswith("loaded pretrained")]
    captions = log[log.index("sample captions:"):].splitlines()[:3] \
        if "sample captions:" in log else []
    same_te = tree["te"].keys() == sd.keys() and all(
        torch.equal(tree["te"][k], sd[k]) for k in sd)
    print(f"[text-gan] GAN CLI --conditional_text, one epoch of {iters} "
          f"iterations with FID and grids: rc {rc} in {secs:.2f} s; "
          f"{loaded}; the checkpoint's encoder is the .pth's: {same_te}; "
          f"log {captions}; launches {launches} [{gpu}]")
    if rc != 0 or not loaded or not same_te or not captions:
        raise AssertionError("the text GAN CLI run failed its checks")
    if (launches["k8"] < iters or launches["k8b"] < 1
            or launches["k9"] < 8 * iters
            or min(launches[k] for k in ("k4", "k5")) < 1):
        raise AssertionError(f"a kernel of the text CLI's path never "
                             f"launched: {launches}")
    return trainer, launches


def phase_serve(gpu: str, tmp: str, trainer, template) -> dict:
    """The serving artifacts: phase 34's EMA generator and the recon
    network at ReconConfig(), each exported for CUDA, loaded and held to
    the trainer's own inference; the GAN artifact's K8 / K9 launches."""
    path = os.path.join(tmp, "gan_serving.zip")
    t0 = time.perf_counter()
    export_gan_inference(trainer, GAN_B, path, platforms=("cuda",))
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = load_artifact(path, DEVICE)
    t_load = time.perf_counter() - t0
    z = torch.randn((GAN_B, trainer.mcfg.latent_dim), device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(35))
    want = trainer.generate(z)
    with torch.no_grad():
        served(z)  # the first call
    torch.cuda.synchronize()
    _zero_counts()
    with torch.no_grad():
        got = served(z)
    torch.cuda.synchronize()
    launches = _counts()
    ms = _time_ms(torch.no_grad()(lambda: served(z)), 5)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    limits = [SERVE_TEX_ATOL,
              SERVE_TEX_ATOL * max(1.0, float(want[1].abs().max()))]
    print(f"[serve] GAN artifact ({os.path.getsize(path)} bytes, bs "
          f"{GAN_B}, {GAN_RES}², bf16, text model without captions): "
          f"export {t_export:.2f} s, load {t_load:.2f} s, a call {ms:.2f} "
          f"ms (events over 5); vs trainer.generate max |d| texture "
          f"{errs[0]:.3e}, mesh map {errs[1]:.3e} (limits {limits[0]:.3e}, "
          f"{limits[1]:.3e}); launches in one call {launches} [{gpu}]")
    if not all(torch.isfinite(g).all() for g in got) or any(
            e > lim for e, lim in zip(errs, limits)):
        raise AssertionError("the GAN artifact disagrees with generate()")
    if launches["k8"] != 1 or launches["k9"] != 8:
        raise AssertionError(f"the GAN artifact's launches: {launches}")

    recon = ReconTrainer(ReconConfig(), dataset_size=RECON_IMAGES,
                         template=template, device=DEVICE)
    with torch.no_grad():  # a mesh head that moves the sphere
        w = recon.model.conv_mesh.weight
        w.copy_(torch.randn(w.shape, device=DEVICE,
                            generator=torch.Generator(DEVICE).manual_seed(
                                36)) * 0.01)
    rpath = os.path.join(tmp, "recon_serving.zip")
    t0 = time.perf_counter()
    export_reconstruction_inference(recon, RB, rpath, platforms=("cuda",))
    r_export = time.perf_counter() - t0
    rserved = load_artifact(rpath, DEVICE)
    images = torch.rand((RB, RES, RES, 4), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(37))
    rwant = recon.predict(images)
    with torch.no_grad():
        rgot = rserved(images)
    rerrs = [float((g - w).abs().max()) for g, w in zip(rgot, rwant)]
    rlimits = [SERVE_TEX_ATOL,
               SERVE_TEX_ATOL * max(1.0, float(rwant[1].abs().max()))]
    print(f"[serve] recon artifact ({os.path.getsize(rpath)} bytes, bs {RB}, "
          f"{RES}² RGBA, bf16): export {r_export:.2f} s; vs "
          f"ReconTrainer.predict max |d| texture {rerrs[0]:.3e}, mesh map "
          f"{rerrs[1]:.3e} (limits {rlimits[0]:.3e}, {rlimits[1]:.3e}) "
          f"[{gpu}]")
    if not all(torch.isfinite(g).all() for g in rgot) or any(
            e > lim for e, lim in zip(rerrs, rlimits)):
        raise AssertionError("the recon artifact disagrees with predict()")
    del recon, rserved, served
    torch.cuda.empty_cache()
    return launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multihost_cli(gpu: str, workdir: str) -> dict:
    """36. The chairs training CLI with ``--multihost`` in a one-rank NCCL
    group: the launcher's environment as ``torchrun`` sets it."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    backends = []
    init = dist.init_process_group

    def recording(backend=None, *args, **kw):
        backends.append(backend)
        return init(backend, *args, **kw)

    buf = io.StringIO()
    _zero_counts()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env), \
            mock.patch.object(dist, "init_process_group", recording), \
            contextlib.redirect_stdout(buf):
        rc = train_cli.main(["--multihost", "--synthetic", "--steps",
                             str(MULTIHOST_STEPS), "--workdir", workdir,
                             "--device", DEVICE])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    out = buf.getvalue().strip()
    print(f"[multihost] CLI --multihost rc {rc} in {secs:.2f} s "
          f"({MULTIHOST_STEPS} chairs steps, bs 24, backend {backends}, "
          f"group left: {not dist.is_initialized()}); launches {launches}; "
          f"{out.splitlines()[-1] if out else ''}")
    if rc != 0 or backends != ["nccl"] or dist.is_initialized():
        raise AssertionError("the --multihost CLI did not run in a one-rank "
                             "NCCL group and leave it")
    losses = ast.literal_eval(out.splitlines()[-1])
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite --multihost losses: {losses}")
    if launches["k1"] < 1 or launches["k2"] < 1:
        raise AssertionError(f"K1 or K2 missing under --multihost: "
                             f"{launches}")
    tree = torch.load(os.path.join(workdir,
                                   f"checkpoint_{MULTIHOST_STEPS}.pt"),
                      map_location="cpu", weights_only=True)
    if tree["step"] != MULTIHOST_STEPS:
        raise AssertionError("the --multihost checkpoint lacks its step")
    return dict(launches=launches, wall_s=secs)


@contextlib.contextmanager
def _timed_all_reduce():
    """Seconds spent in ``all_reduce_grads`` within the block, the device
    synchronised around each call."""
    spent = [0.0]
    reduce = pmesh.all_reduce_grads

    def timed(params, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(params, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0

    with mock.patch.object(pmesh, "all_reduce_grads", timed):
        yield spent


def _mr_run(stage, mesh, nets: dict, steps: int = 1) -> dict:
    """``steps`` train steps of a stage, twice: the first time its losses,
    launches and wall, the gradients of ``nets`` (name -> module) at full
    width and their batch-norm running statistics; the second time its
    wall and the share of it in ``all_reduce_grads``."""
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [stage.step() for _ in range(steps)]
    torch.cuda.synchronize()
    out = dict(
        losses=losses, first_s=time.perf_counter() - t0, launches=_counts(),
        grads={n: {k: g.float().cpu()
                   for k, g in stages.grads(m, mesh).items()}
               for n, m in nets.items()},
        stats={f"{n}.{k}": v.detach().float().cpu().clone()
               for n, m in nets.items() for k, v in m.named_buffers()
               if "running_" in k},
        grad_bytes=sum(_nbytes(p.grad) for m in nets.values()
                       for p in m.parameters()))
    with _timed_all_reduce() as spent:
        t0 = time.perf_counter()
        for _ in range(steps):
            stage.step()
        torch.cuda.synchronize()
        out.update(step_s=time.perf_counter() - t0, all_reduce_s=spent[0])
    return out


def _mr_chairs(mesh, device) -> dict:
    cfg = ShapeNetConfig(compute_dtype="float32")
    stage = stages.chairs(cfg, stages.chairs_batch(cfg, seed=7), mesh,
                          device)
    return _mr_run(stage, mesh, dict(model=stage.trainer.model))


def _mr_recon(mesh, device) -> dict:
    cfg = ReconConfig(compute_dtype="float32")
    batch = {k: v.to(device) for k, v in stages.recon_batch(cfg, 17).items()}
    stage = stages.recon(cfg, batch, mesh, device,
                         MeshTemplate(segments=32, rings=16))
    return _mr_run(stage, mesh, dict(model=stage.trainer.model,
                                     dp=stage.trainer.dp_model))


def _mr_gan(mesh, device) -> dict:
    """A 1G + 2D group of the GAN CLI's CUB configuration for a 512²
    cache."""
    cfg = GANTrainConfig(model=GANConfig(
        texture_resolution=512, num_discriminators=3, conditional_class=True,
        compute_dtype="bfloat16"))
    stage = stages.gan(cfg, stages.gan_batch(cfg, seed=29), mesh, device,
                       MeshTemplate(segments=32, rings=16))
    return _mr_run(stage, mesh, dict(g=stage.trainer.generator,
                                     d=stage.trainer.discriminator), steps=3)


def _mr_rank(rank: int, world: int, device) -> dict:
    """Phase 37 on one rank: the chairs stage at dp and at tp (``world``
    wide each), the recon stage and the GAN group at dp.  Only rank 0
    returns its gradients and statistics."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dp_mesh, tp_mesh = pmesh.make_2d_mesh(1), pmesh.make_2d_mesh(world)
    out = {}
    for name, run, mesh in (("chairs_dp", _mr_chairs, dp_mesh),
                            ("chairs_tp", _mr_chairs, tp_mesh),
                            ("recon", _mr_recon, dp_mesh),
                            ("gan", _mr_gan, dp_mesh)):
        res = run(mesh, device)
        if rank:
            del res["grads"], res["stats"]
        out[name] = res
        torch.cuda.empty_cache()
    return out


def _net_rl2(got: dict, ref: dict) -> float:
    """Relative L2 of a network's gradients over all its parameters."""
    num = sum(float(((got[k].double() - v.double()) ** 2).sum())
              for k, v in ref.items())
    return (num / sum(float((v.double() ** 2).sum())
                      for v in ref.values())) ** 0.5


def _mr_check(name: str, kind: str, ranks: list, ref: dict) -> dict:
    """One multi-rank stage against the one-process one; its walls."""
    lim = MR_LIMITS[kind]
    got = ranks[0]
    for r in ranks:
        for gl, rl in zip(r["losses"], ref["losses"]):
            bad = [k for k in rl if not math.isclose(
                gl[k], rl[k], rel_tol=lim["loss_rtol"])]
            if bad:
                raise AssertionError(f"{name}: losses {gl} vs one process "
                                     f"{rl}")
        need = MR_LAUNCHES[kind]
        if any(r["launches"][k] < n for k, n in need.items()):
            raise AssertionError(f"{name}: a kernel of the step launched "
                                 f"too rarely: {r['launches']} (need "
                                 f"{need})")
    rl2 = {n: _net_rl2(got["grads"][n], g) for n, g in ref["grads"].items()}
    stats = max((float((got["stats"][k] - v).abs().max())
                 for k, v in ref["stats"].items()), default=None)
    print(f"[multi-rank] {name}: losses {ref['losses'][-1]} (one process) "
          f"vs {got['losses'][-1]}; gradient rel L2 "
          f"{', '.join(f'{n} {v:.3e}' for n, v in rl2.items())} (limit "
          f"{lim['grad_rl2']})"
          + (f"; running statistics max |diff| {stats:.3e} (limit "
             f"{lim['stats_atol']})" if stats is not None else "")
          + "; launches a rank "
          + str([{k: v for k, v in r["launches"].items() if v}
                 for r in ranks]))
    if max(rl2.values()) > lim["grad_rl2"]:
        raise AssertionError(f"{name}: gradients disagree")
    if stats is not None and stats > lim["stats_atol"]:
        raise AssertionError(f"{name}: batch-norm statistics disagree")
    walls = dict(one_first_s=ref["first_s"], one_step_s=ref["step_s"],
                 rank_first_s=[r["first_s"] for r in ranks],
                 rank_step_s=[r["step_s"] for r in ranks],
                 all_reduce_s=[r["all_reduce_s"] for r in ranks],
                 launches=[r["launches"] for r in ranks])
    print(f"[multi-rank] {name} walls: one process first {ref['first_s']:.3f}"
          f" s, again {ref['step_s']:.3f} s; ranks first "
          f"{walls['rank_first_s']}, again {walls['rank_step_s']}, of which "
          f"all_reduce_grads {walls['all_reduce_s']} s "
          f"({got['grad_bytes'] / 1e6:.1f} MB of gradients a rank) (2 ranks "
          "time-slice one card: not a scaling result)")
    return walls


def phase_multi_rank(gpu: str) -> dict:
    """37. The chairs (dp 2 and dp 1 x tp 2), recon and GAN stages on 2
    gloo ranks on the card against one process on the same global batch."""
    ref = dict(chairs=_mr_chairs(None, DEVICE), recon=_mr_recon(None, DEVICE),
               gan=_mr_gan(None, DEVICE))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(_mr_rank, MR_WORLD, DEVICE)
    secs = time.perf_counter() - t0
    print(f"[multi-rank] {MR_WORLD} ranks (gloo on one card) ran the four "
          f"stages in {secs:.1f} s, spawn and start included")
    out = {}
    for name, kind in (("chairs_dp", "chairs"), ("chairs_tp", "chairs"),
                       ("recon", "recon"), ("gan", "gan")):
        out[name] = _mr_check(name, kind, [r[name] for r in ranks],
                              ref[kind])
    out["launch_s"] = secs
    return out


def phase_dryrun(gpu: str) -> dict:
    """38. ``dryrun_multichip`` on 2 gloo ranks on the card."""
    t0 = time.perf_counter()
    ranks = dryrun_multichip(MR_WORLD, DEVICE)
    secs = time.perf_counter() - t0
    values = [ranks[0]["chairs"], ranks[0]["recon"],
              ranks[0]["chairs_production"], *ranks[0]["gan"].values()]
    print(f"[dryrun] dryrun_multichip({MR_WORLD}) on {DEVICE} in {secs:.1f} "
          f"s: {ranks[0]}")
    if not all(math.isfinite(v) for v in values) or ranks[0] != ranks[1]:
        raise AssertionError(f"dryrun_multichip: {ranks}")
    return dict(wall_s=secs)


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
    k6, k6b = phase_k6(gpu)
    k7, k7b = phase_k7(gpu)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, "train")
        phase_train(gpu, workdir)
        evals = phase_slice(gpu, workdir)
        mesh = phase_mesh(gpu, workdir)
    phase_learn(gpu)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, "real")
        real, pair = phase_real_train(gpu, workdir)
        phase_real_eval(gpu, workdir, pair)
        del pair
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
        phase_data_processes(gpu, template, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_pseudogt(gpu, template, tmp)
        torch.cuda.empty_cache()
        k8 = phase_k8(gpu)
        k8b = phase_k8_dw(gpu)
        k9 = phase_k9(gpu)
        phase_gen_bf16(gpu)
        phase_gan_group(gpu, template)
        gan = phase_gan_cli(gpu, tmp)
        resident = phase_gan_learn(gpu, tmp, template)
        phase_device_cache(gpu, tmp, template, resident)
        text_trainer, _ = phase_text_gan(gpu, tmp, template, resident)
        phase_serve(gpu, tmp, text_trainer, template)
        del text_trainer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase_multihost_cli(gpu, os.path.join(tmp, "multihost"))
    phase_multi_rank(gpu)
    phase_dryrun(gpu)

    kernels = [
        dict(name="K1 projection forward", route="cuda",
             source="im23d_tpu_torch/csrc/projection.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:1080",
             launches=real["k1"], **k1),
        dict(name="K2 projection backward", route="cuda",
             source="im23d_tpu_torch/csrc/projection.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:1124",
             launches=real["k2"], **k2),
        dict(name="K3 Chamfer nearest-neighbour pair", route="cuda",
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
        dict(name="K6 splat forward", route="cuda",
             source="im23d_tpu_torch/csrc/splat.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:59",
             launches=evals["k6"], **k6),
        dict(name="K6 splat backward", route="cuda",
             source="im23d_tpu_torch/csrc/splat.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:93",
             launches=evals["k6b"], **k6b),
        dict(name="K7 splat + Y/X blur forward", route="cuda",
             source="im23d_tpu_torch/csrc/splat.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:224",
             launches=mesh["k7"], **k7),
        dict(name="K7 splat + Y/X blur backward", route="cuda",
             source="im23d_tpu_torch/csrc/splat.cu",
             replaces="im23d_tpu/ops/splat_pallas.py:234",
             launches=mesh["k7b"], **k7b),
        dict(name="K8 head conv forward", route="cuda",
             source="im23d_tpu_torch/csrc/head_conv.cu",
             replaces="im23d_tpu/ops/conv_pallas.py:91",
             launches=gan["k8"], **k8),
        dict(name="K8 head conv dW", route="cuda",
             source="im23d_tpu_torch/csrc/head_conv.cu",
             replaces="im23d_tpu/ops/conv_pallas.py:188",
             launches=gan["k8b"], **k8b),
        dict(name="K9 folded affine conv3x3 forward", route="cuda",
             source="im23d_tpu_torch/csrc/fused_conv.cu",
             replaces="im23d_tpu/ops/conv_pallas.py:375",
             launches=gan["k9"], **k9),
    ]
    print(json.dumps(dict(kernels=kernels)))
    print(_gpu_line())
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
