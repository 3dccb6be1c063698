#!/usr/bin/env python3
"""Where the time of the chairs eval and train steps, of the Pipeline-B
(CUB mesh estimation) eval and train steps and of the CUB GAN's 1G + 2D
group goes on one GPU (PyTorch port).

For each window of the eval path (the whole eval step with its loss fetch,
then its parts: host->device normalize, model forward, keep mask, the eval
loss with K1 on B*V clouds, and the candidate-sweep loss with K1 on B*V*K
clouds) and of the train path (the whole train step with its loss fetch,
then its parts: model forward + backward, the candidate sweep with the
training keep mask, K2 alone on the B*V winners, the AdamW update) it
prints:

  - wall ms per iteration: host clock over ``--iters`` warm iterations,
    without the profiler, synchronised at the end;
  - device busy ms per iteration: the sum of the device time of every
    kernel, copy and memset that ``torch.profiler`` records over
    ``--iters`` more iterations (after a discarded warm-up step of as many,
    and between two spin kernels that are left out: see ``_device_ops``);
  - idle share = 1 - busy / wall, and the device ops per iteration;
  - the ten device ops that take the most time.

Then the peak device memory of one candidate sweep and of one train step.
The model has random weights from the config's seed; the batch is
synthetic.

The recon windows (``--only recon``) are the CUB eval step at
``ReconConfig()`` (bs 50, 256² RGBA, 128² texture, 960 faces) with its
loss fetch, then its parts: the host->device copy of the batch, the
network forward (bf16), posing and rendering (vertex sampler, K4, K5), and
K4 and K5 alone; the batch is 50 fabricated photos.

The recon train windows (``--only recon_train``) are the CUB train step at
``ReconConfig()`` with its loss fetch, then its parts: the host->device
copy of the batch, the network forward + backward (bf16, train-mode batch
norm), posing and rendering forward (vertex sampler, K4 with its winner
cache, K5), K4's backward and K5's backward alone at the step's shapes,
and the two Adam updates.

The GAN windows (``--only gan_train``) are the CUB GAN at the CLI's
full configuration (bs 32, 512² textures, bf16, 3 critics, class
conditioning): one 1G + 2D group with its loss fetch, then a G step and a
D step alone, the generator's train-mode forward, the critics' forward +
backward on the D step's concatenated batch of 2B, K8 forward and K8 dW
alone at the head's shape, K9 alone at blk6's conv2 (32 x 64 x 512 x 256
-> 64 with the folded norm), and the EMA update; the group's K8 and K9
lines are printed even when they fall outside its ten largest; the batch
is random, on the card.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/profile_eval.py [--iters 10]
        [--only eval|train|recon|recon_train|gan_train]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from im23d_tpu_torch.data.cmr import batch_iterator  # noqa: E402
from im23d_tpu_torch.data.fabricate import StructuredReconSet  # noqa: E402
from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes  # noqa: E402
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate  # noqa: E402
from im23d_tpu_torch.losses.effective import (  # noqa: E402
    _candidate_cam,
    unsupervised_loss,
)
from im23d_tpu_torch.models.gan import GANConfig  # noqa: E402
from im23d_tpu_torch.ops.conv import (  # noqa: E402
    fused_affine_conv3x3_kernel,
    head_conv_dw_kernel,
    head_conv_kernel,
)
from im23d_tpu_torch.ops.pointcloud import keep_mask  # noqa: E402
from im23d_tpu_torch.ops.projection import (  # noqa: E402
    _prep_projection,
    _taps_and_scale,
    projection_backward_kernel,
)
from im23d_tpu_torch.ops.sampling import (  # noqa: E402
    grid_sample_bilinear,
    grid_sample_bilinear_backward_kernel,
)
from im23d_tpu_torch.render.rasterizer import (  # noqa: E402
    _launch_forward,
    rasterize,
    rasterize_backward_kernel,
)
from im23d_tpu_torch.train.gan_trainer import (  # noqa: E402
    GANTrainConfig,
    GANTrainer,
)
from im23d_tpu_torch.train.recon_trainer import (  # noqa: E402
    ReconConfig,
    ReconTrainer,
)
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


# device cycles of each spin kernel that pads a window's recorded calls
# (about 10 ms at the H100's clocks)
_PAD_CYCLES = 17_000_000


def _device_ops(fn, iters: int):
    """[(name, total device us, count)] over ``iters`` profiled calls, and
    the least lag in us from a kernel's launch on the host to its start on
    the device.

    Short windows lost kernel records on an H100, whatever launched the
    kernels: a window of 2 K8 launches recorded none and one of 2 K8 dW
    launches one; with the trace warmed up by a discarded step first,
    windows of 10 K8 and 10 K8 dW launches late in a long run recorded 6
    and 8, while a fresh process recorded every launch of 12 such
    windows.  So the profiler
    traces one step of the calls that it discards, then the step it
    records, whose calls sit between two spin kernels of ``_PAD_CYCLES``
    (left out of the sums): a kernel that the trace places a few ms off
    its true time still falls inside the recorded window."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            torch.cuda._sleep(_PAD_CYCLES)
            for _ in range(iters):
                fn()
            torch.cuda._sleep(_PAD_CYCLES)
            torch.cuda.synchronize()
            prof.step()
    events = prof.profiler.kineto_results.events()
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() == DeviceType.CPU
                and "Launch" in e.name()}
    lags = [e.start_ns() - launched[e.correlation_id()] for e in events
            if e.device_type() == DeviceType.CUDA
            and e.correlation_id() in launched]
    # GPU-side user annotations (e.g. "Optimizer.step#AdamW.step") span
    # kernels that are counted on their own: leave them out
    ops = [(e.key, e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and "#" not in e.key and "spin_kernel" not in e.key]
    return ops, min(lags) / 1e3 if lags else float("nan")


def report(title: str, fn, iters: int, show=(), kernel=None) -> float:
    """Print the window's numbers, and the ops whose names contain one of
    ``show`` beyond the ten largest; for a one-kernel window, the launches
    of ``kernel`` (a substring of its name) recorded against the calls
    made, and the least launch-to-start lag.  Returns its device busy ms
    per iter."""
    wall = _wall_ms(fn, iters)
    ops, lag_us = _device_ops(fn, iters)
    busy = sum(us for _, us, _ in ops) / 1e3 / iters
    n_ops = sum(c for _, _, c in ops) / iters
    print(f"== {title}: wall {wall:.3f} ms/iter (no profiler), device busy "
          f"{busy:.3f} ms/iter, idle share {1.0 - busy / wall:.3f}, "
          f"{n_ops:.0f} device ops/iter")
    if kernel is not None:
        seen = sum(c for name, _, c in ops if kernel in name)
        print(f"    recorded {seen} launches of {kernel} in {iters} calls; "
              f"least launch-to-start lag {lag_us:.1f} us")
    ranked = sorted(ops, key=lambda o: -o[1])
    for i, (name, us, count) in enumerate(ranked):
        if i < 10 or any(key in name for key in show):
            print(f"    {us / 1e3 / iters:7.3f} ms  {count / iters:5.1f} "
                  f"calls  #{i + 1}  {name[:100]}")
    return busy


# the projection's kernels, K1 and K2 now and the chain they replaced
# (splat, Y/X blur, Z blur + termination): printed in the chairs windows
# even outside their ten largest
PROJECTION_OPS = ("proj_fwd", "proj_bwd", "splat_kernel", "splat_grad",
                  "blur_yx", "zblur_term", "term_bwd")


def _peak_mib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def profile_train(cfg, iters: int) -> None:
    """The train step's windows; shares are of the whole step's device
    busy time."""
    learner = ShapeNetLearner(cfg, device="cuda")
    B, V, K = cfg.batch_size, cfg.num_views, cfg.num_candidates
    nb = learner.put_batch(SyntheticSilhouettes(
        B, cfg.image_size, V, n_points=512, seed=4).next_batch())
    p, sigma = learner._schedules(learner.step)
    gen = torch.Generator(device="cuda").manual_seed(1)
    keep_w = keep_mask(gen, B, cfg.num_points, p)

    def model_fwd_bwd():
        out = learner.model(nb["images"], nb["pose_input"])
        sum(v.float().sum() for v in out.values()).backward()

    with torch.no_grad():
        out = learner.model(nb["images"], nb["pose_input"])

    def sweep():
        with torch.no_grad():
            return unsupervised_loss(out, nb["masks"], sigma, keep_w, V,
                                     voxel_size=cfg.voxel_size,
                                     training=True)

    # K2's operands at the winner shape: the first candidate of every view
    cloud_v = out["point_cloud"].repeat_interleave(V, dim=0)
    cam, w, sc = _candidate_cam(cloud_v, out["ensemble_q"][:, :1],
                                out["scale"].reshape(B).repeat_interleave(V),
                                keep_w.repeat_interleave(V, dim=0))
    gz, gy, gx, c = _prep_projection(cam, cfg.voxel_size, w, 1e-6)
    taps, sc = _taps_and_scale(sigma, sc, 21, B * V, gz.device)
    gsil = torch.randn((B * V, cfg.voxel_size, cfg.voxel_size),
                       device="cuda", generator=gen)
    k2_ops = [t.contiguous() for t in (gz, gy, gx, c, taps, sc, gsil)]

    it = iters
    total = report(f"train step + loss fetch (bs {B}: K1 on {B * V * K} "
                   f"clouds, K2 on {B * V})",
                   lambda: float(learner.train_step(nb)["total_loss"]), it,
                   show=PROJECTION_OPS)
    parts = {
        "model forward + backward (bf16 trunks)":
            report("model forward + backward (bf16 trunks)", model_fwd_bwd,
                   it),
        f"keep mask ({B} x {cfg.num_points})":
            report(f"keep mask ({B} x {cfg.num_points})",
                   lambda: keep_mask(gen, B, cfg.num_points, p), it),
        f"candidate sweep, training keep mask (K1 on {B * V * K} clouds)":
            report(f"candidate sweep, training keep mask (K1 on {B * V * K} "
                   "clouds)", sweep, it),
        f"K2 alone ({B * V} winners)":
            report(f"K2 alone ({B * V} winners)",
                   lambda: projection_backward_kernel(*k2_ops), it),
        "AdamW update": report("AdamW update", learner.opt.step, it),
    }
    for name, busy in parts.items():
        print(f"share of the train step's device busy: {busy / total:.3f}  "
              f"{name}")
    print(f"peak MiB of one train step "
          f"{_peak_mib(lambda: learner.train_step(nb)):.3f}")


def profile_recon(iters: int) -> None:
    """The CUB eval step's windows; shares are of the whole step's device
    busy time."""
    cfg = ReconConfig()
    template = MeshTemplate(segments=32, rings=16)
    B, res = cfg.batch_size, cfg.image_resolution
    data = StructuredReconSet(template, B, res, cfg.texture_resolution,
                              device="cuda")
    batch = next(iter(batch_iterator(data, B, shuffle=False,
                                     num_workers=1)))
    trainer = ReconTrainer(cfg, dataset_size=len(data), template=template,
                           device="cuda")
    nb = trainer._put(batch)
    with torch.no_grad():
        tex, mesh_map = trainer.model(nb["image"])
        _, vtx, _, _ = trainer._pose_and_render(mesh_map, tex, nb)
        uvs, tex_adj = template.adjust_uv_and_texture(tex)
    faces = template.tensor("faces", "cuda")
    attrs = torch.cat([uvs[:, template.tensor("face_uvs", "cuda")],
                       vtx.new_ones((B, faces.shape[0], 3, 1))], dim=-1)
    feat, _ = rasterize(vtx, faces, attrs, res, res)
    grid = ((feat[..., :2] * 2 - 1) * feat.new_tensor([1.0, -1.0])
            ).contiguous()

    def forward():
        with torch.no_grad():
            return trainer.model(nb["image"])

    def pose_render():
        with torch.no_grad():
            return trainer._pose_and_render(mesh_map, tex, nb)

    it = iters
    total = report(f"recon eval_step + loss fetch (bs {B}, {res}², "
                   f"{faces.shape[0]} faces)",
                   lambda: float(trainer.eval_step(batch)[0]["recon_loss"]),
                   it)
    parts = {
        "H2D copy of the batch": lambda: trainer._put(batch),
        "network forward (bf16)": forward,
        "pose + render (vertex sampler, K4, K5)": pose_render,
        "K4 alone": lambda: rasterize(vtx, faces, attrs, res, res),
        "K5 alone": lambda: grid_sample_bilinear(tex_adj, grid),
    }
    kernels = {"K4 alone": "rasterize_fwd", "K5 alone": "grid_sample_fwd"}
    for name, fn in parts.items():
        busy = report(name, fn, it, kernel=kernels.get(name))
        print(f"share of the recon eval step's device busy: "
              f"{busy / total:.3f}  {name}")
    print(f"peak MiB of one recon eval step "
          f"{_peak_mib(lambda: trainer.eval_step(batch)):.3f}")


def profile_recon_train(iters: int) -> None:
    """The CUB train step's windows; shares are of the whole step's device
    busy time."""
    cfg = ReconConfig()
    template = MeshTemplate(segments=32, rings=16)
    B, res = cfg.batch_size, cfg.image_resolution
    data = StructuredReconSet(template, B, res, cfg.texture_resolution,
                              device="cuda")
    batch = next(iter(batch_iterator(data, B, shuffle=False,
                                     num_workers=1)))
    trainer = ReconTrainer(cfg, dataset_size=len(data), template=template,
                           device="cuda")
    nb = trainer._put(batch)
    faces = template.tensor("faces", "cuda")

    def net_fwd_bwd():
        trainer.model.train()
        tex, mesh_map = trainer.model(nb["image"])
        trainer.model.eval()
        (tex.float().sum() + mesh_map.float().sum()).backward()

    # the network's outputs as leaves that need a gradient, so the render
    # runs as in the step (K4 with its winner cache)
    with torch.no_grad():
        tex, mesh_map = trainer.model(nb["image"])
    tex_leaf = tex.clone().requires_grad_()
    mesh_leaf = mesh_map.clone().requires_grad_()

    def pose_render():
        return trainer._pose_and_render(mesh_leaf, tex_leaf, nb)

    # K4 and K5 backward operands at the step's shapes
    with torch.no_grad():
        _, vtx, _, _ = trainer._pose_and_render(mesh_map, tex, nb)
        uvs, tex_adj = template.adjust_uv_and_texture(tex)
    fv = vtx[:, faces].contiguous()
    attrs = torch.cat([uvs[:, template.tensor("face_uvs", "cuda")],
                       vtx.new_ones((B, faces.shape[0], 3, 1))],
                      dim=-1).contiguous()
    fwd = _launch_forward(fv, attrs, res, res, 1e-4, True, True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dfeat = torch.randn(fwd[0].shape, device="cuda", generator=gen)
    dsoft = torch.randn(fwd[1].shape, device="cuda", generator=gen)
    grid = ((fwd[0][..., :2] * 2 - 1) * fwd[0].new_tensor([1.0, -1.0])
            ).contiguous()
    # the step's d color is d image x hard mask: zero off the silhouette
    dcolor = (torch.randn(grid.shape[:3] + (3,), device="cuda", generator=gen)
              * fwd[0][..., 2:3]).contiguous()

    def adam():
        trainer.opt.step()
        trainer.opt_dp.step()

    trainer.train_step(batch)  # optimizer state exists for the Adam window
    it = iters
    total = report(f"recon train_step + loss fetch (bs {B}, {res}², "
                   f"{faces.shape[0]} faces)",
                   lambda: float(trainer.train_step(batch)["recon_loss"]), it)
    parts = {
        "H2D copy of the batch": lambda: trainer._put(batch),
        "network forward + backward (bf16)": net_fwd_bwd,
        "pose + render forward (vertex sampler, K4 + winners, K5)":
            pose_render,
        "K4 backward alone": lambda: rasterize_backward_kernel(
            fv, attrs, dfeat, dsoft, *fwd[1:], res, res),
        "K5 backward alone": lambda: grid_sample_bilinear_backward_kernel(
            tex_adj.contiguous(), grid, dcolor),
        "two Adam updates (network, DatasetParams)": adam,
    }
    kernels = {"K4 backward alone": "rasterize_bwd",
               "K5 backward alone": "grid_sample_bwd"}
    for name, fn in parts.items():
        busy = report(name, fn, it, kernel=kernels.get(name))
        print(f"share of the recon train step's device busy: "
              f"{busy / total:.3f}  {name}")
    print(f"peak MiB of one recon train step "
          f"{_peak_mib(lambda: trainer.train_step(batch)):.3f}")


def profile_gan_train(iters: int) -> None:
    """The GAN's 1G + 2D group and its parts; shares are of the group's
    device busy time."""
    B, res = 32, 512
    cfg = GANTrainConfig(model=GANConfig(compute_dtype="bfloat16",
                                         num_discriminators=3,
                                         conditional_class=True),
                         batch_size=B)
    trainer = GANTrainer(cfg, template=MeshTemplate(segments=32, rings=16),
                         device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nb = trainer.put_batch(dict(
        texture=torch.rand((B, res, res, 3), device="cuda",
                           generator=gen) * 2 - 1,
        alpha=(torch.rand((B, res, res, 1), device="cuda", generator=gen)
               > 0.4).float(),
        mesh=torch.randn((B, 32, 32, 3), device="cuda", generator=gen) * 0.02,
        c=torch.randint(0, 200, (B, 1), device="cuda", generator=gen)))
    z = trainer.sample_z(B)
    G, D = trainer.generator, trainer.discriminator

    def group():
        losses = [trainer.train_step(nb) for _ in range(3)]
        return [float(v) for ls in losses for v in ls.values()]

    def g_forward():
        G.train()
        with torch.no_grad():
            G(z, nb["c"])
        G.eval()

    with torch.no_grad():
        G.train()
        x_fake, mesh = trainer._fake(z, nb["c"], nb["alpha"])
        G.eval()
    x_comb = torch.cat([x_fake, torch.cat([nb["texture"], nb["alpha"]], -1)])
    mesh_comb = torch.cat([mesh, nb["mesh"].float()])
    c_comb = torch.cat([nb["c"], nb["c"]])
    a_comb = torch.cat([nb["alpha"], nb["alpha"]])

    def d_fwd_bwd():
        D.train()
        preds, _ = D(x_comb, mesh_comb, c_comb, alpha=a_comb)
        sum(p.sum() for p in preds).backward()
        D.eval()

    # K8's operands at the head's shape: blk6's output (B, 64, 512, 256)
    x8 = torch.randn((B, 64, res, res // 2), device="cuda",
                     generator=gen).to(torch.bfloat16)
    w8 = G.conv_final.weight.detach().to(torch.bfloat16).float().contiguous()
    b8 = G.conv_final.bias.detach().float().contiguous()
    y8 = head_conv_kernel(x8, w8, b8)
    g8 = (torch.randn(y8.shape, device="cuda", generator=gen)
          * (1 - y8.float() ** 2)).contiguous()

    # K9's operands at blk6's conv2: conv1's output, its folded norm1
    blk6 = G.blk6
    x9 = torch.randn((B, 64, res, res // 2), device="cuda",
                     generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        zc = torch.cat([z, G.emb_class(nb["c"][:, 0].long())], dim=1)
        a9, b9 = blk6.norm1.fold(x9, zc.to(torch.bfloat16))
        w9 = blk6.conv2.normalized_weight().detach()

    group()  # optimizer state exists for every window
    it = iters
    total = report(f"1G + 2D group + loss fetch (bs {B}, {res}², bf16, 3 "
                   "critics)", group, it, show=("head_conv", "fused_conv"))
    parts = {
        "G step": lambda: trainer.g_step(nb, z),
        "D step": lambda: trainer.d_step(nb, z),
        "generator forward (train mode)": g_forward,
        f"critics forward + backward ({2 * B} textures)": d_fwd_bwd,
        "K8 forward alone": lambda: head_conv_kernel(x8, w8, b8),
        "K8 dW alone": lambda: head_conv_dw_kernel(x8, g8),
        "K9 forward alone (blk6 conv2)":
            lambda: fused_affine_conv3x3_kernel(x9, a9, b9, w9),
        "EMA update": lambda: trainer._update_ema(0.999),
    }
    kernels = {"K8 forward alone": "head_conv",
               "K8 dW alone": "head_conv_dw_partial",
               "K9 forward alone (blk6 conv2)": "fused_conv_bf16"}
    for name, fn in parts.items():
        busy = report(name, fn, it, kernel=kernels.get(name))
        print(f"share of the group's device busy: {busy / total:.3f}  "
              f"{name}")
    print(f"peak MiB of one group {_peak_mib(group):.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", choices=("eval", "train", "recon",
                                       "recon_train", "gan_train"),
                    default=None,
                    help="profile one path (default: all five)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())

    if args.only in (None, "gan_train"):
        profile_gan_train(args.iters)
    if args.only == "gan_train":
        return 0
    if args.only in (None, "recon_train"):
        profile_recon_train(args.iters)
    if args.only == "recon_train":
        return 0
    if args.only in (None, "recon"):
        profile_recon(args.iters)
    if args.only == "recon":
        return 0
    cfg = ShapeNetConfig.chairs()
    if args.only != "eval":
        profile_train(cfg, args.iters)
    if args.only == "train":
        return 0
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
           lambda: float(learner.eval_step(batch)["projection_loss"]), it,
           show=PROJECTION_OPS)
    report("normalize (H2D copy of one uint8 batch + /255)",
           lambda: learner._normalize(batch), it)
    report("model forward (bf16 trunks)", model_forward, it)
    report(f"keep_mask ({B} x {cfg.num_points})",
           lambda: keep_mask(gen, B, cfg.num_points, p), it)
    report(f"eval loss (K1 on {B * V} clouds)",
           lambda: eval_loss(False, keep_w), it)
    report(f"candidate sweep loss (K1 on {B * V * cfg.num_candidates} "
           "clouds)", lambda: eval_loss(True, None), it, show=PROJECTION_OPS)

    print(f"peak MiB of the sweep {_peak_mib(lambda: eval_loss(True, None)):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
