#!/usr/bin/env python3
"""Times of K9 (folded affine + leaky ReLU + 3 × 3 conv), K5 forward and
backward (texture sampler and its gradient), K8 forward and dW (the GAN
head conv and its weight gradient), K4 forward and backward (the
rasterizer and its gradient), K1 and K2 (the projection forward and
backward) and K6 forward (the standalone splat) on one GPU, for the port
found under ``--root``.

``--root`` (default: this checkout) is put first on ``sys.path``, so the
same script times another checkout's kernels, e.g. a ``git archive`` of
the parent commit: run it from both, in turns (parent, change, change,
parent), in one command on one card.  Each root builds its own kernels
into its own ``build/``.

K9, bf16, replicate padding, at the 8 conv2 shapes of one pass of the
CLI's 512 generator at bs 32 (blk1 … blk6 and blk3_mesh) with the folded
affine, and at blk6's conv1 shape without it (32 × 128 × 512 × 256 → 64):
the wrapper's time per call (CUDA events over ``--k9_reps`` calls, 10
times as many below 128 × 64 pixels; the weight cast the parent's wrapper
makes included), its bound (the bytes of
x, a, b, the bf16 weights and y over 3.35 TB/s or its operations over
989 TFLOP/s, the larger), cuDNN's pad + conv on the same operands, and a
hash of the output (equal hashes: bit-equal outputs of two checkouts).

K5 forward at the renderer's shape, 50 textures of 128 × 130 × 3 sampled
at 50 × 256² points: the UVs of ``chip_smoke.py`` phase 8's render (its
``_cub_scene`` through the rasterizer, back faces culled, mapped as the
fragment shader maps them; the root's ``chip_smoke.py`` builds them) and
random points in [-1.1, 1.1], each:
  - event time: CUDA events around 50 back-to-back wrapper calls;
  - device time: the same 50 calls captured in a CUDA graph and replayed
    between events (no host work between the kernels);
  - ``F.grid_sample`` (NCHW texture) event and device time the same way,
    and its device time with the NHWC → NCHW permute of the texture;
  - the wrapper's host time per call: host clock over 500 calls, with no
    synchronisation inside the loop;
each as min / median / max of ``--repeats`` repeats.

K8 forward at the head's shape, 32 × 64 × 512 × 256 bf16 → 3, replicate
padding (``chip_smoke.py``'s ``_head_operands``): the wrapper's event time
over 20 calls and its device time in a CUDA graph of 20, and the event
time of the model's entry ``head_conv_tanh`` without autograd (which the
parent's ``_HeadConv`` precedes with a cast of the weight), each as min /
median / max of ``--repeats`` repeats; the bytes bound.

K4 backward at ``chip_smoke.py``'s ``_cub_scene`` (50 × 256², 960 faces,
A = 3, sigma 1e-4, back faces culled), random d feat and d soft (seed 16):
event and device time the same way, and whether 3 launches are bit-equal.

K1 (projection forward) at ``chip_smoke.py`` phase 2's timed shape, 480
clouds × 8000 points at 64³, sigma 3.0, keep-prob 0.07, and K2 (its
backward) at phase 3's first case, 120 clouds × 8000 points, a random
silhouette cotangent: the wrapper on the grid-coordinate planes (the cull
and coordinates of ``_prep_projection`` made once, outside the timing),
event and device time over 20 calls, min / median / max of ``--repeats``
repeats; the peak device memory one call adds; for K2 whether 3 launches
give a bit-equal dscale.

K1 and K2 also at the planes / cars configuration (``k1s32``, ``k2s32``:
``ShapeNetConfig.planes()``, 320 clouds × 4000 points for K1 and 80 for K2
at 32³, sigma 2.44, keep-prob 0.256), each with a hash of its outputs.

K4 forward (``k4f``) at ``_cub_scene``, back faces culled, with the winner
cache (the recon train step's launch) and without (eval, FID): event and
device time; the hashes of feat, soft, win and wz with back faces culled
and drawn (equal hashes: bit-equal checkouts), and whether two launches
are bit-equal.

K8 dW (``k8dw``) at the head's shape, bf16 x, replicate, the float32
upstream of ``chip_smoke.py`` phase 19: event and device time, cuDNN's pad
+ weight gradient on the bf16-rounded upstream (event time), the bytes
bound and a hash of dW.

K5 backward (``k5b``) at ``chip_smoke.py`` phase 12's train shape (50 ×
256² rendered UVs, a random upstream times the hard mask, d texture and d
grid) and visibility shape (50 × 1024², the hard mask on every channel, d
texture only): the wrapper's event and device time (10 calls, the d
texture memset included), ``grid_sampler_2d_backward`` on NCHW copies
(event time), the bytes bound, hashes of d texture's > 0 mask and of d
grid, whether 3 launches are bit-equal, and the root's plan.

K6 forward (``k6``) at the eval CLI's 3D IoU shape ((24, 8000) at 32³) and
the candidate sweep's (480 × 8000 at 64³, keep-prob 0.07): event and
device time, the bytes bound, a hash of the grid and the root's plan.

K3 (``k3``) at ``chip_smoke.py`` phase 4's clouds, (24, 8000) against
(24, 512) (the eval CLI's) and (24, 2048) (the real-data eval's): the
Chamfer pair (both directions: one pair-mode launch where the root has
``chamfer_kernel``, else one ``nn_dist2`` launch each way) and the
rows-only ``nn_dist2`` in both roles: event and device time, hashes of
the outputs, whether 3 launches are bit-equal, and the root's plans.

K7 forward (``k7``) at phase 25's meshing shapes ((1, 8000) at 96³ and
128³, sigma 1.5) and the sweep's (480 × 8000 at 64³, keep-prob 0.07,
sigma 3.0): event and device time, the wrapper's host time, the bound
and the root's plan.  K6 and K7 backward (``k6b``, ``k7b``) at phase
24's and 25's shapes with non-negative weights (K6 also at the 3D IoU's
(24, 8000) at 32³): event and device time with dc and, where the root
takes ``need_dc``, without it, the bound of what the data needs, the
hashes of 3 launches' outputs and whether they are bit-equal, and the
voxels whose raw splat lies within 1e-6 of 1 (where the clamp's mask can
flip between float sums in another order).

The timing helpers are ``tools/gpu_timing.py``'s, from this checkout
whatever the root.  Prints one JSON line ``{"root": ..., "gpu": ...,
"k9": [...], "k5": {...}, "k8": {...}, "k4b": {...}, "k1": {...},
"k2": {...}, "k4f": {...}, "k8dw": {...}, "k1s32": {...},
"k2s32": {...}, "k5b": {...}, "k6": {...}, "k3": {...}, "k7": {...},
"k6b": {...}, "k7b": {...}}`` (the ones run) as its last line.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/kernel_times.py [--root DIR]
        [--only k9 k5 k8 k4b k1 k2 k4f k8dw k1s32 k2s32 k5b k6 k3 k7 k6b
         k7b]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

from gpu_timing import (K9_PASS, PEAK_BYTES, events_ms, graph_ms, gpu_line,
                        host_ms, peak_mib, spread)

PEAK_BF16 = 989e12
B_GAN = 32
# (name, (Cin, H, W, Cout), affine): the generator's 8 conv2s, then blk6's
# conv1
K9_SHAPES = tuple((name, shape, True) for name, shape in K9_PASS) + (
    ("blk6 conv1 (no affine)", (128, 512, 256, 64), False),)


def _digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    import torch

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def _timed(fn, repeats: int, reps: int = 20) -> dict:
    """Event and device (CUDA graph) ms per call, min / median / max."""
    ev = [events_ms(fn, reps) for _ in range(repeats)]
    dv = [graph_ms(fn, reps) for _ in range(repeats)]
    return dict(event_ms=spread(ev), device_ms=spread(dv))


def time_k8(repeats: int) -> dict:
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.conv import head_conv_kernel, head_conv_tanh

    x, w, b = cs._head_operands(torch.bfloat16, 20)
    res = _timed(lambda: head_conv_kernel(x, w, b), repeats)

    def entry():
        with torch.no_grad():
            return head_conv_tanh(x, w, b)

    res["entry_event_ms"] = spread([events_ms(entry, 20)
                                    for _ in range(repeats)])
    # reads x, w, b, writes y: 3 of x's C channels in x's type
    nbytes = (x.numel() * 2 + (w.numel() + b.numel()) * 4
              + x.numel() // x.shape[1] * 3 * 2)
    res.update(shape=list(x.shape), bound_ms=nbytes / PEAK_BYTES * 1e3)
    for k in ("event_ms", "device_ms", "entry_event_ms"):
        v = res[k]
        print(f"[K8] {k}: min {v['min']:.4f} / median {v['median']:.4f} / "
              f"max {v['max']:.4f}", flush=True)
    print(f"[K8] bound {res['bound_ms']:.4f} ms (bytes)", flush=True)
    return res


def time_k4b(repeats: int) -> dict:
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.rasterizer import (
        _launch_forward,
        rasterize_backward_kernel,
    )

    dev = torch.device("cuda")
    verts, faces, attrs, _ = cs._cub_scene(
        MeshTemplate(segments=32, rings=16), dev)
    fv, at = verts[:, faces].contiguous(), attrs.contiguous()
    R = cs.RES
    fwd = _launch_forward(fv, at, R, R, cs.SIGMA, True, True)
    gen = torch.Generator(device=dev).manual_seed(16)
    dfeat = torch.randn(fwd[0].shape, device=dev, generator=gen)
    dsoft = torch.randn(fwd[1].shape, device=dev, generator=gen)

    def k4b():
        return rasterize_backward_kernel(fv, at, dfeat, dsoft, *fwd[1:], R, R,
                                         cs.SIGMA, True)

    res = _timed(k4b, repeats)
    outs = [k4b() for _ in range(3)]
    res["bit_equal_launches"] = all(
        torch.equal(o[i], outs[0][i]) for o in outs for i in range(2))
    for k in ("event_ms", "device_ms"):
        v = res[k]
        print(f"[K4 bwd] {k}: min {v['min']:.4f} / median {v['median']:.4f}"
              f" / max {v['max']:.4f}", flush=True)
    print(f"[K4 bwd] 3 launches bit-equal: {res['bit_equal_launches']}",
          flush=True)
    return res


# the planes and cars configurations (``ShapeNetConfig.planes()``,
# ``.cars()``): bs 16, 5 views, 4 candidates, 4000 points, 32³, the planes'
# schedule start (sigma 2.44, keep-prob 0.256)
S32 = dict(batch=16, n=4000, S=32, sigma=2.44, p=0.256)


def _projection_operands(backward: bool, cfg: dict | None = None) -> list:
    """K1's (or, with ``backward``, K2's) operands at ``chip_smoke.py``'s
    timed shapes, or at ``cfg`` (batch, n, S, sigma, p), on the
    grid-coordinate planes."""
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.camera import world_to_camera_zyx
    from im23d_tpu_torch.ops.pointcloud import keep_mask
    from im23d_tpu_torch.ops.projection import (
        _prep_projection,
        _taps_and_scale,
    )
    from im23d_tpu_torch.ops.quaternion import qnormalize

    dev = torch.device("cuda")
    cfg = cfg or dict(batch=cs.B, n=cs.N, S=cs.S, sigma=cs.K1_CASES[0][0],
                      p=cs.K1_CASES[0][1])
    C = cfg["batch"] * cs.V * (1 if backward else cs.K)
    S, N = cfg["S"], cfg["n"]
    rng = np.random.RandomState(3 if backward else 0)
    cloud = cs._clouds(rng, C, N, dev)
    quats = qnormalize(torch.as_tensor(rng.randn(C, 4).astype(np.float32),
                                       device=dev))
    planes = world_to_camera_zyx(cloud, quats)
    scale = torch.as_tensor(rng.uniform(0.2, 1.5, C).astype(np.float32),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(1 if backward else 0)
    w = keep_mask(gen, C, N, cfg["p"])
    gz, gy, gx, c = _prep_projection(planes, S, w, 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(cfg["sigma"], device=dev), scale,
                               21, C, dev)
    ops = [gz, gy, gx, c, taps, sc]
    if backward:
        ops.append(torch.randn((C, S, S), device=dev, generator=gen))
    return [t.contiguous() for t in ops]


def time_projection(backward: bool, repeats: int,
                    cfg: dict | None = None) -> dict:
    import torch

    from im23d_tpu_torch.ops.projection import (
        projection_backward_kernel,
        projection_kernel,
    )

    ops = _projection_operands(backward, cfg)
    S = ops[-1].shape[-1] if backward else None
    if backward:
        def call():
            return projection_backward_kernel(*ops)
    else:
        import chip_smoke as cs  # the root's

        S = cfg["S"] if cfg else cs.S

        def call():
            return projection_kernel(*ops, S)
    res = _timed(call, repeats)
    res["peak_mib"] = peak_mib(call)
    res["clouds"] = ops[0].shape[0]
    res["S"] = S
    # equal hashes: bit-equal outputs of two checkouts
    out = call()
    res["sha256"] = [_digest(t) for t in (out if backward else (out,))]
    tag = ("K2" if backward else "K1") + (f" S={S}" if cfg else "")
    if backward:
        ds = [call()[3] for _ in range(3)]
        res["dscale_bit_equal"] = all(torch.equal(d, ds[0]) for d in ds)
    for k in ("event_ms", "device_ms"):
        v = res[k]
        print(f"[{tag}] {k}: min {v['min']:.4f} / median {v['median']:.4f} / "
              f"max {v['max']:.4f}", flush=True)
    print(f"[{tag}] {res['clouds']} clouds: one call adds "
          f"{res['peak_mib']:.1f} MiB at its peak"
          + (f"; dscale bit-equal over 3 launches: "
             f"{res['dscale_bit_equal']}" if backward else "")
          + f"; output sha256 {res['sha256']}", flush=True)
    return res


def time_k4f(repeats: int) -> dict:
    """K4 forward at ``_cub_scene``, back faces culled: with the winner
    cache (the recon train step's launch) and without (eval, FID)."""
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.rasterizer import _launch_forward

    dev = torch.device("cuda")
    verts, faces, attrs, _ = cs._cub_scene(
        MeshTemplate(segments=32, rings=16), dev)
    fv, at = verts[:, faces].contiguous(), attrs.contiguous()
    R = cs.RES
    res = {}
    for winners in (True, False):
        def k4f(winners=winners):
            return _launch_forward(fv, at, R, R, cs.SIGMA, True, winners)

        key = "winners" if winners else "no_winners"
        res[key] = _timed(k4f, repeats)
        for k in ("event_ms", "device_ms"):
            v = res[key][k]
            print(f"[K4 fwd] {key} {k}: min {v['min']:.4f} / median "
                  f"{v['median']:.4f} / max {v['max']:.4f}", flush=True)
    outs = [_launch_forward(fv, at, R, R, cs.SIGMA, cull, True)
            for cull in (True, False)]
    res["sha256"] = {f"{name} cull={cull}": _digest(t)
                     for cull, out in zip((True, False), outs)
                     for name, t in zip(("feat", "soft", "win", "wz"), out)}
    again = _launch_forward(fv, at, R, R, cs.SIGMA, True, True)
    res["bit_equal_launches"] = all(torch.equal(a, b)
                                    for a, b in zip(outs[0], again))
    print(f"[K4 fwd] output sha256 {res['sha256']}; 2 launches bit-equal: "
          f"{res['bit_equal_launches']}", flush=True)
    return res


def time_k8dw(repeats: int) -> dict:
    """K8 dW at the head's shape, bf16 x, replicate, the float32 upstream
    ``chip_smoke.py`` phase 19 forms; cuDNN's pad + weight gradient on the
    bf16-rounded upstream beside it."""
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.models.reconstruction import replicate_pad_w
    from im23d_tpu_torch.ops.conv import head_conv_dw_kernel, head_conv_kernel

    x, w, b = cs._head_operands(torch.bfloat16, 21)
    gen = torch.Generator(device="cuda").manual_seed(22)
    y = head_conv_kernel(x, w, b).float()
    g = (torch.randn(y.shape, device="cuda", generator=gen)
         * (1.0 - y * y)).contiguous()
    del y
    gd = g.to(torch.bfloat16)
    res = _timed(lambda: head_conv_dw_kernel(x, g), repeats)
    res["library_event_ms"] = spread([events_ms(
        lambda: torch.nn.grad.conv2d_weight(replicate_pad_w(x, 2), w.shape,
                                            gd, padding=(2, 0)), 10)
        for _ in range(repeats)])
    res["sha256"] = _digest(head_conv_dw_kernel(x, g))
    # reads x and the bf16 upstream, writes dW
    nbytes = x.numel() * 2 + gd.numel() * 2 + w.numel() * 4
    res.update(shape=list(x.shape), bound_ms=nbytes / PEAK_BYTES * 1e3)
    for k in ("event_ms", "device_ms", "library_event_ms"):
        v = res[k]
        print(f"[K8 dW] {k}: min {v['min']:.4f} / median {v['median']:.4f} "
              f"/ max {v['max']:.4f}", flush=True)
    print(f"[K8 dW] bound {res['bound_ms']:.4f} ms (bytes); output sha256 "
          f"{res['sha256']}", flush=True)
    return res


def time_k9(k9_reps: int) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from im23d_tpu_torch.models.reconstruction import replicate_pad_w
    from im23d_tpu_torch.ops.conv import fused_affine_conv3x3_kernel

    out = []
    for name, (cin, H, W, cout), affine in K9_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(cin + H)
        x = torch.randn((B_GAN, cin, H, W), device="cuda",
                        generator=gen).to(torch.bfloat16)
        w = torch.randn((cout, cin, 3, 3), device="cuda",
                        generator=gen) / (9 * cin) ** 0.5
        a = b = None
        if affine:
            a = 1.0 + 0.3 * torch.randn((B_GAN, cin), device="cuda",
                                        generator=gen)
            b = 0.3 * torch.randn((B_GAN, cin), device="cuda", generator=gen)
        wd = w.to(torch.bfloat16)
        # layers of a few tens of microseconds: 10 times the calls
        reps = k9_reps * (10 if H * W < 128 * 64 else 1)
        ms = events_ms(lambda: fused_affine_conv3x3_kernel(x, a, b, w), reps)
        conv_ms = events_ms(lambda: F.conv2d(replicate_pad_w(x, 1), wd,
                                              padding=(1, 0)), reps)
        # the bf16 (3, 3, Cout, Cin) weight the parent's wrapper builds
        prep_ms = events_ms(lambda: w.to(torch.bfloat16).permute(
            2, 3, 0, 1).contiguous(), reps)
        digest = _digest(fused_affine_conv3x3_kernel(x, a, b, w))
        px = B_GAN * H * W
        nbytes = (x.numel() * 2 + wd.numel() * 2 + px * cout * 2
                  + (2 * a.numel() * 4 if affine else 0))
        ops = 2 * 9 * cin * cout * px
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        row = dict(name=name, shape=[B_GAN, cin, H, W, cout], affine=affine,
                   ms=ms, bound_ms=max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations",
                   cudnn_pad_conv_ms=conv_ms, weight_prep_ms=prep_ms,
                   sha256=digest)
        print(f"[K9] {name} {row['shape']}: {ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}), cuDNN pad + conv "
              f"{conv_ms:.4f}, bf16 weight cast + permute {prep_ms:.4f}; "
              f"output sha256 {digest}", flush=True)
        out.append(row)
        del x, w, a, b, wd
        torch.cuda.empty_cache()
    return out


def _k5_grids() -> dict:
    """The renderer's textures and two grids at its shape: phase 8's
    rendered UVs and random points in [-1.1, 1.1]."""
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.rasterizer import rasterize

    dev = torch.device("cuda")
    template = MeshTemplate(segments=32, rings=16)
    verts, faces, attrs, tex_adj = cs._cub_scene(template, dev)
    with torch.no_grad():
        feat = rasterize(verts, faces, attrs, cs.RES, cs.RES, cs.SIGMA,
                         True)[0]
    uv = feat[..., :2]
    gen = torch.Generator(device=dev).manual_seed(5)
    return tex_adj, {
        "rendered": ((uv * 2 - 1) * uv.new_tensor([1.0, -1.0])).contiguous(),
        "random": torch.rand((cs.RB, cs.RES, cs.RES, 2), device=dev,
                             generator=gen) * 2.2 - 1.1,
    }


def _k5b_operands() -> dict:
    """K5 backward's operands at ``chip_smoke.py`` phase 12's two shapes on
    its ``_cub_scene``: (texture, grid, upstream, need_grid) for ``train``
    (50 × 256² rendered UVs, a random upstream times the hard mask, as the
    recon train step gives it) and ``visibility`` (50 × 1024² rendered
    UVs, the hard mask on every channel, d texture only)."""
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.rasterizer import rasterize

    dev = torch.device("cuda")
    verts, faces, attrs, tex = cs._cub_scene(
        MeshTemplate(segments=32, rings=16), dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}
    for name, res in (("train", cs.RES), ("visibility", 1024)):
        with torch.no_grad():
            feat = rasterize(verts, faces, attrs, res, res, cs.SIGMA)[0]
        grid = ((feat[..., :2] * 2 - 1) * feat.new_tensor([1.0, -1.0])
                ).contiguous()
        hard = feat[..., 2:3]
        if name == "train":
            dout = (torch.randn(grid.shape[:3] + tex.shape[3:], device=dev,
                                generator=gen) * hard).contiguous()
        else:
            dout = hard.expand(-1, -1, -1, tex.shape[-1]).contiguous()
        del feat
        out[name] = (tex, grid, dout, name == "train")
    return out


def time_k5b(repeats: int) -> dict:
    """K5 backward at both shapes: event and device time, the bytes bound,
    ``grid_sampler_2d_backward`` on NCHW copies (event time), hashes of d
    texture's > 0 mask and of d grid, whether 3 launches are bit-equal, and
    which plan the root's wrapper takes (where it has one)."""
    import torch

    from im23d_tpu_torch.ops import sampling
    from im23d_tpu_torch.ops.sampling import (
        grid_sample_bilinear_backward_kernel as k5b,
    )

    res = {}
    for name, (img, grid, dout, need_grid) in _k5b_operands().items():
        def call():
            return k5b(img, grid, dout, True, need_grid)

        r = _timed(call, repeats, 10)
        nchw, dnchw = (t.permute(0, 3, 1, 2).contiguous() for t in (img, dout))
        r["library_event_ms"] = spread([events_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                dnchw, nchw, grid, 0, 0, True, [True, need_grid]), 10)
            for _ in range(repeats)])
        del nchw, dnchw
        # reads the grid and upstream (and the texture for d grid), writes
        # d texture (and d grid)
        nbytes = (grid.numel() + dout.numel() + img.numel()
                  + (img.numel() + grid.numel() if need_grid else 0)) * 4
        outs = [call() for _ in range(3)]
        r.update(bound_ms=nbytes / PEAK_BYTES * 1e3,
                 bit_equal_launches=all(
                     torch.equal(o[0], outs[0][0]) for o in outs),
                 mask_digest=_digest(outs[0][0] > 0),
                 dgrid_digest=_digest(outs[0][1]) if need_grid else None)
        if hasattr(sampling, "grid_sample_backward_plan"):
            r["plan"] = sampling.grid_sample_backward_plan(
                *img.shape, grid[0, ..., 0].numel(), True,
                sampling.k5b_limits())
        del outs
        res[name] = r
        for k in ("event_ms", "device_ms", "library_event_ms"):
            v = r[k]
            print(f"[K5 bwd] {name} {k}: min {v['min']:.4f} / median "
                  f"{v['median']:.4f} / max {v['max']:.4f}", flush=True)
        print(f"[K5 bwd] {name}: bound {r['bound_ms']:.4f} ms (bytes); 3 "
              f"launches bit-equal {r['bit_equal_launches']}; > 0 mask "
              f"{r['mask_digest']}; d grid {r['dgrid_digest']}; plan "
              f"{r.get('plan')}", flush=True)
    return res


def time_k6(repeats: int) -> dict:
    """K6 forward at the eval CLI's 3D IoU shape ((24, 8000) at 32³, the
    clouds of ``chip_smoke.py`` phase 24) and at the candidate sweep's
    (480 × 8000 at 64³, keep-prob 0.07): event and device time, the bytes
    bound, a hash of the grid, and the root's plan (where it has one)."""
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops import splat
    from im23d_tpu_torch.ops.pointcloud import keep_mask

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    res = {}
    for name, pts, size, p in (
            ("iou", cs._clouds(np.random.RandomState(7), cs.B, cs.N, dev),
             cs.IOU_S, None),
            ("sweep", cs._sweep_points(6, cs.B * cs.V * cs.K, dev), cs.S,
             0.07)):
        w = None if p is None else keep_mask(gen, pts.shape[0], cs.N, p)
        ops = splat._prep_splat(pts, size, w, 1e-6)

        def call():
            return splat.splat_kernel(*ops, size)

        r = _timed(call, repeats)
        nbytes = sum(t.numel() for t in ops) * 4 + pts.shape[0] * size ** 3 * 4
        r.update(bound_ms=nbytes / PEAK_BYTES * 1e3, digest=_digest(call()))
        if hasattr(splat, "splat_plan"):
            r["plan"] = splat.splat_plan(pts.shape[0], size,
                                         splat.splat_limits(dev))
        res[name] = r
        for k in ("event_ms", "device_ms"):
            v = r[k]
            print(f"[K6] {name} {k}: min {v['min']:.4f} / median "
                  f"{v['median']:.4f} / max {v['max']:.4f}", flush=True)
        print(f"[K6] {name}: bound {r['bound_ms']:.4f} ms (bytes); hash "
              f"{r['digest']}; plan {r.get('plan')}", flush=True)
    return res


def time_k3(repeats: int) -> dict:
    """K3 at phase 4's clouds: the Chamfer pair and the rows-only mode in
    both roles (see the module's docstring)."""
    import torch

    from im23d_tpu_torch.metrics import chamfer
    from time_split import _k3_clouds

    pair_kernel = getattr(chamfer, "chamfer_kernel", None)
    res = {}
    for m, (x, y) in _k3_clouds().items():
        if pair_kernel is not None:
            def pair():
                return pair_kernel(x, y)
        else:
            def pair():
                return (chamfer.nn_dist2_kernel(x, y),
                        chamfer.nn_dist2_kernel(y, x))
        cases = (("pair", pair),
                 ("pred_gt", lambda: (chamfer.nn_dist2_kernel(x, y),)),
                 ("gt_pred", lambda: (chamfer.nn_dist2_kernel(y, x),)))
        r = {}
        for tag, fn in cases:
            t = _timed(fn, repeats)
            outs = [fn() for _ in range(3)]
            t["digests"] = [_digest(o) for o in outs[0]]
            t["bit_equal_launches"] = all(
                torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
            r[tag] = t
            print(f"[K3] m={m} {tag}: event {t['event_ms']} device "
                  f"{t['device_ms']}; hashes {t['digests']}; 3 launches "
                  f"bit-equal {t['bit_equal_launches']}", flush=True)
        if hasattr(chamfer, "chamfer_plan"):
            lim = chamfer.chamfer_limits(x.device)
            r["plans"] = {k: chamfer.chamfer_plan(x.shape[0], n1, n2, lim)
                          for k, (n1, n2) in (("pair", (x.shape[1], m)),
                                              ("gt_pred", (m, x.shape[1])))}
            print(f"[K3] m={m} plans {r['plans']}", flush=True)
        res[f"m{m}"] = r
    return res


def time_k7(repeats: int) -> dict:
    """K7 forward at phase 25's shapes (see the module's docstring)."""
    from im23d_tpu_torch.ops import splat
    from time_split import _k7_cases

    res = {}
    for tag, (gz, gy, gx, c), taps, S in _k7_cases():
        def call(gz=gz, gy=gy, gx=gx, c=c, taps=taps, S=S):
            return splat.splat_blur_kernel(gz, gy, gx, c, taps, S)

        r = _timed(call, repeats)
        r["host_ms"] = spread([host_ms(call, 50) for _ in range(repeats)])
        B = gz.shape[0]
        r["bound_ms"] = (4 * (4 * gz.numel() + taps.numel())
                         + 4 * B * S ** 3) / PEAK_BYTES * 1e3
        if hasattr(splat, "splat_blur_plan"):
            r["plan"] = splat.splat_blur_plan(
                B, S, taps.numel(), splat.splat_blur_limits(gz.device))
        res[tag] = r
        for k in ("event_ms", "device_ms", "host_ms"):
            v = r[k]
            print(f"[K7] {tag} {k}: min {v['min']:.4f} / median "
                  f"{v['median']:.4f} / max {v['max']:.4f}", flush=True)
        print(f"[K7] {tag}: bytes bound {r['bound_ms']:.4f} ms; plan "
              f"{r.get('plan')}", flush=True)
    return res


def time_backward(which: str, repeats: int) -> dict:
    """K6 (``k6b``) or K7 (``k7b``) backward at ``time_split._bwd_cases``
    (weights >= 0): event and device time with dc and, where the root's
    wrapper takes ``need_dc``, without it; the hashes of 3 launches'
    outputs and whether they are bit-equal; the bound of the work the data
    needs (``gpu_timing.splat_backward_work``); the voxels whose raw splat
    lies within 1e-6 of 1 (where the clamp's mask can flip between float
    sums in another order); and the root's plan where it has one."""
    import inspect

    import torch

    from gpu_timing import PEAK_F32, splat_backward_work
    from im23d_tpu_torch.ops import splat
    from im23d_tpu_torch.ops.voxel import splat_sum
    from time_split import _bwd_cases

    kernel = (splat.splat_backward_kernel if which == "k6b"
              else splat.splat_blur_backward_kernel)
    takes_dc = "need_dc" in inspect.signature(kernel).parameters
    res = {}
    for tag, (gz, gy, gx, c), taps, S, g in _bwd_cases(which):
        ops = (gz, gy, gx, c) if taps is None else (gz, gy, gx, c, taps)
        K = 0 if taps is None else taps.numel()
        raw = splat_sum(torch.stack((gz, gy, gx), -1), c, S)
        r = {"near_one": int(((raw - 1).abs() <= 1e-6).sum()),
             "negative": int((raw < 0).sum())}
        del raw
        for dc in (True, False) if takes_dc else (True,):
            def call(dc=dc):
                if takes_dc:
                    return kernel(*ops, g, need_dc=dc)
                return kernel(*ops, g)

            t = _timed(call, repeats, 10)
            outs = [[o for o in call() if o is not None] for _ in range(3)]
            t["digests"] = [_digest(o) for o in outs[0]]
            t["bit_equal_launches"] = all(
                torch.equal(a, b) for o in outs[1:] for a, b in
                zip(o, outs[0]))
            nbytes, flops = splat_backward_work(gz, gy, gx, c, S, K, dc)
            t["bound_ms"] = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
            r["dc" if dc else "no_dc"] = t
            print(f"[{which}] {tag} {'with' if dc else 'without'} dc: event "
                  f"{t['event_ms']} device {t['device_ms']}; bound "
                  f"{t['bound_ms']:.4f} ms; hashes {t['digests']}; 3 "
                  f"launches bit-equal {t['bit_equal_launches']}",
                  flush=True)
            del outs
        if hasattr(splat, "splat_backward_plan"):
            r["plan"] = splat.splat_backward_plan(
                gz.shape[0], S, K, splat.splat_blur_limits(gz.device))
        res[tag] = r
        print(f"[{which}] {tag}: voxels within 1e-6 of 1: {r['near_one']}, "
              f"below 0: {r['negative']}; plan {r.get('plan')}", flush=True)
        torch.cuda.empty_cache()
    return res


def time_k5(repeats: int) -> dict:
    import torch.nn.functional as F

    from im23d_tpu_torch.ops.sampling import grid_sample_bilinear_kernel

    img, grids = _k5_grids()
    nchw = img.permute(0, 3, 1, 2).contiguous()
    res = {}
    for gname, grid in grids.items():
        def k5():
            return grid_sample_bilinear_kernel(img, grid)

        def lib():
            return F.grid_sample(nchw, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)

        def lib_permute():
            return F.grid_sample(img.permute(0, 3, 1, 2).contiguous(), grid,
                                 mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        runs = {k: [] for k in ("event_ms", "device_ms", "library_event_ms",
                                "library_device_ms",
                                "library_permute_device_ms", "host_ms")}
        for _ in range(repeats):
            runs["event_ms"].append(events_ms(k5, 50))
            runs["device_ms"].append(graph_ms(k5, 50))
            runs["library_event_ms"].append(events_ms(lib, 50))
            runs["library_device_ms"].append(graph_ms(lib, 50))
            runs["library_permute_device_ms"].append(graph_ms(lib_permute,
                                                              50))
            runs["host_ms"].append(host_ms(k5, 500))
        res[gname] = {k: spread(v) for k, v in runs.items()}
        for k, v in res[gname].items():
            print(f"[K5] {gname} {k}: min {v['min']:.4f} / median "
                  f"{v['median']:.4f} / max {v['max']:.4f}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--only", nargs="+",
                    choices=("k9", "k5", "k8", "k4b", "k1", "k2", "k4f",
                             "k8dw", "k1s32", "k2s32", "k5b", "k6", "k3",
                             "k7", "k6b", "k7b"))
    ap.add_argument("--k9_reps", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import im23d_tpu_torch

    if not os.path.abspath(im23d_tpu_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {im23d_tpu_torch.__file__}, not from "
                           f"{root}")
    from im23d_tpu_torch.ops import _build

    _build.load_kernels()
    gpu = gpu_line()
    print(f"[gpu] {gpu}; root {root}", flush=True)
    res = dict(root=root, gpu=gpu)
    if args.only is None or "k9" in args.only:
        res["k9"] = time_k9(args.k9_reps)
    if args.only is None or "k5" in args.only:
        res["k5"] = time_k5(args.repeats)
    if args.only is None or "k8" in args.only:
        res["k8"] = time_k8(args.repeats)
    if args.only is None or "k4b" in args.only:
        res["k4b"] = time_k4b(args.repeats)
    if args.only is None or "k1" in args.only:
        res["k1"] = time_projection(False, args.repeats)
    if args.only is None or "k2" in args.only:
        res["k2"] = time_projection(True, args.repeats)
    if args.only is None or "k4f" in args.only:
        res["k4f"] = time_k4f(args.repeats)
    if args.only is None or "k8dw" in args.only:
        res["k8dw"] = time_k8dw(args.repeats)
    if args.only is None or "k1s32" in args.only:
        res["k1s32"] = time_projection(False, args.repeats, S32)
    if args.only is None or "k2s32" in args.only:
        res["k2s32"] = time_projection(True, args.repeats, S32)
    if args.only is None or "k5b" in args.only:
        res["k5b"] = time_k5b(args.repeats)
    if args.only is None or "k6" in args.only:
        res["k6"] = time_k6(args.repeats)
    if args.only is None or "k3" in args.only:
        res["k3"] = time_k3(args.repeats)
    if args.only is None or "k7" in args.only:
        res["k7"] = time_k7(args.repeats)
    for which in ("k6b", "k7b"):
        if args.only is None or which in args.only:
            res[which] = time_backward(which, args.repeats)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
