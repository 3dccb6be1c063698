#!/usr/bin/env python3
"""Times of K9 (folded affine + leaky ReLU + 3 × 3 conv), K5 forward
(texture sampler), K8 forward (the GAN head conv), K4 backward (the
rasterizer's gradient) and K1 and K2 (the projection forward and
backward) on one GPU, for the port found under ``--root``.

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

The timing helpers are ``tools/gpu_timing.py``'s, from this checkout
whatever the root.  Prints one JSON line ``{"root": ..., "gpu": ...,
"k9": [...], "k5": {...}, "k8": {...}, "k4b": {...}, "k1": {...},
"k2": {...}}`` as its last line.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/kernel_times.py [--root DIR] [--only k9 k5 k8 k4b k1 k2]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

from gpu_timing import (K9_PASS, events_ms, graph_ms, gpu_line, host_ms,
                        peak_mib, spread)

PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12
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


def _projection_operands(backward: bool) -> list:
    """K1's (or, with ``backward``, K2's) operands at ``chip_smoke.py``'s
    timed shapes, on the grid-coordinate planes."""
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
    C = cs.B * cs.V * (1 if backward else cs.K)
    rng = np.random.RandomState(3 if backward else 0)
    cloud = cs._clouds(rng, C, cs.N, dev)
    quats = qnormalize(torch.as_tensor(rng.randn(C, 4).astype(np.float32),
                                       device=dev))
    planes = world_to_camera_zyx(cloud, quats)
    scale = torch.as_tensor(rng.uniform(0.2, 1.5, C).astype(np.float32),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(1 if backward else 0)
    sigma, p = cs.K1_CASES[0]
    w = keep_mask(gen, C, cs.N, p)
    gz, gy, gx, c = _prep_projection(planes, cs.S, w, 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale, 21, C,
                               dev)
    ops = [gz, gy, gx, c, taps, sc]
    if backward:
        ops.append(torch.randn((C, cs.S, cs.S), device=dev, generator=gen))
    return [t.contiguous() for t in ops]


def time_projection(backward: bool, repeats: int) -> dict:
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.projection import (
        projection_backward_kernel,
        projection_kernel,
    )

    ops = _projection_operands(backward)
    if backward:
        def call():
            return projection_backward_kernel(*ops)
    else:
        def call():
            return projection_kernel(*ops, cs.S)
    res = _timed(call, repeats)
    res["peak_mib"] = peak_mib(call)
    res["clouds"] = ops[0].shape[0]
    tag = "K2" if backward else "K1"
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
             f"{res['dscale_bit_equal']}" if backward else ""), flush=True)
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
                    choices=("k9", "k5", "k8", "k4b", "k1", "k2"))
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
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
