#!/usr/bin/env python3
"""Times of K9 (folded affine + leaky ReLU + 3 × 3 conv) and K5 forward
(texture sampler) on one GPU, for the port found under ``--root``.

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
989 TFLOP/s, the larger) and cuDNN's pad + conv on the same operands.

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
each as min / median / max of ``--repeats`` repeats.  The timing helpers
are ``tools/gpu_timing.py``'s, from this checkout whatever the root.

Prints one JSON line ``{"root": ..., "gpu": ..., "k9": [...], "k5":
{...}}`` as its last line.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/kernel_times.py [--root DIR] [--only k9|k5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gpu_timing import (K9_PASS, events_ms, graph_ms, gpu_line, host_ms,
                        spread)

PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12
B_GAN = 32
# (name, (Cin, H, W, Cout), affine): the generator's 8 conv2s, then blk6's
# conv1
K9_SHAPES = tuple((name, shape, True) for name, shape in K9_PASS) + (
    ("blk6 conv1 (no affine)", (128, 512, 256, 64), False),)


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
        px = B_GAN * H * W
        nbytes = (x.numel() * 2 + wd.numel() * 2 + px * cout * 2
                  + (2 * a.numel() * 4 if affine else 0))
        ops = 2 * 9 * cin * cout * px
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        row = dict(name=name, shape=[B_GAN, cin, H, W, cout], affine=affine,
                   ms=ms, bound_ms=max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations",
                   cudnn_pad_conv_ms=conv_ms, weight_prep_ms=prep_ms)
        print(f"[K9] {name} {row['shape']}: {ms:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}), cuDNN pad + conv "
              f"{conv_ms:.4f}, bf16 weight cast + permute {prep_ms:.4f}",
              flush=True)
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
    ap.add_argument("--only", choices=("k9", "k5"))
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
    if args.only in (None, "k9"):
        res["k9"] = time_k9(args.k9_reps)
    if args.only in (None, "k5"):
        res["k5"] = time_k5(args.repeats)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
