#!/usr/bin/env python3
"""Where the time of a K4 backward or forward, a K8 forward or dW and the
projection's K1 and K2 goes on one GPU, by variant copies of their sources
and, for K1 and K2, by torch.profiler: the tiled K4 backward of commit
3892a42
(``csrc/rasterize.cu`` ``rasterize_bwd_kernel``: 32 x 8 pixel tiles, face
chunks, per-face sums by shuffles, shared and global atomics) and its K8
forward (``csrc/head_conv.cu`` ``head_conv_fwd_kernel``: float32 FMA
sums), or the tensor-core K8 forward that replaced it.

``--root`` names a checkout whose ``csrc/`` still holds those two kernels,
e.g. a ``git archive`` of commit 3892a42, or a checkout with the
tensor-core K8 forward (``head_conv_tc_kernel``), whose variants are
timed instead.  Each variant is that source with one part taken out by a
textual edit (the script stops if an edit's anchor is missing), compiled
alone with nvcc into a temporary directory and called through ctypes with
the operands the root's wrappers pass:

  K4 backward at ``chip_smoke.py``'s ``_cub_scene`` (50 x 256², 960 faces,
  A = 3, sigma 1e-4, back faces culled), random d feat and d soft:
    - ``parent``: as it is;
    - ``no_global_atomics``: the per-block global atomicAdd pass removed;
    - ``shuffles_only``: also the shared-memory atomicAdds (the warp sums
      stay, into a register);
    - ``no_reductions``: the per-face warp sums too (each lane adds its
      gradients into one register);
    - ``walk_only``: the per-face loop too: what is left is staging each
      chunk, the cull by warp 0 and the three barriers a chunk;
  K8 forward at the head's shape (32 x 64 x 512 x 256 bf16 -> 3,
  replicate):
    - ``parent``;
    - ``staging_only``: the 8-channel patch staged, the FMA loop skipped;
  the tensor-core K8 forward at that shape:
    - ``tc``: as it is;
    - ``tc_loads_only``: the products skipped (the boxes' ring, the
      epilogue's stores of tanh(bias));
    - ``tc_two_boxes``: a ring of two boxes instead of three.

K1 at ``chip_smoke.py`` phase 2's timed shape (480 x 8000 at 64³, sigma
3.0, keep-prob 0.07) and K2 at phase 3's first case (120 x 8000):
  - the root's wrapper under torch.profiler, 10 calls after a warm-up:
    the device time of each kernel and memset it launches (the chain of
    commit 0157045 is several; the cluster kernels are one);
  - where the root has the cluster kernels (``proj_fwd_kernel``), variant
    copies called with the plan the wrapper passes: K1 ``full``,
    ``no_rays`` (the ray pass replaced by a store of one value a thread)
    and ``splat_only`` (also without the Y and X blurs); K2 ``full``,
    ``no_gather`` (without the splat's transpose) and ``recompute_only``
    (the splat and Y/X blur alone); K1 ``passes_only`` keeps of
    ``splat_only`` the splat's passes without the points (the zeroed
    scratch, its conversion and the cluster barriers), ``passes_local``
    the same with block barriers in place of the cluster's, ``launch_only``
    one cluster barrier and a store, and ``rays_local`` is ``full`` with
    every ray reading the CTA's own planes for the other CTAs' (wrong
    values, the same work without distributed shared memory), and
    ``rank_order`` is ``full`` with every warp reading the owners in rank
    order.

K4 forward (``--only k4f``) at ``_cub_scene`` with the winner cache, back
faces culled: for a root with the tiled kernel of commit 1c94fd3
(``k4f_variants``: ``parent``, ``no_stores``, ``staging_only`` (the
chunks staged, no ballot), ``ballot_only`` (no per-pixel face loop),
``no_inside_branch``, ``no_segments``, ``no_soft``), for a root with the
binned kernel ``k4f_binned_variants``; and the pixel-face pairs the
tiles (or the binned kernel's 8 × 4 warps) visit against those in the
faces' widened boxes.

K8 dW (``--only k8dw``) for a root with the tensor-core dW
(``k8dw_variants``) at the head's shape, the upstream of ``chip_smoke.py``
phase 19.

K5 backward (``--only k5b``) for a root with the atomic kernel of commit
731de95 (``k5b_variants``: ``full``, ``no_atomics``, ``reads_only``,
``launch_only``, each part's cost the difference of two) or with the
register-window kernel (``k5b_run_variants``: ``full``, ``no_window``,
``no_atomics``, ``lb3``, ``spt8``, ``threads128``, each at runs of 8, 16,
32 and 64 samples) at
phase 12's
visibility shape (50 × 1024² rendered UVs into 128 × 130 × 3 textures, the
hard mask as the upstream, d texture only) and train shape (50 × 256², a
random upstream times the hard mask, d grid too), and the memset of d
texture that its wrapper makes.  K6 forward (``--only k6``) for a root
with the shared path (``k6_shared_variants``: ``full``, ``int_atomics``,
``no_splat``, ``no_reduce``): at the 3D IoU's shape at clusters of 1, 2,
4 and 8 CTAs a cloud, device time by CUDA graph.

K3 (``--only k3``) at ``chip_smoke.py`` phase 4's clouds, (24, 8000)
against (24, 512) and (24, 2048), in both roles: for a root with the
one-thread-a-point kernel of commit 063ad04 (``k3_variants``: ``full``,
``no_loads`` (the y point made from the loop index in registers: the
arithmetic alone), ``loads_only`` (the three shared loads a pair and
three mins)) each role's launch, its blocks and pairs a second, and a
launch at one pair; for a root with the pair kernel (``k3_pair_variants``:
``full``, ``no_rotate`` (the column minima not passed on: the
shuffles' cost), ``lb2``) the pair mode at the root's plan and with one
group of every y block a warp (``pair_one_group``: the fill of a layout
with a cluster a cloud that reduces the columns over distributed shared
memory), the rows-only mode in both roles, and the memset that the pair
mode's atomics need.  K7 forward
(``--only k7``) at phase 25's meshing shapes ((1, 8000) at 96³ and 128³,
sigma 1.5) and the chairs sweep's (480 × 8000 at 64³, keep-prob 0.07,
sigma 3.0): for a root with the atomic splat and plane blur of commit
063ad04 (``k7_variants``: ``full``, ``splat_only``, ``blur_only``), each
with and without the wrapper's memset of the grid, the memset alone and
the root's wrapper (events, device by CUDA graph, host); for a root with
the slab kernel (``k7_slab_variants``: ``full``, ``scan_only``,
``no_scan``, ``launch_only``, ``no_blur``, ``threads256``, ``run8``,
``list_unroll1``) the same shapes at the root's plan, and its wrapper.
K6 and K7 backward (``--only k6b|k7b``, ``time_bwd``) at ``_bwd_cases``
(K6 at phase 24's 120 × 8000 at 64³, keep-prob 0.07, and the IoU's
(24, 8000) at 32³; K7 at ``_k7_cases``): for a root with the three-launch
backward of commit e8c7a92 each launch alone (splat, blur transpose,
gather; K6's gather with and without dc), the wrapper's memset, and the
number format of a shared-memory splat (its K7 forward's adds as float,
as integer, or none: ``k7_number_variants``); for a root with the
one-launch tiles, ``bwd_slab_variants`` at the root's plan and the full
kernel at 1 to 16 planes a tile; the root's wrapper by CUDA graph and
events.

Each variant keeps a value that depends on the removed work's inputs, so
the compiler keeps the rest.  Times: CUDA events over ``--reps``
back-to-back launches of the entry point alone (no zeroing, no
allocation), median of 3.  Prints one JSON line as its last line.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/time_split.py --root build/parent
        [--only k4k8|k4f|k8dw|projection|k5b|k6|k3|k7|k6b|k7b]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

from gpu_timing import events_ms, gpu_line

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor found {src.count(old)} times: {old!r}")
    return src.replace(old, new)


def k4_variants(src: str) -> dict:
    """The backward kernel's variants (the forward stays as it is)."""
    head, rest = src.split("template <bool kCull>\n__global__ void "
                           "__launch_bounds__(kThreads)\n    "
                           "rasterize_bwd_kernel", 1)
    bwd, tail = rest.split("}  // namespace", 1)
    bwd = _edit(bwd, "  // this pixel's upstream gradients",
                "  float sink = 0.f;\n  // this pixel's upstream gradients")
    g0 = bwd.index("    // one global atomicAdd per block, face and "
                   "component")
    no_global = (bwd[:g0] + "  }\n  if (sink == 1.2345e-30f) dfv[0] = sink;"
                 "\n}\n\n")
    shuffles = _edit(no_global, "if (lane == 0 && t != 0.f) atomicAdd(sg + "
                     "k, t);", "sink += t;")
    shuffles = _edit(shuffles, "if (lane == 0 && t != 0.f) atomicAdd(sg + 6 "
                     "+ corner * A + a, t);", "sink += t;")
    s0 = no_global.index("      // per-face sums: warp shuffles, then "
                         "shared memory")
    s1 = no_global.index("    __syncthreads();\n  }\n  if (sink ==")
    no_red = (no_global[:s0]
              + "#pragma unroll\n      for (int k = 0; k < 6; ++k) sink += "
                "gv[k];\n#pragma unroll\n      for (int k = 0; k < 3 * kMaxA;"
                " ++k) sink += ga[k];\n    }\n" + no_global[s1:])
    walk = _edit(no_red, "    if (mask == 0u) continue;\n",
                 "    if (mask == 0u) continue;\n    sink += __popc(mask);\n"
                 "    if (sink > -1.f) continue;\n")
    pre = head + ("template <bool kCull>\n__global__ void __launch_bounds__"
                  "(kThreads)\n    rasterize_bwd_kernel")
    post = "}  // namespace" + tail
    return {name: pre + body + post for name, body in (
        ("parent", bwd), ("no_global_atomics", no_global),
        ("shuffles_only", shuffles), ("no_reductions", no_red),
        ("walk_only", walk))}


def k4f_variants(src: str) -> dict:
    """The tiled forward's variants (commit 1c94fd3's ``rasterize_fwd_kernel``:
    32 x 8 tiles, 32-face chunks staged with 3 barriers each, a ballot of
    the chunk's faces against the tile by warp 0); the backward stays."""
    head, rest = src.split("template <bool kCull>\n__global__ void "
                           "__launch_bounds__(kThreads)\n    "
                           "rasterize_fwd_kernel", 1)
    fwd, tail = rest.split("__device__ __forceinline__ float warp_sum", 1)
    store0 = "  if (row >= H || col >= W) return;\n"
    no_stores = _cut(fwd, store0, "}\n\n", (
        "  float sink = best_z + log_miss + static_cast<float>(best_word);\n"
        "#pragma unroll\n  for (int a = 0; a < kMaxA; ++a) sink += best[a];\n"
        "  if (sink == 1.2345e-30f) soft[0] = sink;\n"))
    ballot = ("    unsigned mask = s_mask;  // block-uniform\n"
              "    if (mask == 0u) continue;\n")
    ballot_only = _edit(fwd, ballot, ballot + "    log_miss += __popc(mask);\n"
                        "    if (log_miss > -1.f) continue;\n")
    staging_only = _cut(ballot_only, "    if (tid < kChunk) {\n",
                        "    __syncthreads();\n    unsigned mask",
                        "    if (tid == 0)\n      s_mask = s_v[0] + s_at[0] "
                        "== 1.2345e-30f ? 1u : 0u;\n")
    seg = ("        d2 = fminf(fminf(seg_dist2(px, py, x0, y0, x1, y1),\n"
           "                         seg_dist2(px, py, x1, y1, x2, y2)),\n"
           "                   seg_dist2(px, py, x2, y2, x0, y0));\n")
    no_segments = _edit(fwd, seg, "        d2 = __fmul_rn(__fsub_rn(px, x0), "
                        "__fsub_rn(py, y2));\n")
    soft_terms = ("      const float cov = expf(__fdiv_rn(-d2, sigma));\n"
                  "      log_miss = __fadd_rn(log_miss, "
                  "log1pf(-fminf(cov, kCovMax)));\n")
    no_soft = _edit(no_segments, soft_terms,
                    "      log_miss = __fadd_rn(log_miss, d2);\n")
    no_inside = _cut(fwd, "      if (inside) {\n        const float inv",
                     "      } else {\n        d2 = fminf(",
                     "      if (inside) {\n        cz = fmaxf(cz, e01);\n"
                     "        cnt += 1.f;\n")
    pre = head + ("template <bool kCull>\n__global__ void __launch_bounds__"
                  "(kThreads)\n    rasterize_fwd_kernel")
    post = "__device__ __forceinline__ float warp_sum" + tail
    return {name: pre + body + post for name, body in (
        ("parent", fwd), ("no_stores", no_stores),
        ("staging_only", staging_only), ("ballot_only", ballot_only),
        ("no_inside_branch", no_inside), ("no_segments", no_segments),
        ("no_soft", no_soft))}


def k8_variants(src: str) -> dict:
    staging = _edit(src, "#pragma unroll 2\n    for (int cc = 0; cc < F_CK; "
                    "++cc) {", "    acc[0][0] += xs[0][ty][tx];\n#pragma "
                    "unroll 2\n    for (int cc = 0; cc < (C < 0 ? F_CK : 0); "
                    "++cc) {")
    return {"parent": src, "staging_only": staging}


def k8_tc_variants(src: str) -> dict:
    """The bfloat16 tensor-core forward's variants."""
    call = "    tc_stage(acc, box, ws, chunk, nk, warp, lane);\n"
    ring = "constexpr int TC_NBUF = 3;"
    return {"tc": src, "tc_loads_only": _edit(src, call, ""),
            "tc_two_boxes": _edit(src, ring, "constexpr int TC_NBUF = 2;")}


def _edit_all(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"anchor not found: {old!r}")
    return src.replace(old, new)


def _cut(src: str, start: str, end: str, new: str) -> str:
    """``src`` with the text from ``start`` up to the first ``end`` after
    it (``end`` kept) replaced by ``new``."""
    if src.count(start) != 1:
        raise RuntimeError(f"anchor found {src.count(start)} times: "
                           f"{start!r}")
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + new + src[j:]


def projection_variants(src: str) -> tuple[dict, dict]:
    """The cluster kernels' variants: (K1's, K2's)."""
    no_rays = _cut(src, "  const int r0 = (rank + static_cast<int>(threadIdx.x)"
                   " / 32) % C;", "  cluster.sync();  // no CTA leaves",
                   "  if (threadIdx.x < S)\n    a.out[static_cast<size_t>(b) "
                   "* S * S + rank * S + threadIdx.x] =\n        "
                   "pl[threadIdx.x] * sc;\n")
    splat_only = _cut(no_rays, "  // clamp and Y blur: a thread a (plane, "
                      "x) column\n", "}\n\n// K1 along one ray", "")
    passes_only = _cut(splat_only, "    for (; i < a.N; i += stride) {",
                       "    cluster.sync();  // every corner of this pass",
                       "")
    passes_local = _edit(_edit(_edit(
        passes_only, "    cluster_arrive();  // this CTA's scratch",
        "    __syncthreads();  // this CTA's scratch"),
        "    cluster_wait();  // every CTA's scratch zeroed", ""),
        "    cluster.sync();  // every corner of this pass",
        "    __syncthreads();  // every corner of this pass")
    launch_only = _cut(src, "  float k[AK];\n  splat_and_blur_yx<false",
                       "  cluster.sync();  // no CTA leaves",
                       "  if (threadIdx.x == 0)\n    a.out[static_cast<size_t>"
                       "(b) * S * S + rank] = a.scale[b];\n")
    rays_local = _edit(src, "    float* col = cluster.map_shared_rank(pl, r) "
                       "+ y * SP + x;", "    float* col = pl + y * SP + x;")
    no_gather = _cut(src, "  // (d) the splat's transpose, gathered per "
                     "point", "  cluster.sync();  // no CTA leaves", "")
    recompute = _cut(src, "  // (b) per ray: the termination's VJP",
                     "  cluster.sync();  // no CTA leaves",
                     "  if (tid == 0) a.dscale[b] = pl[0];\n")
    rank_order = _edit(src, "  const int r0 = (rank + static_cast<int>("
                       "threadIdx.x) / 32) % C;", "  const int r0 = 0;")
    return ({"full": src, "no_rays": no_rays, "splat_only": splat_only,
             "passes_only": passes_only, "passes_local": passes_local,
             "launch_only": launch_only,
             "rays_local": rays_local, "rank_order": rank_order},
            {"full": src, "no_gather": no_gather,
             "recompute_only": recompute})


def _profiled(fn, iters: int = 10) -> list:
    """[(name, device us per call)] of the kernels and memsets that
    ``iters`` calls of ``fn`` run, by torch.profiler after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / iters)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda kv: -kv[1])


def time_projection(root: str, csrc: str, nvcc: str, tmp: str,
                    reps: int) -> dict:
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.projection import (
        projection_backward_kernel,
        projection_kernel,
    )
    from kernel_times import _projection_operands

    res = {}
    k1_ops = _projection_operands(False)
    k2_ops = _projection_operands(True)
    for tag, fn in (("k1", lambda: projection_kernel(*k1_ops, cs.S)),
                    ("k2", lambda: projection_backward_kernel(*k2_ops))):
        ops = _profiled(fn)
        ms = sorted(events_ms(fn, reps) for _ in range(3))[1]
        res[f"{tag}_wrapper_ms"] = ms
        res[f"{tag}_profile_us"] = ops
        print(f"[{tag.upper()}] wrapper {ms:.4f} ms by events; device time "
              f"per call by torch.profiler, {sum(u for _, u in ops):.1f} us "
              f"in all:", flush=True)
        for name, us in ops:
            print(f"    {us:9.1f} us  {name[:100]}", flush=True)
    with open(os.path.join(csrc, "projection.cu")) as fh:
        src = fh.read()
    if "proj_fwd_kernel" not in src:
        return res
    from im23d_tpu_torch.ops.projection import (
        projection_limits,
        projection_plan,
    )

    v1, v2 = projection_variants(src)
    libs = build({f"k1_{k}": v for k, v in v1.items()}
                 | {f"k2_{k}": v for k, v in v2.items()}, tmp, nvcc, csrc)
    dev = torch.device("cuda")
    plan = projection_plan(cs.S, 21, projection_limits(dev))
    P, I, F, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
    stream = torch.cuda.current_stream().cuda_stream
    for tag, ops in (("k1", k1_ops), ("k2", k2_ops)):
        B, N = ops[0].shape
        outs = ([torch.empty((B, cs.S, cs.S), device=dev)] if tag == "k1"
                else [torch.empty((B,), device=dev)]
                + [torch.empty((B, N), device=dev) for _ in range(3)])
        ptrs = [t.data_ptr() for t in ops] + [t.data_ptr() for t in outs]
        ptrs.insert(5, ops[4].numel())  # K after the taps
        tail = [B, N, cs.S, 1e-5, plan["cluster"], plan["planes"],
                plan["stage"], plan["smem_fwd" if tag == "k1" else "smem_bwd"],
                stream]
        for name, lib in libs.items():
            if not name.startswith(tag):
                continue
            fn = getattr(lib, "im23d_projection_fwd" if tag == "k1"
                         else "im23d_projection_bwd")
            fn.argtypes = ([P] * 5 + [I] + [P] * (len(ptrs) - 6)
                           + [I, I, I, F, I, I, I, L, P])
            fn.restype = ctypes.c_int

            def call(fn=fn, name=name):
                rc = fn(*ptrs, *tail)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            ms = sorted(events_ms(call, reps) for _ in range(3))[1]
            res[name] = ms
            print(f"[{tag.upper()}] {name[3:]}: {ms:.4f} ms", flush=True)
    return res


def build(variants: dict, tmp: str, nvcc: str, csrc: str) -> dict:
    """One nvcc per variant, all started together; name -> ctypes.CDLL."""
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *FLAGS, "-I", csrc, "-o", cu[:-3] + ".so", cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc {name}: {out}")
        libs[name] = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
    return libs


def time_k4k8(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.rasterizer import _launch_forward, soft_margin

    with open(os.path.join(csrc, "head_conv.cu")) as fh:
        k8_src = fh.read()
    new = "head_conv_tc_kernel" in k8_src  # the tensor-core forward
    k4 = {}
    if not new:
        with open(os.path.join(csrc, "rasterize.cu")) as fh:
            k4 = k4_variants(fh.read())
    k8 = k8_tc_variants(k8_src) if new else k8_variants(k8_src)
    res = dict(k4_backward={}, k8_forward={})
    P = ctypes.c_void_p
    stream = P(torch.cuda.current_stream().cuda_stream)
    libs4 = build({f"k4_{k}": v for k, v in k4.items()}, tmp, nvcc, csrc)
    libs8 = build({f"k8_{k}": v for k, v in k8.items()}, tmp, nvcc, csrc)

    dev = torch.device("cuda")
    verts, faces, attrs, _ = cs._cub_scene(
        MeshTemplate(segments=32, rings=16), dev)
    fv = verts[:, faces].contiguous()
    attrs = attrs.contiguous()
    B, F = fv.shape[:2]
    A, R = attrs.shape[-1], cs.RES
    _, soft, win, wz = _launch_forward(fv, attrs, R, R, cs.SIGMA, True, True)
    gen = torch.Generator(device=dev).manual_seed(16)
    dfeat = torch.randn((B, R, R, A), device=dev, generator=gen)
    dsoft = torch.randn((B, R, R, 1), device=dev, generator=gen)
    dfv, dat = torch.zeros_like(fv), torch.zeros_like(attrs)
    s = float(np.float32(2.0 / R))
    for name, lib in libs4.items():
        fn = lib.im23d_rasterize_bwd
        fn.argtypes = [P] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 \
            + [ctypes.c_int, P]
        ptrs = [t.data_ptr() for t in (fv, attrs, dfeat, dsoft, soft, win,
                                      wz, dfv, dat)]

        def call(fn=fn, ptrs=ptrs, name=name):
            rc = fn(*ptrs, B, F, A, R, R, s, s, cs.SIGMA,
                    soft_margin(cs.SIGMA), 1, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = sorted(events_ms(call, reps) for _ in range(3))[1]
        res["k4_backward"][name[3:]] = ms
        print(f"[K4 bwd] {name[3:]}: {ms:.4f} ms", flush=True)

    x, w, b = cs._head_operands(torch.bfloat16, 20)
    y = torch.empty((x.shape[0], 3, *x.shape[2:]), dtype=x.dtype,
                    device=dev)
    for name, lib in libs8.items():
        fn = lib.im23d_head_conv_fwd_bf16 if new else lib.im23d_head_conv_fwd
        fn.argtypes = [P] * 4 + [ctypes.c_int] * (5 if new else 6) + [P]
        ptrs = [t.data_ptr() for t in (x, w, b, y)]
        flags = (0,) if new else (0, 1)  # replicate (, bf16)

        def call(fn=fn, ptrs=ptrs, flags=flags, name=name):
            rc = fn(*ptrs, *x.shape, *flags, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = sorted(events_ms(call, reps) for _ in range(3))[1]
        res["k8_forward"][name[3:]] = ms
        print(f"[K8 fwd] {name[3:]}: {ms:.4f} ms", flush=True)
    return res


def k4f_binned_variants(src: str) -> dict:
    """The binned forward's variants (``raster_binned_kernel``; the set-up
    pass stays): ``no_segments`` (a product for the three segment
    distances), ``no_soft`` (also no exp and log1p), ``walk_only`` (the bins
    walked and the records staged, no pixel-face work), ``no_stores`` and
    ``setup_only`` (the set-up pass alone)."""
    soft = ("        const float cov = expf(__fmul_rn(d2, nis));\n"
            "        log_miss = __fadd_rn(log_miss, "
            "log1pf(-fminf(cov, kCovMax)));\n")
    seg = _cut(src, "          d2 = fminf(fminf(seg_dist2_v(",
               "        }\n        const float cov",
               "          d2 = __fmul_rn(__fsub_rn(px, x0), "
               "__fsub_rn(py, y2));\n")
    no_soft = _edit(seg, soft, "        log_miss = __fadd_rn(log_miss, d2);\n")
    walk = _cut(src, "        const float4 v01 = r[0], v2",
                "      }\n      if (cz > best_z)",
                "        log_miss += bx.x;\n")
    no_stores = _cut(src, "  if (!valid) return;\n", "}\n\n", (
        "  float sink = best_z + log_miss + static_cast<float>(best_word);\n"
        "#pragma unroll\n  for (int a = 0; a < kA; ++a) sink += best[a];\n"
        "  if (sink == 1.2345e-30f) soft[0] = sink;\n"))
    setup_only = _cut(src, "  kernel<<<dim3(tiles, B), kBinThreads",
                      "  return cudaGetLastError();", "")
    return {"full": src, "no_segments": seg, "no_soft": no_soft,
            "walk_only": walk, "no_stores": no_stores,
            "setup_only": setup_only}


def k8dw_variants(src: str) -> dict:
    """The tensor-core dW's variants: ``full``; ``loads_only`` without the
    consumers' fragments and products (the copier and fixer warps, the
    mbarriers, the partial rows and the ordered sum stay); ``compute_only``
    without the x rows' copies and the waits on them (the products run on
    whatever the ring holds)."""
    loads = _cut(src, "    uint32_t fa0[4], fb0[KS][4], fa1[4], fb1[KS][4];",
                 "    // release the g row and the x rows the next task",
                 "    acc[0][0][0] += __int_as_float(gs[a0_off]) + "
                 "static_cast<float>(nint);\n")
    compute = _edit(_edit(_edit(_edit(
        src, "          mbar_expect_tx(&full[s], DW_ROWB);\n", ""),
        "          tma_load(box, &xmap, &full[s], ic.tile * DW_TW - DW_OFF, "
        "ic.r, 0,\n                   ic.b);\n", ""),
        "      if (kVec) {\n        dw_wait(&full[s], n / DW_NS);\n",
        "      if (kVec) {\n"),
        "    dw_wait(&full[n % DW_NS], n / DW_NS);\n", "")
    return {"full": src, "loads_only": loads, "compute_only": compute}


def time_k8dw(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    """The tensor-core dW's variants at the head's shape (32 x 64 x 512 x
    256 bf16, replicate), the upstream of ``chip_smoke.py`` phase 19."""
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.conv import head_conv_kernel

    with open(os.path.join(csrc, "head_conv.cu")) as fh:
        src = fh.read()
    if "head_conv_dw_tc_kernel" not in src:
        raise RuntimeError("the root's K8 dW is not the tensor-core kernel")
    libs = build({f"k8dw_{k}": v for k, v in k8dw_variants(src).items()},
                 tmp, nvcc, csrc)
    x, w, b = cs._head_operands(torch.bfloat16, 21)
    gen = torch.Generator(device="cuda").manual_seed(22)
    y = head_conv_kernel(x, w, b).float()
    g = (torch.randn(y.shape, device="cuda", generator=gen)
         * (1.0 - y * y)).contiguous()
    del y
    nrows = torch.cuda.get_device_properties(0).multi_processor_count
    partial = torch.empty((nrows, w.numel()), device="cuda")
    dw = torch.empty_like(w)
    P = ctypes.c_void_p
    stream = P(torch.cuda.current_stream().cuda_stream)
    ptrs = [t.data_ptr() for t in (x, g, partial, dw)]
    res = dict(k8_dw={})
    for name, lib in libs.items():
        fn = lib.im23d_head_conv_dw
        fn.argtypes = [P] * 4 + [ctypes.c_int] * 7 + [P]

        def call(fn=fn, name=name):
            rc = fn(*ptrs, *x.shape, 0, 1, nrows, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = sorted(events_ms(call, reps) for _ in range(3))[1]
        res["k8_dw"][name[5:]] = ms
        print(f"[K8 dW] {name[5:]}: {ms:.4f} ms", flush=True)
    return res


def tile_face_pairs(fv, height: int, width: int, sigma: float,
                    tile_w: int, tile_h: int) -> int:
    """Pixel-face pairs that a tiled forward visits: for every tile of
    ``tile_w`` x ``tile_h`` pixels, the pixels of the tile times the drawn
    (front-facing) faces whose box widened by ``soft_margin(sigma)``
    reaches the tile's pixel centres, the test of the tiled kernel's
    ballot."""
    import torch

    from im23d_tpu_torch.render.rasterizer import soft_margin

    x, y = fv[..., 0], fv[..., 1]  # (B, F, 3)
    area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
            - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    m = soft_margin(sigma)
    lo_x, hi_x = x.amin(-1) - m, x.amax(-1) + m
    lo_y, hi_y = y.amin(-1) - m, y.amax(-1) + m
    sx, sy = 2.0 / width, 2.0 / height
    c0 = torch.arange(0, width, tile_w, device=fv.device, dtype=x.dtype)
    r0 = torch.arange(0, height, tile_h, device=fv.device, dtype=x.dtype)
    tx0, tx1 = (c0 + 0.5) * sx - 1, (c0 + tile_w - 0.5) * sx - 1
    ty1, ty0 = 1 - (r0 + 0.5) * sy, 1 - (r0 + tile_h - 0.5) * sy
    hit_x = (lo_x[..., None] <= tx1) & (hi_x[..., None] >= tx0)  # (B, F, X)
    hit_y = (lo_y[..., None] <= ty1) & (hi_y[..., None] >= ty0)  # (B, F, Y)
    drawn = (area > 1e-9).to(x.dtype)
    n = torch.einsum("bf,bfx,bfy->", drawn, hit_x.to(x.dtype),
                     hit_y.to(x.dtype))
    return int(n) * tile_w * tile_h


def time_k4f(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    """K4 forward's variants at ``_cub_scene``, back faces culled, with the
    winner cache (the recon train step's launch)."""
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.rasterizer import soft_margin

    with open(os.path.join(csrc, "rasterize.cu")) as fh:
        src = fh.read()
    binned = "raster_binned_kernel" in src
    variants = k4f_binned_variants(src) if binned else k4f_variants(src)
    libs = build({f"k4f_{k}": v for k, v in variants.items()}, tmp, nvcc,
                 csrc)
    dev = torch.device("cuda")
    verts, faces, attrs, _ = cs._cub_scene(
        MeshTemplate(segments=32, rings=16), dev)
    fv = verts[:, faces].contiguous()
    attrs = attrs.contiguous()
    B, F = fv.shape[:2]
    A, R = attrs.shape[-1], cs.RES
    feat = torch.empty((B, R, R, A), device=dev)
    soft = torch.empty((B, R, R, 1), device=dev)
    win = torch.empty((B, R, R), dtype=torch.int32, device=dev)
    wz = torch.empty((B, R, R), device=dev)
    P = ctypes.c_void_p
    stream = P(torch.cuda.current_stream().cuda_stream)
    s = float(np.float32(2.0 / R))
    res = dict(k4_forward={})
    ptrs = [t.data_ptr() for t in (fv, attrs, feat, soft, win, wz)]
    ints = [B, F, A, R, R]
    if binned:  # the set-up pass's scratch and the bin tile
        from im23d_tpu_torch.render.rasterizer import _RECORD, BIN_TILE

        recs = torch.empty((B, F, _RECORD), device=dev)
        bins = torch.empty((B, (-(-R // BIN_TILE)) ** 2, -(-F // 32)),
                           dtype=torch.int32, device=dev)
        ptrs += [recs.data_ptr(), bins.data_ptr()]
        ints += [BIN_TILE, BIN_TILE]
    for name, lib in libs.items():
        fn = lib.im23d_rasterize_fwd
        fn.argtypes = [P] * len(ptrs) + [ctypes.c_int] * len(ints) \
            + [ctypes.c_float] * 4 + [ctypes.c_int, P]

        def call(fn=fn, name=name):
            rc = fn(*ptrs, *ints, s, s, cs.SIGMA, soft_margin(cs.SIGMA), 1,
                    stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = sorted(events_ms(call, reps) for _ in range(3))[1]
        res["k4_forward"][name[4:]] = ms
        print(f"[K4 fwd] {name[4:]}: {ms:.4f} ms", flush=True)
    tw, th = (8, 4) if binned else (32, 8)
    tiled = tile_face_pairs(fv, R, R, cs.SIGMA, tw, th)
    bound = cs._raster_pairs(verts, faces, R, R, cs.SIGMA)
    res.update(tiled_pairs=tiled, box_pairs=bound)
    print(f"[K4 fwd] pixel-face pairs: the {tw} x {th} "
          f"{'warps' if binned else 'tiles'} visit {tiled}, the faces' "
          f"widened boxes hold {bound} ({tiled / max(bound, 1):.2f}x)",
          flush=True)
    return res


def k5b_variants(src: str) -> dict:
    """The atomic K5 backward's strip-down (``grid_sample_bwd_kernel``):
    ``full``; ``no_atomics`` (each d img atomicAdd replaced by a store that
    a product never takes); ``reads_only`` (also no corner arithmetic: the
    grid and upstream read and summed into a sink); ``launch_only`` (also
    no reads: the same grid of blocks, each thread storing nothing)."""
    no_atomics = _edit(src, "if (v != 0.f) atomicAdd(d + c, v);",
                       "if (v == 1.2345e-30f) d[c] = v;")
    body = "  const int b = static_cast<int>(i / P);\n  const Bilinear t"
    reads = _cut(src, body, "}\n\n}  // namespace",
                 "  float s = grid[2 * i] + grid[2 * i + 1];\n"
                 "  for (int c = 0; c < C; ++c) s += dout[i * C + c];\n"
                 "  if (s == 1.2345e-30f) dimg[0] = s;\n")
    launch = _cut(src, body, "}\n\n}  // namespace",
                  "  if (i == -1) dimg[0] = 0.f;\n")
    return {"full": src, "no_atomics": no_atomics, "reads_only": reads,
            "launch_only": launch}


def k5b_run_variants(src: str) -> dict:
    """The register-window K5 backward's variants (``grid_sample_bwd_run_
    kernel``): ``full``; ``no_window`` (every change of corner cell adds
    all four texels, none kept); ``no_atomics`` (the adds replaced by a
    store that a sum never takes); ``lb3`` (at most 85 registers a
    thread, three blocks a multiprocessor); ``spt8`` (8 samples read at
    once instead of 4); ``threads128`` (blocks of 128 threads instead of
    256)."""
    return {
        "full": src,
        "no_window": _edit(_edit(
            src, "  const bool right = ny == cy && nx == __fadd_rn(cx, 1.f);",
            "  const bool right = false, left = false, down = false, up = "
            "false;\n  if (false) {"),
            "  const bool up = nx == cx && ny == __fsub_rn(cy, 1.f);\n",
            "  }\n"),
        "no_atomics": _edit(
            src, "    if (a[c] != 0.f) atomicAdd(d + c, a[c]);",
            "    if (a[c] == 1.2345e-30f) d[c] = a[c];"),
        "lb3": _edit(src, "__global__ void __launch_bounds__(kRunThreads)\n"
                     "    grid_sample_bwd_run_kernel",
                     "__global__ void __launch_bounds__(kRunThreads, 3)\n"
                     "    grid_sample_bwd_run_kernel"),
        "spt8": _edit(src, "constexpr int kRunSpt = 4; ",
                      "constexpr int kRunSpt = 8; "),
        "threads128": _edit(src, "constexpr int kRunThreads = 256; ",
                            "constexpr int kRunThreads = 128; "),
    }


def time_k5b(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    """The K5 backward's variants at both of ``chip_smoke.py`` phase 12's
    shapes (``kernel_times._k5b_operands``): the atomic kernel's
    (``k5b_variants``) and the memset of d img that its wrapper makes, or
    the register-window kernel's (``k5b_run_variants``)."""
    import torch

    from kernel_times import _k5b_operands

    with open(os.path.join(csrc, "grid_sample.cu")) as fh:
        src = fh.read()
    runs = "grid_sample_bwd_run_kernel" in src
    variants = k5b_run_variants(src) if runs else k5b_variants(src)
    libs = build({f"k5b_{k}": v for k, v in variants.items()}, tmp, nvcc,
                 csrc)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = P(torch.cuda.current_stream().cuda_stream)
    res = {}
    for shape, (img, grid, dout, need_grid) in _k5b_operands().items():
        dimg = torch.zeros_like(img)
        dgrid = torch.empty_like(grid) if need_grid else None
        ptrs = [img.data_ptr(), grid.data_ptr(), dout.data_ptr(),
                dimg.data_ptr(), dgrid.data_ptr() if need_grid else None]
        ints = [*img.shape, grid[0, ..., 0].numel()]
        r = {"memset": sorted(events_ms(dimg.zero_, reps)
                              for _ in range(3))[1]}
        for name, lib in libs.items():
            fn = lib.im23d_grid_sample_bwd
            fn.argtypes = [P] * 5 + [I] * (len(ints) + runs) + [P]
            for run in (8, 16, 32, 64) if runs else (None,):
                tail = [run] if runs else []

                def call(fn=fn, name=name, tail=tail):
                    rc = fn(*ptrs, *ints, *tail, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                tag = name[4:] + (f"_run{run}" if runs else "")
                r[tag] = sorted(events_ms(call, reps) for _ in range(3))[1]
        res[shape] = r
        for k, ms in r.items():
            print(f"[K5 bwd] {shape} {k}: {ms:.4f} ms", flush=True)
    return res


def k6_shared_variants(src: str) -> dict:
    """The shared K6 forward's variants: ``full``; ``int_atomics`` (the
    adds as integer atomicAdds on the same bits: wrong sums, the cost of a
    native shared atomic against the float add's compare-and-swap loop);
    ``no_splat`` (the points read, none added); ``no_reduce`` (also no sum
    over the copies: the cluster barriers, the zeroed copies and the
    launch)."""
    add = "      if (v[q] != 0.f) atomicAdd(g + idx[q], v[q]);"
    no_splat = _edit(src, add, "      if (v[q] == 1.2345e-30f) g[idx[q]] = "
                     "v[q];")
    return {
        "full": src,
        "int_atomics": _edit(src, add, "      if (v[q] != 0.f)\n"
                             "        atomicAdd(reinterpret_cast<unsigned*>("
                             "g + idx[q]), __float_as_uint(v[q]));"),
        "no_splat": no_splat,
        "no_reduce": _cut(no_splat,
                          "  float* o = out + static_cast<size_t>(b) * n;",
                          "  cluster.sync();  // no CTA leaves",
                          "  if (threadIdx.x == 0 && g[0] == 1.2345e-30f) "
                          "out[0] = g[0];\n"),
    }


def time_k6(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    """K6 forward's shared path and its variants (``k6_shared_variants``)
    at the 3D IoU's shape ((24, 8000) at 32³, ``chip_smoke.py`` phase 24's
    clouds) at clusters of 1, 2, 4 and 8 CTAs a cloud: device time (a CUDA
    graph of ``reps`` launches) and, for ``full``, event time."""
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from gpu_timing import graph_ms
    from im23d_tpu_torch.ops.splat import _prep_splat

    with open(os.path.join(csrc, "splat.cu")) as fh:
        src = fh.read()
    libs = build({f"k6_{k}": v for k, v in k6_shared_variants(src).items()},
                 tmp, nvcc, csrc)
    dev = torch.device("cuda")
    pts = cs._clouds(np.random.RandomState(7), cs.B, cs.N, dev)
    S = cs.IOU_S
    ops = _prep_splat(pts, S, None, 1e-6)
    ptrs = [t.data_ptr() for t in ops]
    out = torch.empty((cs.B, S, S, S), device=dev)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    res = {}
    for name, lib in libs.items():
        fn = lib.im23d_splat_fwd
        fn.argtypes = [P] * 5 + [I] * 4 + [L, P]
        for k in (1, 2, 4, 8):
            def call(fn=fn, k=k):
                rc = fn(*ptrs, out.data_ptr(), cs.B, cs.N, S, k, S ** 3 * 4,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"K6 at cluster {k}: CUDA error {rc}")

            tag = f"{name[3:]}_cluster{k}"
            res[tag] = sorted(graph_ms(call, reps) for _ in range(3))[1]
            if name == "k6_full":
                res[tag + "_events"] = sorted(events_ms(call, reps)
                                              for _ in range(3))[1]
            print(f"[K6] iou {tag}: {res[tag]:.4f} ms device", flush=True)
    return res


def k3_variants(src: str) -> dict:
    """The one-thread-a-point K3's variants: ``full``; ``no_loads`` (the y
    point made from the loop index in registers); ``loads_only`` (the
    three shared loads and three mins a pair)."""
    pair = ("      const float dz = sz[j] - xz, dy = sy[j] - xy, dx = sx[j] - xx;\n"
            "      best = fminf(best, dz * dz + dy * dy + dx * dx);")
    return {
        "full": src,
        "no_loads": _edit(src, pair, (
            "      const float fj = static_cast<float>(j);\n"
            "      const float dz = fj - xz, dy = fj * 0.5f - xy,"
            " dx = fj * 0.25f - xx;\n"
            "      best = fminf(best, dz * dz + dy * dy + dx * dx);")),
        "loads_only": _edit(src, pair, (
            "      best = fminf(best, fminf(sz[j], fminf(sy[j], sx[j])));")),
    }


def k3_pair_variants(src: str) -> dict:
    """The pair K3's variants: ``full``; ``no_rotate`` (the column minima
    not passed on between lanes: wrong columns, the shuffles' cost);
    ``lb2`` (launch bounds of 2 CTAs a multiprocessor: more registers)."""
    rotate = "        acc[t] = __shfl_sync(kFull, acc[t], (lane + 1) & 31);"
    return {"full": src,
            "no_rotate": _edit(src, rotate, "        acc[t] = acc[t] | 1;"),
            "lb2": _edit(src, "__launch_bounds__(32 * kWarps, 3)",
                         "__launch_bounds__(32 * kWarps, 2)")}


def _k3_clouds() -> dict:
    """``chip_smoke.py`` phase 4's clouds: x (24, 8000), then y (24, 2048)
    and (24, 512) from the same generator."""
    import numpy as np

    import chip_smoke as cs  # the root's
    import torch

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    x = cs._clouds(rng, cs.B, cs.N, dev)
    return {m: (x, cs._clouds(rng, cs.B, m, dev)) for m in (cs.GT_POINTS,
                                                          cs.GT_POINTS_CLI)}


def time_k3(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    """K3's split (``k3_variants`` or ``k3_pair_variants``, as the root
    has), device time by CUDA graph and event time, medians of 3."""
    import torch

    from gpu_timing import graph_ms

    with open(os.path.join(csrc, "nn_dist2.cu")) as fh:
        src = fh.read()
    pair = "im23d_chamfer" in src
    variants = k3_pair_variants(src) if pair else k3_variants(src)
    libs = build({f"k3_{k}": v for k, v in variants.items()}, tmp, nvcc,
                 csrc)
    P, I = ctypes.c_void_p, ctypes.c_int
    res = {}

    def med(fn, timer):
        return sorted(timer(fn, reps) for _ in range(3))[1]

    for m, (x, y) in _k3_clouds().items():
        B, N = x.shape[:2]
        rows = torch.empty((B, N), device=x.device)
        cols = torch.empty((B, m), device=x.device)
        r = {}
        for name, lib in libs.items():
            if pair:
                from im23d_tpu_torch.metrics.chamfer import (chamfer_limits,
                                                             chamfer_plan)

                fn = lib.im23d_chamfer
                fn.argtypes = [P] * 4 + [I] * 4 + [P]
                lim = chamfer_limits(x.device)
                cases = []
                for tag, a, b, out2 in (("pair", x, y, cols),
                                        ("rows_pred_gt", x, y, None),
                                        ("rows_gt_pred", y, x, None)):
                    plan = chamfer_plan(B, a.shape[1], b.shape[1], lim)
                    out1 = torch.empty((B, a.shape[1]), device=x.device)
                    cases.append((tag, a, b, out1, out2, plan))
                    r[f"{tag}_plan"] = plan
                # the pair as one group of every y block a warp: the fill
                # of a cluster a (cloud, all columns) layout
                one = dict(cases[0][5], ny=-(-m // lim.cols))
                cases.append(("pair_one_group", x, y, cases[0][3], cols,
                              one))
            else:
                fn = lib.im23d_nn_dist2
                fn.argtypes = [P] * 3 + [I] * 3 + [P]
                cases = [("pred_gt", x, y, rows, None, None),
                         ("gt_pred", y, x, cols, None, None)]
                r["pred_gt_blocks"] = -(-N // 256) * B
                r["gt_pred_blocks"] = -(-m // 256) * B
            for tag, a, b, out1, out2, plan in cases:
                def call(fn=fn, a=a, b=b, out1=out1, out2=out2, plan=plan):
                    args = [a.data_ptr(), b.data_ptr(), out1.data_ptr()]
                    if pair:
                        args += [None if out2 is None else out2.data_ptr(),
                                 B, a.shape[1], b.shape[1], plan["ny"]]
                    else:
                        args += [B, a.shape[1], b.shape[1]]
                    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"K3 {tag}: CUDA error {rc}")

                key = f"{name[3:]}_{tag}"
                r[key] = med(call, graph_ms)
                r[key + "_events"] = med(call, events_ms)
                r[key + "_gpairs_per_s"] = B * a.shape[1] * b.shape[1] / (
                    r[key] * 1e6)
        if pair:
            both = torch.empty(B * (N + m), device=x.device)
            r["memset"] = med(lambda: both.fill_(float("nan")), graph_ms)
        else:
            one = libs["k3_full"].im23d_nn_dist2
            ones = [torch.zeros((1, 1, 3), device=x.device) for _ in range(3)]

            def tiny():
                one(ones[0].data_ptr(), ones[1].data_ptr(),
                    ones[2].data_ptr(), 1, 1, 1,
                    torch.cuda.current_stream().cuda_stream)

            r["launch_one_pair"] = med(tiny, graph_ms)
        res[f"m{m}"] = r
        for k, v in r.items():
            print(f"[K3] m={m} {k}: {v}", flush=True)
    return res


def k7_variants(src: str) -> dict:
    """The atomic splat + plane blur K7 forward's variants: ``full``;
    ``splat_only`` (the blur launch removed); ``blur_only`` (the splat
    launch removed)."""
    splat = ("  const int err = splat_launch(static_cast<const float*>(gz),\n"
             "                               static_cast<const float*>(gy),\n"
             "                               static_cast<const float*>(gx),\n"
             "                               static_cast<const float*>(c), o,"
             " B, N, S, st);\n")
    blur = ("  return blur_yx_launch<false>(o, o, nullptr, "
            "static_cast<const float*>(taps),\n"
            "                               K, B, S, st);\n")
    return {"full": src,
            "splat_only": _edit(src, blur, "  return cudaSuccess;\n"),
            "blur_only": _edit(src, splat,
                               "  const int err = cudaSuccess;\n")}


def k7_slab_variants(src: str) -> dict:
    """The slab K7 forward's variants: ``full``; ``scan_only`` (the
    points read, tested and listed, no adds); ``no_scan`` (no points: the
    zeroed planes blurred and written); ``launch_only`` (the planes zeroed,
    nothing written); ``no_blur`` (the windows read, each output one value
    of its window, no taps); ``threads256``, ``run8`` and
    ``list_unroll1`` (256 threads a CTA; 8 outputs a window; one listed
    point a thread at once)."""
    add = ("        if (zl < static_cast<unsigned>(np) && v[q] != 0.f)\n")
    scan = _edit(src, add, "        if (zl < static_cast<unsigned>(np) && "
                 "v[q] == 1.2345e-30f)\n")
    taps = "      if (j - r >= 0 && j - r < KT) acc[r] += k[j - r] * v;\n"
    zeroed = "  __syncthreads();  // the planes zeroed\n"
    return {"full": src, "scan_only": scan,
            "no_scan": _edit(src, "for (int c0 = 0; c0 < N; c0 += chunk)",
                             "for (int c0 = 0; c0 < N - N; c0 += chunk)"),
            "launch_only": _edit(src, zeroed, zeroed + "  if (N >= 0) "
                                 "return;\n"),
            "no_blur": _edit(src, taps, "      if (j == r) acc[r] += v;\n"),
            "threads256": _edit(src, "constexpr int kSlabThreads = 512;",
                                "constexpr int kSlabThreads = 256;"),
            "run8": _edit(src, "constexpr int kRun = 16;",
                          "constexpr int kRun = 8;"),
            "list_unroll1": _edit(src, "constexpr int kListUnroll = 4;",
                                  "constexpr int kListUnroll = 1;")}


def _k7_cases() -> list:
    """(tag, grid-coordinate planes and weights, taps, S) of phase 25's
    meshing shapes and the sweep at sigma 3.0."""
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.pointcloud import keep_mask
    from im23d_tpu_torch.ops.projection import _taps_and_scale
    from im23d_tpu_torch.ops.splat import _prep_splat

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    sweep = cs._sweep_points(9, cs.B * cs.V * cs.K, dev)
    sweep_w = keep_mask(gen, cs.B * cs.V * cs.K, cs.N, 0.07)
    cloud = cs._clouds(np.random.RandomState(10), 1, cs.N, dev)
    cases = []
    for tag, pts, w, size, sigma in (
            ("mesh96", cloud, None, cs.MESH_S, cs.MESH_SIGMA),
            ("mesh128", cloud, None, 128, cs.MESH_SIGMA),
            ("sweep", sweep, sweep_w, cs.S, 3.0)):
        ops = _prep_splat(pts, size, w, 1e-6)
        taps, _ = _taps_and_scale(torch.tensor(sigma, device=dev), 1.0, 21,
                                  pts.shape[0], dev)
        cases.append((tag, ops, taps.contiguous(), size))
    return cases


def time_k7(root: str, csrc: str, nvcc: str, tmp: str, reps: int) -> dict:
    """K7 forward's split (``k7_variants`` or ``k7_slab_variants``, as the
    root has) and the root's wrapper: device time by CUDA graph, event
    time and the wrapper's host time, medians of 3."""
    import torch

    from gpu_timing import graph_ms, host_ms
    from im23d_tpu_torch.ops import splat

    with open(os.path.join(csrc, "splat.cu")) as fh:
        src = fh.read()
    slab = "splat_blur_slab_kernel" in src
    variants = k7_slab_variants(src) if slab else k7_variants(src)
    libs = build({f"k7_{k}": v for k, v in variants.items()}, tmp, nvcc,
                 csrc)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    res = {}

    def med(fn, timer):
        return sorted(timer(fn, reps) for _ in range(3))[1]

    for tag, (gz, gy, gx, c), taps, S in _k7_cases():
        B, N = gz.shape
        out = torch.empty((B, S, S, S), device=gz.device)
        ptrs = [t.data_ptr() for t in (gz, gy, gx, c, taps)]
        r = {"memset": med(out.zero_, graph_ms)}
        if slab:
            plan = splat.splat_blur_plan(B, S, taps.numel(),
                                         splat.splat_blur_limits(gz.device))
            r["plan"] = plan
        for name, lib in libs.items():
            fn = lib.im23d_splat_blur_fwd
            if slab:
                fn.argtypes = [P] * 5 + [I, P] + [I] * 5 + [L, P]
                tail = [plan["planes"], plan["stride"], plan["smem"]]
            else:
                fn.argtypes = [P] * 5 + [I, P] + [I] * 3 + [P]
                tail = []

            def call(fn=fn, tail=tail, name=name):
                rc = fn(*ptrs, taps.numel(), out.data_ptr(), B, N, S, *tail,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"K7 {name}: CUDA error {rc}")

            def zeroed(call=call):
                out.zero_()
                call()

            key = name[3:]
            r[key] = med(call, graph_ms)
            r[key + "_events"] = med(call, events_ms)
            if not slab:
                r[key + "_memset"] = med(zeroed, graph_ms)
                r[key + "_memset_events"] = med(zeroed, events_ms)

        def wrapper():
            return splat.splat_blur_kernel(gz, gy, gx, c, taps, S)

        r["wrapper"] = med(wrapper, graph_ms)
        r["wrapper_events"] = med(wrapper, events_ms)
        r["wrapper_host"] = med(wrapper, host_ms)
        res[tag] = r
        for k, v in r.items():
            print(f"[K7] {tag} {k}: {v}", flush=True)
        del out
        torch.cuda.empty_cache()
    return res


def k6b_parent_variants(src: str) -> dict:
    """The three-launch K6 backward's variants (memset by the wrapper,
    atomic splat, gather): ``full``; ``splat_only`` (the gather launch
    removed); ``gather_only`` (the splat launch removed: the gather reads
    a zeroed grid, every mask passing)."""
    splat = ("  const int err = splat_launch(pz, py, px, w, a, B, N, S, st);\n"
             "  if (err != cudaSuccess) return err;\n")
    gather = ("  return splat_grad_launch(pz, py, px, w, "
              "static_cast<const float*>(g), a,")
    return {"full": src,
            "splat_only": _cut(src, gather, "}\n\n// K7 forward:",
                               "  return cudaSuccess;\n"),
            "gather_only": _edit(src, splat, "")}


def k7b_parent_variants(src: str) -> dict:
    """The three-launch K7 backward's variants (memset by the wrapper,
    atomic splat, the Y/X blur's transpose a plane a block, gather):
    ``full``, ``splat_only``, ``blur_only`` and ``gather_only``, each the
    entry with the other launches removed."""
    splat = "  int err = splat_launch(pz, py, px, w, a, B, N, S, st);\n"
    after_splat = splat + "  if (err != cudaSuccess) return err;\n"
    blur = ("  err = blur_yx_t_launch(static_cast<const float*>(g), v, a,\n"
            "                         static_cast<const float*>(taps), K, B, "
            "S, st);\n  if (err != cudaSuccess) return err;\n")
    no_splat = _edit(src, splat, "  int err = cudaSuccess;\n")
    return {"full": src,
            "splat_only": _edit(src, after_splat,
                                after_splat + "  if (S > 0) return err;\n"),
            "blur_only": _edit(no_splat, blur,
                               blur + "  if (S > 0) return err;\n"),
            "gather_only": _edit(no_splat, blur, "")}


def k7_number_variants(src: str) -> dict:
    """The slab K7 forward with its shared-memory adds as floats (``full``:
    a compare-and-swap loop on sm_90a), as 32-bit integers on the same
    words (``int_adds``: native shared atomics; the sums are wrong, the
    work is the same) and without adds (``no_adds``): what the number
    format of a splat in shared memory costs."""
    add = ("            atomicAdd(buf + zl * plane + y[(q >> 1) & 1] * "
           "stride + x[q & 1],\n                      v[q]);\n")
    return {"full": src,
            "int_adds": _edit(src, add, (
                "            atomicAdd(reinterpret_cast<int*>(buf + zl * plane"
                " + y[(q >> 1) & 1] * stride + x[q & 1]),\n"
                "                      __float2int_rn(v[q] * 1048576.f));\n")),
            "no_adds": _edit(src, add, (
                "            if (v[q] == 1.2345e-30f) buf[zl] = v[q];\n"))}


def bwd_slab_variants(src: str, which: str) -> dict:
    """The one-launch K6 / K7 backward's variants: ``full`` (also timed at
    other plans: 1 to 16 planes a tile); ``scan_only`` (every CTA leaves
    after the first pass over the points); ``no_gather`` (the gather of
    the owned points skipped); ``float_adds`` (the tile's raw splat in
    float shared-memory atomics, a compare-and-swap loop, in place of
    32-bit fixed point); for K7 ``no_taps`` (the transposed blurs'
    windows read, each output one value of its window) and ``all_rows``
    (the transposes over every row of the tile, not only those its
    points' corners reach)."""
    first = "  if (sh.owned == 0) return kNoPoints;  // reads no cotangent\n"
    frac = ("    sh.frac = fixed_frac_bits(sh.splats, __uint_as_float("
            "sh.most),\n                              sh.signed_w != 0);"
            "\n")
    out = {"full": src,
           "no_gather": _edit_all(src, "  bwd_gather<",
                                  "  if (frac == 12345) bwd_gather<"),
           "float_adds": _edit(src, frac, "    sh.frac = -1;\n"),
           "scan_only": _edit(src, first, "  if (sh.owned >= 0) return "
                              "kNoPoints;\n")}
    if which == "k7b":
        taps = ("      if (j - r >= 0 && j - r < KT) acc[r] += k[j - r] * "
                "v;\n")
        out["no_taps"] = _edit(src, taps, "      if (j == r) acc[r] += v;\n")
        out["all_rows"] = _edit(src, "  if (listed > kListMin) {  // the "
                                "overflowed splat", "  if (listed >= 0) {  "
                                "// the overflowed splat")
    return out


def _bwd_cases(which: str) -> list:
    """(tag, grid-coordinate planes and weights, taps or None, S, cotangent)
    of K6 backward (``k6b``: ``chip_smoke.py`` phase 24's 120 x 8000 at
    64³, keep-prob 0.07, and the 3D IoU's (24, 8000) at 32³) or K7
    backward (``k7b``: the cases of ``_k7_cases``), non-negative
    weights."""
    import numpy as np
    import torch

    import chip_smoke as cs  # the root's
    from im23d_tpu_torch.ops.pointcloud import keep_mask
    from im23d_tpu_torch.ops.splat import _prep_splat

    dev = torch.device("cuda")
    if which == "k7b":
        gen = torch.Generator(device=dev).manual_seed(17)
        return [(tag, ops, taps, S,
                 torch.randn((ops[0].shape[0], S, S, S), device=dev,
                             generator=gen))
                for tag, ops, taps, S in _k7_cases()]
    gen = torch.Generator(device=dev).manual_seed(6)
    pts = cs._sweep_points(8, cs.B * cs.V, dev)
    w = keep_mask(gen, cs.B * cs.V, cs.N, 0.07)
    sweep = _prep_splat(pts, cs.S, w, 1e-6)
    g = torch.randn((cs.B * cs.V, cs.S, cs.S, cs.S), device=dev,
                    generator=gen)
    iou = _prep_splat(cs._clouds(np.random.RandomState(7), cs.B, cs.N, dev),
                      cs.IOU_S, None, 1e-6)
    g_iou = torch.randn((cs.B, cs.IOU_S, cs.IOU_S, cs.IOU_S), device=dev,
                        generator=gen)
    return [("sweep", sweep, None, cs.S, g), ("iou", iou, None, cs.IOU_S,
                                               g_iou)]


def time_bwd(which: str, root: str, csrc: str, nvcc: str, tmp: str,
             reps: int) -> dict:
    """K6 (``k6b``) or K7 (``k7b``) backward's split at ``_bwd_cases``:
    for a root with the three-launch backward (``k6b_parent_variants``,
    ``k7b_parent_variants``) each launch alone and the wrapper's memset of
    its grids; for a root with the slab kernels (``bwd_slab_variants``)
    each variant at the root's plan.  Each with ``dc`` and, for K6, without
    it; the root's wrapper by CUDA graph and events; for the three-launch
    root's K7 the number format of a shared-memory splat
    (``k7_number_variants`` of its slab K7 forward).  Device time by CUDA
    graph, medians of 3."""
    import torch

    from gpu_timing import graph_ms
    from im23d_tpu_torch.ops import splat

    with open(os.path.join(csrc, "splat.cu")) as fh:
        src = fh.read()
    parent = "splat_grad_kernel" in src or "splat_grad_kernel" in open(
        os.path.join(csrc, "splat_common.cuh")).read()
    if parent:
        variants = (k6b_parent_variants if which == "k6b"
                    else k7b_parent_variants)(src)
    else:
        variants = bwd_slab_variants(src, which)
    libs = build({f"{which}_{k}": v for k, v in variants.items()}, tmp,
                 nvcc, csrc)
    if which == "k7b" and parent:
        libs.update(build({f"fmt_{k}": v for k, v in
                           k7_number_variants(src).items()}, tmp, nvcc, csrc))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    res = {}

    def med(fn, timer=graph_ms):
        return sorted(timer(fn, reps) for _ in range(3))[1]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for tag, (gz, gy, gx, c), taps, S, g in _bwd_cases(which):
        B, N = gz.shape
        K_ = 0 if taps is None else taps.numel()
        outs = [torch.empty((B, N), device=gz.device) for _ in range(4)]
        pts = [t.data_ptr() for t in (gz, gy, gx, c)]
        r = {}
        if parent:
            raw = torch.zeros((B, S, S, S), device=gz.device)
            work = torch.empty_like(raw)
            r["memset"] = med(raw.zero_)
        else:
            plan = splat.splat_backward_plan(
                B, S, K_, splat.splat_blur_limits(gz.device))
            r["plan"] = plan
        for name, lib in libs.items():
            if name.startswith("fmt_"):
                continue
            key = name[len(which) + 1:]
            for dc in ((True, False) if which == "k6b" else (True,)):
                o = [t.data_ptr() for t in outs[:3]] + [
                    outs[3].data_ptr() if dc else None]
                if which == "k6b":
                    fn = lib.im23d_splat_bwd
                    if parent:
                        fn.argtypes = [P] * 10 + [I] * 3 + [P]
                        args = (*pts, g.data_ptr(), raw.data_ptr(), *o, B, N,
                                S)
                    else:
                        fn.argtypes = [P] * 9 + [I] * 6 + [L, P]
                        args = (*pts, g.data_ptr(), *o, B, N, S,
                                plan["planes"], plan["rows"], plan["stride"],
                                plan["smem"])
                else:
                    fn = lib.im23d_splat_blur_bwd
                    if parent:
                        fn.argtypes = [P] * 5 + [I] + [P] * 7 + [I] * 3 + [P]
                        args = (*pts, taps.data_ptr(), taps.numel(),
                                g.data_ptr(), raw.data_ptr(),
                                work.data_ptr(), *o, B, N, S)
                    else:
                        fn.argtypes = [P] * 5 + [I] + [P] * 5 + [I] * 6 + [
                            L, P]
                        args = (*pts, taps.data_ptr(), taps.numel(),
                                g.data_ptr(), *o, B, N, S, plan["planes"],
                                plan["rows"], plan["stride"], plan["smem"])

                def call(fn=fn, args=args, name=name):
                    rc = fn(*args, stream())
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                r[key + ("" if dc else "_no_dc")] = med(call)
        if not parent:
            # the full kernel at other plans: planes a tile, no bands
            lim = splat.splat_blur_limits(gz.device)
            fn = libs[f"{which}_full"]
            fn = fn.im23d_splat_bwd if which == "k6b" else \
                fn.im23d_splat_blur_bwd
            for p in (1, 2, 3, 4, 5, 6, 8, 11, 16):
                smem = splat._backward_smem(p, S, S, S | 1, K_, lim)
                if p > S or smem > lim.smem_optin:
                    continue
                head = pts + ([] if which == "k6b" else
                              [taps.data_ptr(), taps.numel()])
                tail = [S, S | 1, smem]

                def call(p=p, head=head, tail=tail, dc=True):
                    o = [t.data_ptr() for t in outs[:3]] + [
                        outs[3].data_ptr() if dc else None]
                    rc = fn(*head, g.data_ptr(), *o, B, N, S, p, *tail,
                            stream())
                    if rc:
                        raise RuntimeError(f"planes {p}: CUDA error {rc}")

                r[f"planes{p}"] = med(call)
                if which == "k6b":
                    r[f"planes{p}_no_dc"] = med(
                        lambda call=call: call(dc=False))
        for dc in ((True, False) if which == "k6b" else (True,)):
            if which == "k6b":
                def wrapper(dc=dc):
                    if parent:
                        return splat.splat_backward_kernel(gz, gy, gx, c, g)
                    return splat.splat_backward_kernel(gz, gy, gx, c, g,
                                                       need_dc=dc)
            else:
                def wrapper(dc=dc):
                    if parent:
                        return splat.splat_blur_backward_kernel(
                            gz, gy, gx, c, taps, g)
                    return splat.splat_blur_backward_kernel(
                        gz, gy, gx, c, taps, g, need_dc=dc)
            if parent and not dc:
                continue
            sfx = "" if dc else "_no_dc"
            r["wrapper" + sfx] = med(wrapper)
            r["wrapper_events" + sfx] = med(wrapper, events_ms)
        if which == "k7b" and parent:
            out = torch.empty((B, S, S, S), device=gz.device)
            fplan = splat.splat_blur_plan(B, S, taps.numel(),
                                          splat.splat_blur_limits(gz.device))
            for name, lib in libs.items():
                if not name.startswith("fmt_"):
                    continue
                fn = lib.im23d_splat_blur_fwd
                fn.argtypes = [P] * 5 + [I, P] + [I] * 5 + [L, P]

                def fwd(fn=fn):
                    rc = fn(*pts, taps.data_ptr(), taps.numel(),
                            out.data_ptr(), B, N, S, fplan["planes"],
                            fplan["stride"], fplan["smem"], stream())
                    if rc:
                        raise RuntimeError(f"K7 forward: CUDA error {rc}")

                r["fwd_" + name[4:]] = med(fwd)
            del out
        res[tag] = r
        for k, v in r.items():
            print(f"[{which}] {tag} {k}: {v}", flush=True)
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("k4k8", "k4f", "k8dw", "projection",
                                       "k5b", "k6", "k3", "k7", "k6b",
                                       "k7b"))
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.utils.cpp_extension import CUDA_HOME

    if not torch.cuda.is_available():
        print("time_split: no CUDA device", file=sys.stderr)
        return 2
    csrc = os.path.join(root, "im23d_tpu_torch", "csrc")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    gpu = gpu_line()
    print(f"[gpu] {gpu}; root {root}", flush=True)
    res = dict(gpu=gpu, root=root)
    with tempfile.TemporaryDirectory() as tmp:
        if args.only in (None, "k4k8"):
            res.update(time_k4k8(root, csrc, nvcc, tmp, args.reps))
        if args.only in (None, "k4f"):
            res.update(time_k4f(root, csrc, nvcc, tmp, args.reps))
        if args.only in (None, "k8dw"):
            res.update(time_k8dw(root, csrc, nvcc, tmp, args.reps))
        if args.only in (None, "projection"):
            res["projection"] = time_projection(root, csrc, nvcc, tmp,
                                                args.reps)
        if args.only in (None, "k5b"):
            res["k5b"] = time_k5b(root, csrc, nvcc, tmp, args.reps)
        if args.only == "k6":
            res["k6"] = time_k6(root, csrc, nvcc, tmp, args.reps)
        if args.only == "k3":
            res["k3"] = time_k3(root, csrc, nvcc, tmp, args.reps)
        if args.only == "k7":
            res["k7"] = time_k7(root, csrc, nvcc, tmp, args.reps)
        if args.only in ("k6b", "k7b"):
            res[args.only] = time_bwd(args.only, root, csrc, nvcc, tmp,
                                      args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
