#!/usr/bin/env python3
"""Where the time of a K4 backward, a K8 forward and the projection's K1
and K2 goes on one GPU, by variant copies of their sources and, for K1
and K2, by torch.profiler: the tiled K4 backward of commit 3892a42
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

Each variant keeps a value that depends on the removed work's inputs, so
the compiler keeps the rest.  Times: CUDA events over ``--reps``
back-to-back launches of the entry point alone (no zeroing, no
allocation), median of 3.  Prints one JSON line as its last line.

Usage (from the repository root, on a machine with a CUDA device):
    python3 tools/time_split.py --root build/parent [--only k4k8|projection]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", choices=("k4k8", "projection"))
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
        if args.only in (None, "projection"):
            res["projection"] = time_projection(root, csrc, nvcc, tmp,
                                                args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
