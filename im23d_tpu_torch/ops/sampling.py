"""Image / UV sampling and padding ops, NHWC (counterpart of
``im23d_tpu/ops/sampling.py``).

``grid_sample_bilinear`` is the texture lookup of the mesh renderer: it runs
the plain ``grid_sample_bilinear_torch`` on CPU tensors and the CUDA kernel
K5 (``csrc/grid_sample.cu``) on CUDA tensors, with K5's backward as the
gradient when one is needed (``_GridSample``).  K5's backward runs one of
two kernels, chosen by shape alone (``grid_sample_backward_plan``): a
thread a run of neighbouring samples with a corner cell's sums in
registers, or, for more than 4 channels, a thread a sample;
``grid_sample_backward_runs_torch`` is the plain twin of the first's
order of sums.  ``resize_bilinear`` is the
separable hat-matmul resize of the JAX version (the mask downsample of the
projection loss, and the texture down-resize of pseudo-ground-truth
generation).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from im23d_tpu_torch.ops import _build


def grid_sample_bilinear_torch(img: torch.Tensor,
                               grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with align_corners=True and zero padding.

    img (B, H, W, C); grid (B, Hg, Wg, 2), last axis (x, y) in [-1, 1], where
    -1 maps to pixel 0 and +1 to pixel size-1.  Returns (B, Hg, Wg, C); a
    corner outside the image contributes zero (torch ``padding_mode='zeros'``).
    The four-corner gather of the JAX version, in its order of operations.
    """
    B, H, W, C = img.shape
    x = (grid[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (grid[..., 1] + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1
    flat = img.reshape(B, H * W, C)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        idx = (yc * W + xc).reshape(B, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(*yi.shape, C)
        return vals * valid[..., None].to(img.dtype)

    return (gather(y0, x0) * (wy0 * wx0)[..., None]
            + gather(y0, x1) * (wy0 * wx1)[..., None]
            + gather(y1, x0) * (wy1 * wx0)[..., None]
            + gather(y1, x1) * (wy1 * wx1)[..., None])


def grid_sample_bilinear_kernel(img: torch.Tensor,
                                grid: torch.Tensor) -> torch.Tensor:
    """Launch K5 on a (B, H, W, C) texture and a (B, Hg, Wg, 2) grid, both
    float32, contiguous and on one CUDA device.

    Replaces the Pallas kernel ``_fwd_kernel``
    (``im23d_tpu/ops/sampling_pallas.py:197``).  A gather bound by the
    bytes of its grid and output and by the latency of its texel reads
    (L2-resident textures: 10 MB at (50, 128, 130, 3)): a thread takes four
    neighbouring samples, reads their grid and writes their outputs as
    16-byte vectors, and finds each sample's corners once; any texture
    size, no VMEM window tiers (see ``csrc/grid_sample.cu``).
    """
    dev = img.device
    if dev.type != "cuda" or grid.device != dev:
        raise ValueError(f"grid_sample_bilinear_kernel needs CUDA tensors on "
                         f"one device, got {img.device} and {grid.device}")
    for name, t, rank in (("img", img, 4), ("grid", grid, 4)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != rank or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous rank-{rank} "
                             f"tensor, got {tuple(t.shape)}")
    B, H, W, C = img.shape
    if grid.shape[0] != B or grid.shape[-1] != 2 or min(B, H, W, C) < 1:
        raise ValueError(f"shapes {tuple(img.shape)} and {tuple(grid.shape)} "
                         "do not pair up")
    Hg, Wg = grid.shape[1:3]
    out = torch.empty((B, Hg, Wg, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load_kernels()
    rc = lib.im23d_grid_sample_fwd(
        img.data_ptr(), grid.data_ptr(), out.data_ptr(), B, H, W, C,
        Hg * Wg, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "grid_sample kernel (K5)")
    grid_sample_bilinear_kernel.launches += 1
    return out


grid_sample_bilinear_kernel.launches = 0


def grid_sample_bilinear_backward_torch(img: torch.Tensor, grid: torch.Tensor,
                                        dout: torch.Tensor):
    """Plain backward: (d img, d grid) by autograd of
    ``grid_sample_bilinear_torch``."""
    with torch.enable_grad():
        img = img.detach().requires_grad_()
        grid = grid.detach().requires_grad_()
        out = grid_sample_bilinear_torch(img, grid)
        return torch.autograd.grad(out, (img, grid), dout)


class K5bLimits(NamedTuple):
    """What ``grid_sample_backward_plan`` reads from the kernel library
    (``im23d_k5b_limits``): the register-window kernel's largest channel
    count, threads a block, samples a thread reads at once and samples a
    run at most."""
    max_c: int
    threads: int
    spt: int
    max_run: int


# the run lengths the plan chooses from (tools/time_split.py --only k5b on
# an H100 80GB HBM3 at 700 W: 8 best at the recon train step's 3.9 samples
# a texel, 64 at the visibility render's 63)
RUN_MIN, RUN_MAX = 8, 64


def grid_sample_backward_plan(B: int, H: int, W: int, C: int, P: int,
                              need_img: bool, lim: K5bLimits) -> dict:
    """K5 backward's kernel for B textures (H, W, C) and P samples an
    image.

    ``runs`` when d texture is wanted and C <= ``lim.max_c``: a thread a
    run of ``run`` neighbouring samples of one image, ``blocks`` blocks of
    ``lim.threads``; any texture size.  ``run`` is about the samples that
    fall on one texel, P / (H W), as a power of two within [RUN_MIN,
    RUN_MAX]: the longer a corner cell's share of a run, the fewer adds.
    Otherwise ``generic``: a thread a sample.  d texture is zeroed first
    either way.  Whether d grid is wanted does not change the kernel."""
    if need_img and int(C) <= lim.max_c:
        run = max(RUN_MIN, lim.spt)
        while run < min(RUN_MAX, lim.max_run) and run * int(H) * int(W) < P:
            run *= 2
        runs = int(B) * -(-int(P) // run)
        return dict(path="runs", run=run, blocks=-(-runs // lim.threads))
    return dict(path="generic", run=0, blocks=-(-int(B) * int(P) // 256))


_K5B_LIMITS: list = []


def k5b_limits() -> K5bLimits:
    """``K5bLimits`` of the kernel library, read once."""
    if not _K5B_LIMITS:
        lib = _build.load_kernels()
        out = (ctypes.c_int * len(K5bLimits._fields))()
        _build.check(lib, lib.im23d_k5b_limits(out), "K5 bwd limits")
        _K5B_LIMITS.append(K5bLimits(*out))
    return _K5B_LIMITS[0]


def grid_sample_backward_runs_torch(img: torch.Tensor, grid: torch.Tensor,
                                    dout: torch.Tensor,
                                    run: int) -> torch.Tensor:
    """Plain twin of the register-window kernel's d texture in its order of
    sums: each run of ``run`` neighbouring samples of an image sums its
    products on its own (as a thread keeps them in registers), and the
    runs' sums are then added.  Equal to
    ``grid_sample_bilinear_backward_torch``'s d texture up to the order of
    the sums."""
    B, H, W, C = img.shape
    P = grid.shape[1] * grid.shape[2]
    R = -(-P // run)
    pad = R * run - P
    flat_g = torch.nn.functional.pad(grid.reshape(B, P, 2), (0, 0, 0, pad))
    flat_d = torch.nn.functional.pad(dout.reshape(B, P, C), (0, 0, 0, pad))
    per_run = grid_sample_bilinear_backward_torch(
        img.repeat_interleave(R, dim=0), flat_g.reshape(B * R, run, 1, 2),
        flat_d.reshape(B * R, run, 1, C))[0]
    return per_run.reshape(B, R, H, W, C).sum(dim=1)


def grid_sample_bilinear_backward_kernel(img: torch.Tensor,
                                         grid: torch.Tensor,
                                         dout: torch.Tensor,
                                         need_img: bool = True,
                                         need_grid: bool = True):
    """Launch K5's backward: (d img or None, d grid or None) for float32,
    contiguous CUDA tensors img (B, H, W, C), grid (B, Hg, Wg, 2) and
    dout (B, Hg, Wg, C).

    Replaces the Pallas kernel ``_bwd_kernel``
    (``im23d_tpu/ops/sampling_pallas.py:213``).  The kernel is the plan's
    (``grid_sample_backward_plan``): a thread walks a run of 8 to 64
    neighbouring samples keeping one corner cell's sums in registers and
    adds them into the zeroed d texture only when the cell moves on (with
    atomicAdd, which L2 carries out as a native float add), or, for more
    than 4 channels, a thread a sample.  The order of the sums changes
    between runs; a zero product is not added, so a texel no sample weighs
    stays exactly 0; d grid comes from the sample's four corners (see
    ``csrc/grid_sample.cu``).
    """
    dev = img.device
    if dev.type != "cuda" or grid.device != dev or dout.device != dev:
        raise ValueError("grid_sample_bilinear_backward_kernel needs CUDA "
                         "tensors on one device")
    for name, t in (("img", img), ("grid", grid), ("dout", dout)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous rank-4 tensor, "
                             f"got {tuple(t.shape)}")
    B, H, W, C = img.shape
    Hg, Wg = grid.shape[1:3]
    if (grid.shape[0] != B or grid.shape[-1] != 2
            or tuple(dout.shape) != (B, Hg, Wg, C)):
        raise ValueError(f"shapes {tuple(img.shape)}, {tuple(grid.shape)} "
                         f"and {tuple(dout.shape)} do not pair up")
    dimg = torch.zeros_like(img) if need_img else None
    dgrid = torch.empty_like(grid) if need_grid else None
    if Hg * Wg == 0 or not (need_img or need_grid):
        return dimg, (dgrid.zero_() if need_grid else None)
    plan = grid_sample_backward_plan(B, H, W, C, Hg * Wg, need_img,
                                     k5b_limits())
    lib = _build.load_kernels()
    rc = lib.im23d_grid_sample_bwd(
        img.data_ptr(), grid.data_ptr(), dout.data_ptr(),
        dimg.data_ptr() if need_img else None,
        dgrid.data_ptr() if need_grid else None, B, H, W, C, Hg * Wg,
        plan["run"], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "grid_sample backward kernel (K5 bwd)")
    grid_sample_bilinear_backward_kernel.launches += 1
    return dimg, dgrid


grid_sample_bilinear_backward_kernel.launches = 0


class _GridSample(torch.autograd.Function):
    """K5 forward, K5 backward as its gradient (CUDA, float32)."""

    @staticmethod
    def forward(ctx, img, grid):
        ctx.save_for_backward(img, grid)
        return grid_sample_bilinear_kernel(img, grid)

    @staticmethod
    def backward(ctx, dout):
        img, grid = ctx.saved_tensors
        need_img, need_grid = ctx.needs_input_grad[:2]
        return grid_sample_bilinear_backward_kernel(
            img, grid, dout.float().contiguous(), need_img, need_grid)


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup: plain on CPU; on CUDA (float32) K5, with K5's
    backward as the gradient when one is needed."""
    if img.device.type == "cpu":
        return grid_sample_bilinear_torch(img, grid)
    img, grid = img.float().contiguous(), grid.float().contiguous()
    if torch.is_grad_enabled() and (img.requires_grad or grid.requires_grad):
        return _GridSample.apply(img, grid)
    return grid_sample_bilinear_kernel(img, grid)


def circpad(x: torch.Tensor, amount: int = 1) -> torch.Tensor:
    """Circular padding along the width axis of an NHWC tensor."""
    return torch.cat([x[:, :, -amount:], x, x[:, :, :amount]], dim=2)


def symmetrize_texture(x: torch.Tensor) -> torch.Tensor:
    """Even symmetry along the width axis (N -> 2N), NHWC."""
    xf = torch.flip(x, dims=(2,))
    half = xf.shape[2] // 2
    return torch.cat([xf[:, :, half:], x, xf[:, :, :half]], dim=2)


def adjust_poles(tex: torch.Tensor) -> torch.Tensor:
    """Replace the top and bottom rows by their means (UV sphere poles),
    NHWC."""
    top = tex[:, :1].mean(dim=2, keepdim=True).expand(-1, -1, tex.shape[2], -1)
    bottom = tex[:, -1:].mean(dim=2, keepdim=True).expand(
        -1, -1, tex.shape[2], -1)
    return torch.cat([top, tex[:, 1:-1], bottom], dim=1)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of (B, H, W[, C]) with torch align_corners semantics.

    Separable: the bilinear weight of source pixel i at position x is the hat
    function max(0, 1 - |x - i|), applied as two interpolation matmuls (the
    same arithmetic as the JAX version).  ``align_corners=False`` takes
    half-pixel centres clamped to the edge pixels.
    """
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    _, H, W, _ = img.shape
    dev = img.device
    if align_corners:
        ys = torch.linspace(0.0, H - 1.0, out_h, device=dev)
        xs = torch.linspace(0.0, W - 1.0, out_w, device=dev)
    else:
        ys = torch.clamp((torch.arange(out_h, device=dev) + 0.5) * (H / out_h)
                         - 0.5, 0, H - 1)
        xs = torch.clamp((torch.arange(out_w, device=dev) + 0.5) * (W / out_w)
                         - 0.5, 0, W - 1)
    ry = torch.clamp(1.0 - torch.abs(ys[:, None] - torch.arange(H, device=dev)),
                     min=0.0)
    rx = torch.clamp(1.0 - torch.abs(xs[:, None] - torch.arange(W, device=dev)),
                     min=0.0)
    out = torch.einsum("oh,bhwc->bowc", ry.to(img.dtype), img)
    out = torch.einsum("pw,bowc->bopc", rx.to(img.dtype), out)
    return out[..., 0] if squeeze else out
