"""Image / UV sampling and padding ops, NHWC (counterpart of
``im23d_tpu/ops/sampling.py``).

``grid_sample_bilinear`` is the texture lookup of the mesh renderer: it runs
the plain ``grid_sample_bilinear_torch`` on CPU tensors and the CUDA kernel
K5 (``csrc/grid_sample.cu``) on CUDA tensors, with K5's backward as the
gradient when one is needed (``_GridSample``).  ``resize_bilinear`` is the
separable hat-matmul resize of the JAX version (the mask downsample of the
projection loss, and the texture down-resize of pseudo-ground-truth
generation).
"""

from __future__ import annotations

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


def grid_sample_bilinear_backward_kernel(img: torch.Tensor,
                                         grid: torch.Tensor,
                                         dout: torch.Tensor,
                                         need_img: bool = True,
                                         need_grid: bool = True):
    """Launch K5's backward: (d img or None, d grid or None) for float32,
    contiguous CUDA tensors img (B, H, W, C), grid (B, Hg, Wg, 2) and
    dout (B, Hg, Wg, C).

    Replaces the Pallas kernel ``_bwd_kernel``
    (``im23d_tpu/ops/sampling_pallas.py:213``).  One thread per sample: d
    grid from its four corners, d img scattered with ``atomicAdd`` (order of
    the sums changes between runs), a zero product not added, so a texel
    no sample weighs stays exactly 0 (see ``csrc/grid_sample.cu``).
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
    lib = _build.load_kernels()
    rc = lib.im23d_grid_sample_bwd(
        img.data_ptr(), grid.data_ptr(), dout.data_ptr(),
        dimg.data_ptr() if need_img else None,
        dgrid.data_ptr() if need_grid else None, B, H, W, C, Hg * Wg,
        torch.cuda.current_stream(dev).cuda_stream)
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
