"""Image / UV sampling and padding ops, NHWC (counterpart of
``im23d_tpu/ops/sampling.py``).

``grid_sample_bilinear`` is the texture lookup of the mesh renderer: it runs
the plain ``grid_sample_bilinear_torch`` on CPU tensors and the CUDA kernel
K5 (``csrc/grid_sample.cu``) on CUDA tensors.  ``resize_bilinear`` is the
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
    (``im23d_tpu/ops/sampling_pallas.py:197``).  A gather bound by memory
    latency: one thread per output sample reads its four corners (L2-resident
    textures: 10 MB at (50, 128, 130, 3)) and writes C floats; any texture
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


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear texture lookup: plain on CPU, K5 on CUDA (float32)."""
    if img.device.type == "cpu":
        return grid_sample_bilinear_torch(img, grid)
    return grid_sample_bilinear_kernel(img.float().contiguous(),
                                       grid.float().contiguous())


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
