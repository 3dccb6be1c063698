"""Whole rendering-free projection: (B, N, 3) camera-space points ->
(B, S, S) silhouettes.

Counterpart of the public surface of ``im23d_tpu/ops/splat_pallas.py``
(``projection_silhouette_pallas``).  ``projection_silhouette`` runs the plain
``ops/voxel.py`` chain on a CPU tensor and the CUDA kernel K1
(``csrc/projection.cu``) on a CUDA tensor; there is no other path.

Forward only: the backward kernel is not ported yet, so inputs that require
grad are refused.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops import _build
from im23d_tpu_torch.ops.voxel import (
    gaussian_blur_3d,
    gaussian_kernel_1d,
    project_silhouette,
    termination_probs,
    trilinear_splat,
)

Points = torch.Tensor | tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _planes(points: Points):
    if isinstance(points, (tuple, list)):
        return tuple(points)
    return points.unbind(-1)


def _prep_projection(points: Points, size: int, weights, border_eps: float):
    """Voxel-grid coords ``(S-1)(p+0.5)`` + splat weights ``c``.

    Strict border cull on all three coordinates; ``weights`` multiply ``c``;
    culled and zero-weight points get zeroed coordinates.  Returns (B, N)
    planes (gz, gy, gx, c).
    """
    pz, py, px = _planes(points)
    S = int(size)
    lo, hi = -0.5 + border_eps, 0.5 - border_eps
    in_bounds = ((pz > lo) & (pz < hi) & (py > lo) & (py < hi)
                 & (px > lo) & (px < hi))
    c = in_bounds.to(pz.dtype)
    if weights is not None:
        c = c * weights
    safe = (c > 0).to(pz.dtype)
    gz, gy, gx = ((S - 1) * (p + 0.5) * safe for p in (pz, py, px))
    return gz, gy, gx, c


def projection_silhouette_torch(points: Points, size: int, sigma, scale,
                                weights=None, kernel_size: int = 21,
                                border_eps: float = 1e-6,
                                eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K1: splat -> blur -> scale -> termination
    -> flipped depth sum (the ``ops/voxel.py`` chain)."""
    pts = torch.stack(_planes(points), dim=-1)
    B = pts.shape[0]
    vox = trilinear_splat(pts, size, weights=weights, border_eps=border_eps)
    scale = torch.broadcast_to(torch.as_tensor(scale).reshape(-1), (B,))
    smooth = gaussian_blur_3d(vox, sigma, kernel_size=kernel_size,
                              scale=scale.to(pts))
    return project_silhouette(termination_probs(smooth, eps))


def _check_operand(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def projection_kernel(gz, gy, gx, c, taps, scale, size: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Launch K1 on (B, N) grid-coordinate planes; returns (B, S, S).

    ``taps`` are the (K,) Gaussian taps, ``scale`` the (B,) per-cloud scale;
    all float32, contiguous, on one CUDA device.  Scratch: a zeroed
    (B, S, S, S) f32 grid (1 MiB per cloud at S = 64).

    Replaces the Pallas kernel ``_proj_sorted_fwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:1080``) and its dense twin.  The grid
    does not fit in shared memory, so K1 is bound by device- and
    shared-memory traffic; it splats with atomics and blurs one z-plane or
    one ray column per block (see ``csrc/projection.cu``).
    """
    dev = gz.device
    if dev.type != "cuda":
        raise ValueError(f"projection_kernel needs CUDA tensors, got {dev}")
    B, N = gz.shape
    S = int(size)
    for name, t in (("gz", gz), ("gy", gy), ("gx", gx), ("c", c)):
        _check_operand(name, t, (B, N), dev)
    _check_operand("taps", taps, (taps.numel(),), dev)
    _check_operand("scale", scale, (B,), dev)
    if not 1 <= S <= 64 or not 1 <= taps.numel() <= 64:
        raise ValueError(f"K1 takes 1 <= S, K <= 64 (S={S}, K={taps.numel()})")
    lib = _build.load_kernels()
    grid = torch.zeros((B, S, S, S), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.im23d_projection_fwd(
        gz.data_ptr(), gy.data_ptr(), gx.data_ptr(), c.data_ptr(),
        taps.data_ptr(), taps.numel(), scale.data_ptr(), grid.data_ptr(),
        out.data_ptr(), B, N, S, float(eps), stream,
    )
    _build.check(lib, rc, "projection kernel (K1)")
    projection_kernel.launches += 1
    return out


projection_kernel.launches = 0


def projection_silhouette(points: Points, size: int, sigma, scale,
                          weights=None, kernel_size: int = 21,
                          border_eps: float = 1e-6,
                          eps: float = 1e-5) -> torch.Tensor:
    """(B, S, S) silhouettes of (B, N, 3) (or planar (z, y, x)) camera-space
    points; ``sigma`` may be a device scalar, ``scale`` is (B,) or (B, 1).

    CPU tensors run ``projection_silhouette_torch``; CUDA tensors run K1.
    """
    planes = _planes(points)
    operands = [*planes, scale, weights, sigma]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
        raise RuntimeError(
            "projection_silhouette is forward-only (its backward kernel is "
            "not ported yet): pass detached inputs or run under "
            "torch.no_grad()"
        )
    dev = planes[0].device
    if dev.type == "cpu":
        return projection_silhouette_torch(planes, size, sigma, scale, weights,
                                           kernel_size, border_eps, eps)
    gz, gy, gx, c = _prep_projection(planes, size, weights, border_eps)
    B = gz.shape[0]
    taps = gaussian_kernel_1d(torch.as_tensor(sigma, device=dev), kernel_size)
    scale = torch.broadcast_to(
        torch.as_tensor(scale, device=dev).reshape(-1), (B,)
    ).to(torch.float32).contiguous()
    return projection_kernel(gz.contiguous(), gy.contiguous(),
                             gx.contiguous(), c.contiguous(),
                             taps.contiguous(), scale, size, eps)
