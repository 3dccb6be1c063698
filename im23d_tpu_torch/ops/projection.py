"""Whole rendering-free projection: (B, N, 3) camera-space points ->
(B, S, S) silhouettes.

Counterpart of the public surface of ``im23d_tpu/ops/splat_pallas.py``
(``projection_silhouette_pallas`` and the winner reuse
``projection_silhouette_reuse``).  On a CPU tensor both run the plain
``ops/voxel.py`` chain under autograd.  On a CUDA tensor the forward is the
kernel K1 and the backward the kernel K2 (both in ``csrc/projection.cu``),
joined by the ``torch.autograd.Function`` ``_Projection``; there is no other
path.  The splat weights (keep masks) are constants: no gradient reaches
them.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops import _build
from im23d_tpu_torch.ops.voxel import (
    blur_3d,
    gaussian_kernel_1d,
    project_silhouette,
    splat_grid,
    termination_probs,
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


def projection_grid_torch(gz, gy, gx, c, taps, scale, size: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K1 on (B, N) grid-coordinate planes: splat
    -> clamp <= 1 -> Y/X/Z blur by ``taps`` -> x ``scale``, clamp ->
    termination -> flipped depth sum.  Differentiable in every operand."""
    vox = splat_grid(torch.stack((gz, gy, gx), dim=-1), c, size)
    smooth = blur_3d(vox, taps, scale=scale)
    return project_silhouette(termination_probs(smooth, eps))


def _taps_and_scale(sigma, scale, kernel_size: int, B: int, dev):
    taps = gaussian_kernel_1d(torch.as_tensor(sigma, device=dev), kernel_size)
    scale = torch.broadcast_to(
        torch.as_tensor(scale, device=dev).reshape(-1), (B,)
    ).to(torch.float32)
    return taps.detach(), scale


def projection_silhouette_torch(points: Points, size: int, sigma, scale,
                                weights=None, kernel_size: int = 21,
                                border_eps: float = 1e-6,
                                eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the whole projection: the cull and grid
    coordinates of ``_prep_projection``, then ``projection_grid_torch``."""
    gz, gy, gx, c = _prep_projection(points, size, weights, border_eps)
    taps, scale = _taps_and_scale(sigma, scale, kernel_size, gz.shape[0],
                                  gz.device)
    return projection_grid_torch(gz, gy, gx, c, taps, scale, size, eps)


def projection_backward_torch(gz, gy, gx, c, taps, scale, gsil,
                              eps: float = 1e-5):
    """Plain PyTorch version of K2: the VJP of ``projection_grid_torch`` at
    the (B, S, S) silhouette cotangent ``gsil``.  Returns (dgz, dgy, dgx)
    (B, N) and dscale (B,); ``c`` and ``taps`` are constants."""
    with torch.enable_grad():
        coords = [t.detach().requires_grad_() for t in (gz, gy, gx)]
        sc = scale.detach().requires_grad_()
        sil = projection_grid_torch(*coords, c.detach(), taps.detach(), sc,
                                    gsil.shape[-1], eps)
        return tuple(torch.autograd.grad(sil, (*coords, sc), gsil))


def _check_operand(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_planes(what: str, gz, gy, gx, c, taps, scale, S: int):
    """Check the operands K1 and K2 share; returns (device, B, N)."""
    dev = gz.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    B, N = gz.shape
    for name, t in (("gz", gz), ("gy", gy), ("gx", gx), ("c", c)):
        _check_operand(name, t, (B, N), dev)
    _check_operand("taps", taps, (taps.numel(),), dev)
    _check_operand("scale", scale, (B,), dev)
    if not 1 <= S <= 64 or not 1 <= taps.numel() <= 64:
        raise ValueError(f"{what} takes 1 <= S, K <= 64 "
                         f"(S={S}, K={taps.numel()})")
    return dev, B, N


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
    S = int(size)
    dev, B, N = _check_planes("projection_kernel", gz, gy, gx, c, taps, scale,
                              S)
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


def projection_backward_kernel(gz, gy, gx, c, taps, scale, gsil,
                               eps: float = 1e-5):
    """Launch K2 on (B, N) grid-coordinate planes and the (B, S, S)
    silhouette cotangent; returns (dgz, dgy, dgx) (B, N) and dscale (B,).

    Operands as for ``projection_kernel``.  Scratch: two (B, S, S, S) f32
    grids (the raw splat, kept for its clamp mask, and a working grid;
    240 MiB at the 120 winners of the chairs step).

    Replaces the Pallas kernel ``_proj_sorted_bwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:1124``) and its dense twin
    ``_proj_bwd_kernel`` (``:621``).  It recomputes the forward with K1's
    splat and Y/X blur, runs the termination VJP and the Z blur transpose
    per ray, the Y/X blur transpose per z-plane, and the splat transpose as
    a gather per point (see ``csrc/projection.cu``).
    """
    S = gsil.shape[-1]
    dev, B, N = _check_planes("projection_backward_kernel", gz, gy, gx, c,
                              taps, scale, S)
    _check_operand("gsil", gsil, (B, S, S), dev)
    lib = _build.load_kernels()
    raw = torch.zeros((B, S, S, S), dtype=torch.float32, device=dev)
    work = torch.empty((B, S, S, S), dtype=torch.float32, device=dev)
    dscale = torch.zeros((B,), dtype=torch.float32, device=dev)
    dgz, dgy, dgx = (torch.empty((B, N), dtype=torch.float32, device=dev)
                     for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.im23d_projection_bwd(
        gz.data_ptr(), gy.data_ptr(), gx.data_ptr(), c.data_ptr(),
        taps.data_ptr(), taps.numel(), scale.data_ptr(), gsil.data_ptr(),
        raw.data_ptr(), work.data_ptr(), dscale.data_ptr(), dgz.data_ptr(),
        dgy.data_ptr(), dgx.data_ptr(), B, N, S, float(eps), stream,
    )
    _build.check(lib, rc, "projection backward kernel (K2)")
    projection_backward_kernel.launches += 1
    return dgz, dgy, dgx, dscale


projection_backward_kernel.launches = 0


class _Projection(torch.autograd.Function):
    """K1 forward and K2 backward on grid-coordinate planes.

    With ``sil`` given, the forward returns a copy of it and launches no
    kernel: the winner reuse, whose silhouettes the candidate sweep has
    already computed from the same inputs.  ``c`` and ``taps`` get no
    gradient; neither does ``sil``.
    """

    @staticmethod
    def forward(ctx, gz, gy, gx, c, taps, scale, sil, size, eps):
        ctx.save_for_backward(gz, gy, gx, c, taps, scale)
        ctx.eps = eps
        if sil is not None:
            return sil.clone()
        return projection_kernel(gz, gy, gx, c, taps, scale, size, eps)

    @staticmethod
    def backward(ctx, gsil):
        gz, gy, gx, c, taps, scale = ctx.saved_tensors
        dgz, dgy, dgx, dscale = projection_backward_kernel(
            gz, gy, gx, c, taps, scale, gsil.contiguous(), ctx.eps)
        return dgz, dgy, dgx, None, None, dscale, None, None, None


def _project(points: Points, size: int, sigma, scale, weights, kernel_size,
             border_eps, eps, sil=None) -> torch.Tensor:
    gz, gy, gx, c = _prep_projection(points, size, weights, border_eps)
    taps, scale = _taps_and_scale(sigma, scale, kernel_size, gz.shape[0],
                                  gz.device)
    return _Projection.apply(gz.contiguous(), gy.contiguous(),
                             gx.contiguous(), c.detach().contiguous(),
                             taps.contiguous(), scale.contiguous(), sil,
                             int(size), float(eps))


def projection_silhouette(points: Points, size: int, sigma, scale,
                          weights=None, kernel_size: int = 21,
                          border_eps: float = 1e-6,
                          eps: float = 1e-5) -> torch.Tensor:
    """(B, S, S) silhouettes of (B, N, 3) (or planar (z, y, x)) camera-space
    points; ``sigma`` may be a device scalar, ``scale`` is (B,) or (B, 1).
    Differentiable in the points and ``scale``.

    CPU tensors run ``projection_silhouette_torch`` under autograd; CUDA
    tensors run K1, and K2 for the gradient.
    """
    planes = _planes(points)
    if planes[0].device.type == "cpu":
        return projection_silhouette_torch(planes, size, sigma, scale, weights,
                                           kernel_size, border_eps, eps)
    return _project(planes, size, sigma, scale, weights, kernel_size,
                    border_eps, eps)


def projection_silhouette_reuse(points: Points, size: int, sigma, scale,
                                sil: torch.Tensor, weights=None,
                                kernel_size: int = 21,
                                border_eps: float = 1e-6,
                                eps: float = 1e-5) -> torch.Tensor:
    """Differentiable projection whose forward value is ``sil``.

    ``sil`` (B, S, S) holds rows of a projection sweep whose inputs were
    numerically the same as ``points``/``scale``/``weights`` here (the
    candidate sweep's argmin winners).  The value returned is ``sil``
    exactly, with no second forward projection; the gradient is that of a
    fresh projection of ``points``: K2 on CUDA, the plain chain's autograd
    on the CPU.
    """
    planes = _planes(points)
    operands = [*planes, scale]
    if not torch.is_grad_enabled() or not any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in operands):
        return sil
    if planes[0].device.type == "cpu":
        fresh = projection_silhouette_torch(planes, size, sigma, scale,
                                            weights, kernel_size, border_eps,
                                            eps)
        return sil.detach() + (fresh - fresh.detach())
    return _project(planes, size, sigma, scale, weights, kernel_size,
                    border_eps, eps, sil=sil.detach().contiguous())
