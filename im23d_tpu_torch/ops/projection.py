"""Whole rendering-free projection: (B, N, 3) camera-space points ->
(B, S, S) silhouettes.

Counterpart of the public surface of ``im23d_tpu/ops/splat_pallas.py``
(``projection_silhouette_pallas`` and the winner reuse
``projection_silhouette_reuse``).  On a CPU tensor both run the plain
``ops/voxel.py`` chain under autograd.  On a CUDA tensor the forward is the
kernel K1 and the backward the kernel K2 (both in ``csrc/projection.cu``:
one thread-block cluster a cloud, the cloud's grid in the cluster's
distributed shared memory, laid out by ``projection_plan``), joined by the
``torch.autograd.Function`` ``_Projection``; there is no other path.  The
splat weights (keep masks) are constants: no gradient reaches them.
``COUNTERS["projected_clouds"]`` counts the clouds that
``projection_silhouette`` projects and ``["reused_silhouettes"]`` the rows
that ``projection_silhouette_reuse`` takes from a sweep, from shapes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from im23d_tpu_torch.core.profiler import COUNTERS
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
    culled points and points with ``c <= 0`` get zeroed coordinates, as the
    JAX version pins them (a negative weight is still splatted, at voxel
    0).  Returns (B, N) planes (gz, gy, gx, c).
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
    -> clamp to [0, 1] -> Y/X/Z blur by ``taps`` -> x ``scale``, clamp ->
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
    most = projection_limits(dev).max_points
    if N >= most:
        raise ValueError(f"{what} takes fewer than {most} points a cloud, "
                         f"got {N}")
    return dev, B, N


class ProjectionLimits(NamedTuple):
    """What ``projection_plan`` reads from the kernel library
    (``im23d_projection_limits``): the card's opt-in shared memory a block
    (bytes), then the kernels' constants: the largest cluster (the
    portable 8), grid side and tap count, the planes a CTA the plan aims
    for, the bytes a CTA keeps beside its planes and mask (taps,
    partials), and the points a cloud the fixed-point splat takes (fewer
    than ``max_points``)."""
    smem_optin: int
    max_cluster: int
    max_s: int
    max_k: int
    planes: int
    extra: int
    max_points: int


def _scratch_offset(S: int, planes: int, stage: int) -> int:
    """Where the splat's 64-bit scratch of ``stage`` planes starts in a
    CTA's shared memory: past the float planes of earlier passes, and far
    enough that float plane q0 + j of the last pass (q0 its first plane),
    written once scratch plane j is read, ends before scratch plane j + 1
    begins; as ``csrc/projection.cu`` places it."""
    fp, ip = S * (S | 1) * 4, S * S * 8
    q0 = (planes - 1) // stage * stage
    off = max(q0 * fp, (q0 + 1) * fp - ip)
    return -(-off // 8) * 8


def _arena_bytes(S: int, planes: int, stage: int) -> int:
    """Bytes of a CTA's float planes and the scratch, which overlap."""
    grid = -(-(planes * S * (S | 1) * 4) // 8) * 8
    return max(grid, _scratch_offset(S, planes, stage) + stage * S * S * 8)


def projection_plan(S: int, K: int, lim: ProjectionLimits) -> dict:
    """K1's and K2's layout for an S³ grid and K taps under ``lim``: one
    cluster of ``cluster`` CTAs a cloud; the CTA of rank r owns the z-planes
    [r·planes, r·planes + planes) and takes the rays of the same rows of y
    (the last CTA may own fewer); ``planes`` is ``lim.planes`` or fewer,
    evened out over the cluster.  Rows are ``stride`` floats apart in
    shared memory (odd).  The splat adds in 64-bit fixed point through a
    scratch of ``stage`` planes a CTA that lies over the float planes of
    later passes (``_scratch_offset``), in the fewest passes,
    ceil(planes / stage), that fit beside the backward's mask.
    ``smem_fwd`` and ``smem_bwd`` are the dynamic shared memory a CTA
    takes, as ``csrc/projection.cu`` counts it (the backward adds one
    64-bit mask word a (plane, x) column).  Raises ``ValueError`` for
    what the kernels cannot take."""
    S, K = int(S), int(K)
    if not (1 <= S <= lim.max_s and 1 <= K <= lim.max_k):
        raise ValueError(f"the projection kernels take 1 <= S <= "
                         f"{lim.max_s} and 1 <= K <= {lim.max_k}, got S={S}, "
                         f"K={K}")
    cluster = -(-S // min(S, lim.planes))
    planes = -(-S // cluster)
    if cluster > lim.max_cluster:
        raise ValueError(f"S={S} needs a cluster of {cluster} CTAs, more "
                         f"than {lim.max_cluster}")
    stride = S | 1
    mask = planes * S * 8
    for stage in range(planes, 0, -1):
        smem_fwd = _arena_bytes(S, planes, stage) + lim.extra
        if smem_fwd + mask <= lim.smem_optin:
            break
    else:
        raise ValueError(f"S={S} needs more than the card's "
                         f"{lim.smem_optin} bytes of shared memory a block")
    smem_bwd = smem_fwd + mask
    return dict(cluster=cluster, planes=planes, stride=stride, stage=stage,
                smem_fwd=smem_fwd, smem_bwd=smem_bwd)


_LIMITS: dict = {}


def projection_limits(dev: torch.device) -> ProjectionLimits:
    """``ProjectionLimits`` of CUDA device ``dev``, read from the library
    once."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _LIMITS:
        lib = _build.load_kernels()
        out = (ctypes.c_int * len(ProjectionLimits._fields))()
        _build.check(lib, lib.im23d_projection_limits(key, out),
                     "projection limits")
        _LIMITS[key] = ProjectionLimits(*out)
    return _LIMITS[key]


def projection_occupancy(plan: dict, S: int, K: int, backward: bool) -> int:
    """The most clusters of ``plan`` the current card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = _build.load_kernels()
    n = ctypes.c_int()
    smem = plan["smem_bwd" if backward else "smem_fwd"]
    _build.check(lib, lib.im23d_projection_occupancy(
        S, K, plan["cluster"], plan["planes"], plan["stage"], int(backward),
        smem, ctypes.byref(n)), "projection occupancy")
    return n.value


def projection_kernel(gz, gy, gx, c, taps, scale, size: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """Launch K1 on (B, N) grid-coordinate planes; returns (B, S, S).

    ``taps`` are the (K,) Gaussian taps, ``scale`` the (B,) per-cloud scale;
    all float32, contiguous, on one CUDA device.  No scratch: the output is
    the only allocation.

    Replaces the Pallas kernel ``_proj_sorted_fwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:1080``) and its dense twin.  Bound by
    operations (the three 21-tap blurs) once the grid stays on chip: one
    cluster launch, each cloud's grid in the distributed shared memory of
    one thread-block cluster (``projection_plan``; see
    ``csrc/projection.cu``).
    """
    S = int(size)
    dev, B, N = _check_planes("projection_kernel", gz, gy, gx, c, taps, scale,
                              S)
    K = taps.numel()
    plan = projection_plan(S, K, projection_limits(dev))
    lib = _build.load_kernels()
    out = torch.empty((B, S, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.im23d_projection_fwd(
        gz.data_ptr(), gy.data_ptr(), gx.data_ptr(), c.data_ptr(),
        taps.data_ptr(), K, scale.data_ptr(), out.data_ptr(), B, N, S,
        float(eps), plan["cluster"], plan["planes"], plan["stage"],
        plan["smem_fwd"], stream,
    )
    _build.check(lib, rc, "projection kernel (K1)")
    projection_kernel.launches += 1
    return out


projection_kernel.launches = 0


def projection_backward_kernel(gz, gy, gx, c, taps, scale, gsil,
                               eps: float = 1e-5):
    """Launch K2 on (B, N) grid-coordinate planes and the (B, S, S)
    silhouette cotangent; returns (dgz, dgy, dgx) (B, N) and dscale (B,).

    Operands as for ``projection_kernel``.  No scratch: the four outputs
    are the only allocations, and every element of them is written.

    Replaces the Pallas kernel ``_proj_sorted_bwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:1124``) and its dense twin
    ``_proj_bwd_kernel`` (``:621``).  One cluster launch, as K1: it
    recomputes the forward in the cluster's shared memory with the splat
    clamp's mask, runs the termination VJP and the Z blur's transpose per
    ray, the Y/X blurs' transposes per plane, and the splat's transpose as
    a gather per point; dscale is a fixed-order reduction (bit-equal
    launches; see ``csrc/projection.cu``).
    """
    S = gsil.shape[-1]
    dev, B, N = _check_planes("projection_backward_kernel", gz, gy, gx, c,
                              taps, scale, S)
    _check_operand("gsil", gsil, (B, S, S), dev)
    K = taps.numel()
    plan = projection_plan(S, K, projection_limits(dev))
    lib = _build.load_kernels()
    dscale = torch.empty((B,), dtype=torch.float32, device=dev)
    dgz, dgy, dgx = (torch.empty((B, N), dtype=torch.float32, device=dev)
                     for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.im23d_projection_bwd(
        gz.data_ptr(), gy.data_ptr(), gx.data_ptr(), c.data_ptr(),
        taps.data_ptr(), K, scale.data_ptr(), gsil.data_ptr(),
        dscale.data_ptr(), dgz.data_ptr(), dgy.data_ptr(), dgx.data_ptr(), B,
        N, S, float(eps), plan["cluster"], plan["planes"], plan["stage"],
        plan["smem_bwd"], stream,
    )
    _build.check(lib, rc, "projection backward kernel (K2)")
    projection_backward_kernel.launches += 1
    return dgz, dgy, dgx, dscale


projection_backward_kernel.launches = 0


def _projection_forward(gz, gy, gx, c, taps, scale, size, eps):
    """``_Projection.forward``'s K1 launch, alone in a function of its own
    (the benchmark times K1 at this entry)."""
    return projection_kernel(gz, gy, gx, c, taps, scale, size, eps)


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
        return _projection_forward(gz, gy, gx, c, taps, scale, size, eps)

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
    COUNTERS["projected_clouds"] += planes[0].shape[0]
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
    COUNTERS["reused_silhouettes"] += sil.shape[0]
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
