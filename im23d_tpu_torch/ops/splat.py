"""Standalone trilinear splat and fused splat + Gaussian blur: (B, N, 3)
points -> (B, S, S, S) occupancy grids.

Counterpart of ``trilinear_splat_pallas`` and ``splat_blur_pallas`` in
``im23d_tpu/ops/splat_pallas.py`` (without the ``dot_bf16`` knob).  On a
CPU tensor both run their plain PyTorch versions under autograd.  On a CUDA
tensor the splat grid is the kernel K6 (``trilinear_splat``) or K7
(``splat_blur``: splat, clamp and the Y/X blur), forward and backward, in
``csrc/splat.cu``, joined by the ``torch.autograd.Function``s
``_SplatGrid`` and ``_SplatBlurGrid``; there is no other path.  K6's
forward takes one of two kernel paths, chosen by shape alone
(``splat_plan``): a cluster of CTAs a cloud, each with a copy of the grid
in shared memory, or, for a grid too large for that, atomics into device
memory; ``splat_grid_shared_torch`` is the plain twin of the first's order
of sums.  K7's forward is one launch of a CTA a slab of z-planes
(``splat_blur_plan``), each CTA splatting the corners that land in its slab
(``splat_blur_slabs_torch`` is the plain twin of that partition).  Both are
differentiable in the points and the weights; ``splat_blur`` in ``scale``
too (its Z blur, scale and last clip run in plain PyTorch, as the JAX
package runs them outside its kernel, and autograd gives their gradient).

Two choices differ from the JAX wrappers, which are the reference:

* Zero-weight points keep their coordinates.  The JAX wrappers pin them to
  voxel (0, 0, 0) before the kernel (``splat_pallas.py:487-488``,
  ``:538-539``), so their weight gradient is read there and not at the
  point; the port's is the gradient at the point, as the XLA splat
  (``im23d_tpu/ops/voxel.py:trilinear_splat``) gives it.
* The clamp's gradient passes on ties (``torch.clamp``'s rule: where
  0 <= raw <= 1 on the splat); ``jnp.clip``'s VJP passes half at a tie.  A
  point with weight > 0 never sits on a voxel whose raw value is 0.

The clamp is to [0, 1] for weights of either sign, as in the XLA splat
(``im23d_tpu/ops/voxel.py:trilinear_splat``); the JAX Pallas kernels clamp
only the top (``splat_pallas.py:230``, ``:248``: they assume a splat
>= 0), so they differ from it, and from the port, for negative weights.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from im23d_tpu_torch.ops import _build
from im23d_tpu_torch.ops.projection import _check_operand, _taps_and_scale
from im23d_tpu_torch.ops.voxel import blur_3d, splat_grid, splat_sum
# the plain version of ``trilinear_splat``: the same cull and weights as
# ``_prep_splat``, then ``splat_grid``
from im23d_tpu_torch.ops.voxel import trilinear_splat as trilinear_splat_torch

# K6's grid side; K7's plane and temporary, (S, S) float32 each, in a
# block's shared memory (227 KB on an H100) bound its side at 170
SPLAT_MAX_SIZE, SPLAT_BLUR_MAX_SIZE = 1024, 170


def _prep_splat(points: torch.Tensor, size: int, weights, border_eps: float):
    """(B, N) planes of grid coordinates ``(S-1)(p+0.5)`` (gz, gy, gx) and
    splat weights ``c``: 0 for a point with any coordinate outside
    (-0.5 + eps, 0.5 - eps), else ``weights`` (1 without).  Coordinates are
    not pinned: a zero-weight point's weight gradient is taken where it
    lies."""
    lo, hi = -0.5 + border_eps, 0.5 - border_eps
    in_bounds = torch.all((points > lo) & (points < hi), dim=-1)
    c = in_bounds.to(points.dtype)
    if weights is not None:
        c = c * weights
    grid = (int(size) - 1) * (points + 0.5)
    gz, gy, gx = (t.contiguous() for t in grid.unbind(-1))
    return gz, gy, gx, c.contiguous()


# -- plain versions -----------------------------------------------------------


def splat_grid_torch(gz, gy, gx, c, size: int) -> torch.Tensor:
    """Plain PyTorch version of K6 on (B, N) grid-coordinate planes: the
    trilinear splat weighted by ``c``, clamped to [0, 1]."""
    return splat_grid(torch.stack((gz, gy, gx), dim=-1), c, size)


def splat_blur_grid_torch(gz, gy, gx, c, taps, size: int) -> torch.Tensor:
    """Plain PyTorch version of K7: ``splat_grid_torch`` (clamped to
    [0, 1]), then the X and Y blur by ``taps`` (band matmuls)."""
    return blur_3d(splat_grid_torch(gz, gy, gx, c, size), taps, axes=(3, 2))


def _vjp(fn, gz, gy, gx, c, g):
    with torch.enable_grad():
        ops = [t.detach().requires_grad_() for t in (gz, gy, gx, c)]
        return tuple(torch.autograd.grad(fn(*ops), ops, g))


def splat_backward_torch(gz, gy, gx, c, g):
    """Plain PyTorch version of K6's backward: the VJP of
    ``splat_grid_torch`` at the (B, S, S, S) cotangent ``g``; returns
    (dgz, dgy, dgx, dc), each (B, N)."""
    S = g.shape[-1]
    return _vjp(lambda *p: splat_grid_torch(*p, S), gz, gy, gx, c, g)


def splat_blur_backward_torch(gz, gy, gx, c, taps, g):
    """Plain PyTorch version of K7's backward: the VJP of
    ``splat_blur_grid_torch`` at ``g``; the taps are constants."""
    S = g.shape[-1]
    taps = taps.detach()
    return _vjp(lambda *p: splat_blur_grid_torch(*p, taps, S), gz, gy, gx, c,
                g)


def splat_blur_torch(points: torch.Tensor, size: int, sigma, scale,
                     weights=None, kernel_size: int = 21,
                     border_eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of ``splat_blur``: the clamped splat, its
    blur along X, Y and Z, times the per-cloud ``scale``, clipped to
    [0, 1]."""
    gz, gy, gx, c = _prep_splat(points, size, weights, border_eps)
    taps, scale = _taps_and_scale(sigma, scale, kernel_size, gz.shape[0],
                                  gz.device)
    return blur_3d(splat_grid_torch(gz, gy, gx, c, size), taps, scale)


# -- kernels ------------------------------------------------------------------


def _check_points(what: str, gz, gy, gx, c, size: int, limit: int):
    """Check the (B, N) planes the four kernels share; returns (device, B,
    N)."""
    if not 1 <= size <= limit:
        raise ValueError(f"{what} takes a grid side 1 <= S <= {limit} "
                         f"(S={size})")
    dev = gz.device
    if dev.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {dev}")
    B, N = gz.shape
    for name, t in (("gz", gz), ("gy", gy), ("gx", gx), ("c", c)):
        _check_operand(name, t, (B, N), dev)
    return dev, B, N


def _check_taps(what: str, taps, dev) -> None:
    _check_operand("taps", taps, (taps.numel(),), dev)
    if not 1 <= taps.numel() <= 64:
        raise ValueError(f"{what} takes 1 <= K <= 64 taps (K={taps.numel()})")


def _zeros(B: int, S: int, dev) -> torch.Tensor:
    return torch.zeros((B, S, S, S), dtype=torch.float32, device=dev)


def _empty_planes(B: int, N: int, dev):
    return [torch.empty((B, N), dtype=torch.float32, device=dev)
            for _ in range(4)]


def _stream(dev) -> int:
    """The raw handle of ``dev``'s current stream (``torch.cuda.
    current_stream(dev).cuda_stream`` builds a Stream object on the way,
    several microseconds of a wrapper's host time)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


class SplatLimits(NamedTuple):
    """What ``splat_plan`` reads from the kernel library
    (``im23d_splat_limits``): the card's opt-in shared memory a block
    (bytes) and its multiprocessors, then the shared path's largest
    cluster and threads a CTA."""
    smem_optin: int
    sms: int
    max_cluster: int
    threads: int


def splat_plan(B: int, size: int, lim: SplatLimits) -> dict:
    """K6 forward's path for B clouds at an S³ grid.

    ``shared`` when S³ float32 fit a block's shared memory (S <= 38 on an
    H100): a cluster of ``cluster`` CTAs a cloud, each holding a copy of
    the grid (``smem`` bytes), ``cluster`` the largest power of two up to
    ``lim.max_cluster`` with B·cluster <= ``lim.sms`` (one wave: one CTA a
    multiprocessor), 1 at least.  Otherwise ``generic``: atomics into the
    zeroed output, then a clamp pass."""
    grid = int(size) ** 3 * 4
    if grid <= lim.smem_optin:
        k = 1
        while 2 * k <= lim.max_cluster and B * 2 * k <= lim.sms:
            k *= 2
        return dict(path="shared", cluster=k, smem=grid)
    return dict(path="generic", cluster=0, smem=0)


_SPLAT_LIMITS: dict = {}


def splat_limits(dev: torch.device) -> SplatLimits:
    """``SplatLimits`` of CUDA device ``dev``, read from the library once."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SPLAT_LIMITS:
        lib = _build.load_kernels()
        out = (ctypes.c_int * len(SplatLimits._fields))()
        _build.check(lib, lib.im23d_splat_limits(key, out), "splat limits")
        _SPLAT_LIMITS[key] = SplatLimits(*out)
    return _SPLAT_LIMITS[key]


def splat_grid_shared_torch(gz, gy, gx, c, size: int, plan: dict,
                            lim: SplatLimits) -> torch.Tensor:
    """Plain twin of K6's shared path, in its partition: point i of a cloud
    goes to CTA (i // threads) mod cluster, each CTA splats its points
    into its own copy, and the copies are added in rank order before the
    clamp to [0, 1].  Equal to ``splat_grid_torch`` up to the order of the
    sums."""
    k = plan["cluster"]
    coords = torch.stack((gz, gy, gx), dim=-1)
    owner = (torch.arange(gz.shape[1], device=gz.device) // lim.threads) % k
    total = None
    for r in range(k):
        part = splat_sum(coords, c * (owner == r), size)
        total = part if total is None else total + part
    return total.clamp(0.0, 1.0)


class SplatBlurLimits(NamedTuple):
    """What ``splat_blur_plan`` reads from the kernel library
    (``im23d_splat_blur_limits``): the card's opt-in shared memory a block
    (bytes) and its multiprocessors, then the least entries of K7
    forward's point list."""
    smem_optin: int
    sms: int
    list_min: int


def splat_blur_plan(B: int, size: int, K: int, lim: SplatBlurLimits) -> dict:
    """K7 forward's split of B clouds' S z-planes into slabs, a CTA a slab.

    A CTA holds ``planes`` planes of S rows of ``stride`` floats in
    shared memory: S | 1 (odd, so that a warp reading a column of rows
    hits 32 banks), or S where two such planes would not fit (S = 170);
    then a temporary plane, or ``lim.list_min`` floats if more, which
    first holds the splat's list of points.  ``planes`` is as many as
    leave room for two CTAs a multiprocessor, but no more than spreads
    the B·S planes over 4 CTAs a multiprocessor (so 1 at the meshing
    shapes), then evened out over the slabs; slab j is
    [j·planes, min((j+1)·planes, S)).  ``note`` says why a plan has fewer
    CTAs than multiprocessors."""
    S = int(size)
    if not 1 <= K <= 64:
        raise ValueError(f"splat_blur_plan takes 1 <= K <= 64 (K={K})")
    stride = S | 1
    if 2 * S * stride * 4 > lim.smem_optin:
        stride = S
    plane = S * stride * 4
    tail = max(plane, 4 * lim.list_min)
    if plane + tail > lim.smem_optin:
        raise ValueError(f"a {S}^2 plane and its temporary do not fit "
                         f"{lim.smem_optin} bytes of shared memory")
    most = max(1, (lim.smem_optin // 2 - tail) // plane)
    planes = max(1, min(most, S, B * S // (4 * lim.sms)))
    slabs = -(-S // planes)
    planes = -(-S // slabs)
    plan = dict(planes=planes, slabs=slabs, ctas=B * slabs, stride=stride,
                smem=planes * plane + tail)
    if B * slabs < lim.sms:
        plan["note"] = (f"{B} x {S} z-planes, one a CTA: fewer than "
                        f"{lim.sms} multiprocessors")
    return plan


_SPLAT_BLUR_LIMITS: dict = {}
# the wrapper's plans, kept for the shapes seen (a few a process)
_blur_plan = functools.lru_cache(maxsize=64)(splat_blur_plan)


def splat_blur_limits(dev: torch.device) -> SplatBlurLimits:
    """``SplatBlurLimits`` of CUDA device ``dev``, read from the library
    once."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SPLAT_BLUR_LIMITS:
        lib = _build.load_kernels()
        out = (ctypes.c_int * len(SplatBlurLimits._fields))()
        _build.check(lib, lib.im23d_splat_blur_limits(key, out),
                     "splat + blur limits")
        _SPLAT_BLUR_LIMITS[key] = SplatBlurLimits(*out)
    return _SPLAT_BLUR_LIMITS[key]


def splat_blur_slabs_torch(gz, gy, gx, c, taps, size: int,
                           plan: dict) -> torch.Tensor:
    """Plain twin of K7 forward's partition: each slab of ``plan`` is
    splatted from the corners whose clamped z index lies in it (a point
    on a slab's edge gives its two z corners to two slabs; one past the
    grid's edge clamps both into the edge plane's slab), then the slabs
    are joined, clamped to [0, 1] and blurred along X and Y.  Equal to
    ``splat_blur_grid_torch`` up to the order of the sums."""
    S = int(size)
    coords = torch.stack((gz, gy, gx), dim=-1)
    iz = torch.floor(gz).to(torch.int64)
    corner_z = torch.stack(((iz).clamp(0, S - 1), (iz + 1).clamp(0, S - 1)),
                           dim=-1)  # (B, N, 2): dz = 0, 1
    step = plan["planes"]
    parts = []
    for j in range(plan["slabs"]):
        lo, hi = j * step, min(S, (j + 1) * step)
        keep = ((corner_z >= lo) & (corner_z < hi)).to(c.dtype)
        parts.append(splat_sum(coords, c, S, z_keep=keep)[:, lo:hi])
    grid = torch.cat(parts, dim=1).clamp(0.0, 1.0)
    return blur_3d(grid, taps, axes=(3, 2))


def splat_kernel(gz, gy, gx, c, size: int) -> torch.Tensor:
    """Launch K6 on (B, N) grid-coordinate planes and weights ``c`` (all
    float32, contiguous, on one CUDA device); returns the clamped
    (B, S, S, S) splat.

    Replaces the Pallas kernel ``_fwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:59``).  The path is the plan's
    (``splat_plan``): on the shared path one launch, a cluster of CTAs a
    cloud each splatting its share of the points into a copy of the grid
    in shared memory, the copies summed in rank order, clamped and written
    once (``torch.empty`` output, no clamp pass); on the generic path one
    thread per point adds its 8 corners with ``atomicAdd`` into the zeroed
    output and a second pass clamps it.  Bound by the grid's bytes.  The
    atomics add in an order that changes between runs: results agree with
    ``splat_grid_torch`` to float rounding, not bit for bit.
    """
    S = int(size)
    dev, B, N = _check_points("splat_kernel", gz, gy, gx, c, S,
                              SPLAT_MAX_SIZE)
    plan = splat_plan(B, S, splat_limits(dev))
    lib = _build.load_kernels()
    out = (torch.empty((B, S, S, S), dtype=torch.float32, device=dev)
           if plan["path"] == "shared" else _zeros(B, S, dev))
    rc = lib.im23d_splat_fwd(gz.data_ptr(), gy.data_ptr(), gx.data_ptr(),
                             c.data_ptr(), out.data_ptr(), B, N, S,
                             plan["cluster"], plan["smem"], _stream(dev))
    _build.check(lib, rc, "splat kernel (K6)")
    splat_kernel.launches += 1
    return out


splat_kernel.launches = 0


def splat_backward_kernel(gz, gy, gx, c, g):
    """Launch K6's backward at the (B, S, S, S) cotangent ``g``; returns
    (dgz, dgy, dgx, dc), each (B, N).

    Replaces the Pallas kernel ``_bwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:93``) with the clamp's VJP in front of
    it.  It splats again into a zeroed (B, S, S, S) scratch grid for the
    clamp's mask (0 <= raw <= 1), then gathers ``g`` at each point's 8
    corners, one thread per point, without atomics; ``dc`` is the gradient
    at the point's own corners for every point.  The recomputed splat adds
    in another order than the plain version's, so a voxel within rounding
    of 0 or 1 can flip its mask.
    """
    S = g.shape[-1]
    dev, B, N = _check_points("splat_backward_kernel", gz, gy, gx, c, S,
                              SPLAT_MAX_SIZE)
    _check_operand("g", g, (B, S, S, S), dev)
    lib = _build.load_kernels()
    raw = _zeros(B, S, dev)
    dgz, dgy, dgx, dc = _empty_planes(B, N, dev)
    rc = lib.im23d_splat_bwd(gz.data_ptr(), gy.data_ptr(), gx.data_ptr(),
                             c.data_ptr(), g.data_ptr(), raw.data_ptr(),
                             dgz.data_ptr(), dgy.data_ptr(), dgx.data_ptr(),
                             dc.data_ptr(), B, N, S, _stream(dev))
    _build.check(lib, rc, "splat backward kernel (K6)")
    splat_backward_kernel.launches += 1
    return dgz, dgy, dgx, dc


splat_backward_kernel.launches = 0


def splat_blur_kernel(gz, gy, gx, c, taps, size: int) -> torch.Tensor:
    """Launch K7 on (B, N) grid-coordinate planes, weights ``c`` and the
    (K,) Gaussian taps; returns the (B, S, S, S) splat, clamped to [0, 1]
    and blurred along X and Y.  S <= SPLAT_BLUR_MAX_SIZE, else
    ``ValueError``.

    Replaces the Pallas kernel ``_fused_fwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:224``).  One launch and no memset: a
    CTA a slab of a cloud's z-planes (``splat_blur_plan``) splats the
    corners that land in its slab into shared memory, clamps and blurs
    each plane there and writes each voxel once (``torch.empty``
    output).  Bound by the grid's bytes.  Shared-memory float atomics add
    in an order that varies: agrees with ``splat_blur_grid_torch`` to
    float rounding.
    """
    S = int(size)
    dev, B, N = _check_points("splat_blur_kernel", gz, gy, gx, c, S,
                              SPLAT_BLUR_MAX_SIZE)
    _check_taps("splat_blur_kernel", taps, dev)
    K = taps.numel()
    plan = _blur_plan(B, S, K, splat_blur_limits(dev))
    lib = _build.load_kernels()
    out = torch.empty((B, S, S, S), dtype=torch.float32, device=dev)
    rc = lib.im23d_splat_blur_fwd(gz.data_ptr(), gy.data_ptr(),
                                  gx.data_ptr(), c.data_ptr(),
                                  taps.data_ptr(), K, out.data_ptr(), B, N,
                                  S, plan["planes"], plan["stride"],
                                  plan["smem"], _stream(dev))
    _build.check(lib, rc, "splat + blur kernel (K7)")
    splat_blur_kernel.launches += 1
    return out


splat_blur_kernel.launches = 0


def splat_blur_backward_kernel(gz, gy, gx, c, taps, g):
    """Launch K7's backward at the (B, S, S, S) cotangent ``g``; returns
    (dgz, dgy, dgx, dc), each (B, N); the taps get no gradient.

    Replaces the Pallas kernel ``_fused_bwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:234``).  It splats again into a zeroed
    scratch grid, applies the Y/X blur's transpose to ``g`` times the
    clamp's mask (0 <= raw <= 1, ties passing) into a second
    one, then gathers per point as K6's backward does.  Scratch: two
    (B, S, S, S) float32 grids.  The mask is 0 <= raw <= 1, which for
    weights >= 0 is the raw <= 1 of the JAX kernel.
    """
    S = g.shape[-1]
    dev, B, N = _check_points("splat_blur_backward_kernel", gz, gy, gx, c, S,
                              SPLAT_BLUR_MAX_SIZE)
    _check_taps("splat_blur_backward_kernel", taps, dev)
    _check_operand("g", g, (B, S, S, S), dev)
    lib = _build.load_kernels()
    raw = _zeros(B, S, dev)
    work = torch.empty_like(raw)
    dgz, dgy, dgx, dc = _empty_planes(B, N, dev)
    rc = lib.im23d_splat_blur_bwd(
        gz.data_ptr(), gy.data_ptr(), gx.data_ptr(), c.data_ptr(),
        taps.data_ptr(), taps.numel(), g.data_ptr(), raw.data_ptr(),
        work.data_ptr(), dgz.data_ptr(), dgy.data_ptr(), dgx.data_ptr(),
        dc.data_ptr(), B, N, S, _stream(dev))
    _build.check(lib, rc, "splat + blur backward kernel (K7)")
    splat_blur_backward_kernel.launches += 1
    return dgz, dgy, dgx, dc


splat_blur_backward_kernel.launches = 0


class _SplatGrid(torch.autograd.Function):
    """K6 forward and backward on grid-coordinate planes."""

    @staticmethod
    def forward(ctx, gz, gy, gx, c, size):
        ctx.save_for_backward(gz, gy, gx, c)
        return splat_kernel(gz, gy, gx, c, size)

    @staticmethod
    def backward(ctx, g):
        return (*splat_backward_kernel(*ctx.saved_tensors, g.contiguous()),
                None)


class _SplatBlurGrid(torch.autograd.Function):
    """K7 forward and backward on grid-coordinate planes; the taps get no
    gradient (sigma is a schedule, as in the JAX package)."""

    @staticmethod
    def forward(ctx, gz, gy, gx, c, taps, size):
        ctx.save_for_backward(gz, gy, gx, c, taps)
        return splat_blur_kernel(gz, gy, gx, c, taps, size)

    @staticmethod
    def backward(ctx, g):
        grads = splat_blur_backward_kernel(*ctx.saved_tensors, g.contiguous())
        return (*grads, None, None)


# -- public entry points ------------------------------------------------------


def trilinear_splat(points: torch.Tensor, size: int, weights=None,
                    border_eps: float = 1e-6) -> torch.Tensor:
    """(B, N, 3) (z, y, x) points in [-0.5, 0.5] -> the (B, S, S, S) grid of
    their trilinear weights, clamped to [0, 1].  Points with any coordinate
    at or beyond 0.5 - ``border_eps`` are culled; ``weights`` (B, N) multiply
    the rest.  Differentiable in the points and the weights.

    CPU tensors run ``trilinear_splat_torch``; CUDA tensors run K6, and its
    backward for the gradient.
    """
    if points.device.type == "cpu":
        return trilinear_splat_torch(points, size, weights, border_eps)
    return _SplatGrid.apply(*_prep_splat(points, size, weights, border_eps),
                            int(size))


def splat_blur(points: torch.Tensor, size: int, sigma, scale, weights=None,
               kernel_size: int = 21, border_eps: float = 1e-6
               ) -> torch.Tensor:
    """``clip(gaussian_blur_3d(trilinear_splat(points, size, weights),
    sigma) * scale, 0, 1)`` of (B, N, 3) points: (B, S, S, S).  ``sigma``
    may be a device scalar and gets no gradient; ``scale`` is a scalar,
    (B,) or (B, 1).  Differentiable in the points, the weights and
    ``scale``.

    CPU tensors run ``splat_blur_torch``; CUDA tensors run K7 (splat, clamp,
    Y/X blur) and its backward, then the Z blur, the scale and the clip in
    plain PyTorch.  S above SPLAT_BLUR_MAX_SIZE raises ``ValueError`` on
    CUDA.
    """
    if points.device.type == "cpu":
        return splat_blur_torch(points, size, sigma, scale, weights,
                                kernel_size, border_eps)
    gz, gy, gx, c = _prep_splat(points, size, weights, border_eps)
    taps, scale = _taps_and_scale(sigma, scale, kernel_size, gz.shape[0],
                                  gz.device)
    yx = _SplatBlurGrid.apply(gz, gy, gx, c, taps.contiguous(), int(size))
    return blur_3d(yx, taps, scale, axes=(1,))
