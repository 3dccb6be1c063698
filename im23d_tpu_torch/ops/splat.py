"""Standalone trilinear splat and fused splat + Gaussian blur: (B, N, 3)
points -> (B, S, S, S) occupancy grids.

Counterpart of ``trilinear_splat_pallas`` and ``splat_blur_pallas`` in
``im23d_tpu/ops/splat_pallas.py`` (without the ``dot_bf16`` knob).  On a
CPU tensor both run their plain PyTorch versions under autograd.  On a CUDA
tensor the splat grid is the kernel K6 (``trilinear_splat``) or K7
(``splat_blur``: splat, clamp and the Y/X blur), forward and backward, in
``csrc/splat.cu``, joined by the ``torch.autograd.Function``s
``_SplatGrid`` and ``_SplatBlurGrid``; there is no other path.  Both are
differentiable in the points and the weights; ``splat_blur`` in ``scale``
too (its Z blur, scale and last clip run in plain PyTorch, as the JAX
package runs them outside its kernel, and autograd gives their gradient).

Two choices differ from the JAX wrappers, which are the reference:

* Zero-weight points keep their coordinates.  The JAX wrappers pin them to
  voxel (0, 0, 0) before the kernel (``splat_pallas.py:487-488``,
  ``:538-539``), so their weight gradient is read there and not at the
  point; the port's is the gradient at the point, as the XLA splat
  (``im23d_tpu/ops/voxel.py:trilinear_splat``) gives it.
* The clamp's gradient passes on ties (``torch.clamp``'s rule: raw <= 1 on
  the splat, which is never < 0); ``jnp.clip``'s VJP passes half at a tie.
  A point with weight > 0 never sits on a voxel whose raw value is 0.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops import _build
from im23d_tpu_torch.ops.projection import _check_operand, _taps_and_scale
from im23d_tpu_torch.ops.voxel import blur_3d, splat_grid
# the plain version of ``trilinear_splat``: the same cull and weights as
# ``_prep_splat``, then ``splat_grid``
from im23d_tpu_torch.ops.voxel import trilinear_splat as trilinear_splat_torch

# K6's grid side; K7's two (S, S) float32 planes in a block's shared memory
# (227 KB on an H100) bound its side at 170
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
    """Plain PyTorch version of K7: ``splat_grid_torch``, then the Y and X
    blur by ``taps`` (band matmuls)."""
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
    return torch.cuda.current_stream(dev).cuda_stream


def splat_kernel(gz, gy, gx, c, size: int) -> torch.Tensor:
    """Launch K6 on (B, N) grid-coordinate planes and weights ``c`` (all
    float32, contiguous, on one CUDA device); returns the clamped
    (B, S, S, S) splat.

    Replaces the Pallas kernel ``_fwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:59``).  One thread per point adds its 8
    corners with ``atomicAdd`` into the zeroed output, a second pass clamps
    it to 1; bound by the grid's bytes.  The atomics add in an order that
    changes between runs: results agree with ``splat_grid_torch`` to float
    rounding, not bit for bit.
    """
    S = int(size)
    dev, B, N = _check_points("splat_kernel", gz, gy, gx, c, S,
                              SPLAT_MAX_SIZE)
    lib = _build.load_kernels()
    out = _zeros(B, S, dev)
    rc = lib.im23d_splat_fwd(gz.data_ptr(), gy.data_ptr(), gx.data_ptr(),
                             c.data_ptr(), out.data_ptr(), B, N, S,
                             _stream(dev))
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
    clamp's mask (raw <= 1), then gathers ``g`` at each point's 8 corners,
    one thread per point, without atomics; ``dc`` is the gradient at the
    point's own corners for every point.  The recomputed splat adds in
    another order than the plain version's, so a voxel within rounding of
    1 can flip its mask.
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
    (K,) Gaussian taps; returns the (B, S, S, S) splat, clamped to 1 and
    blurred along Y and X.  S <= SPLAT_BLUR_MAX_SIZE, else ``ValueError``.

    Replaces the Pallas kernel ``_fused_fwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:224``).  K6's atomic splat into the
    zeroed output, then one block per (cloud, z-plane) clamps and blurs its
    plane in dynamic shared memory and writes it back; bound by the grid's
    bytes.  Atomic order varies: agrees with ``splat_blur_grid_torch`` to
    float rounding.
    """
    S = int(size)
    dev, B, N = _check_points("splat_blur_kernel", gz, gy, gx, c, S,
                              SPLAT_BLUR_MAX_SIZE)
    _check_taps("splat_blur_kernel", taps, dev)
    lib = _build.load_kernels()
    out = _zeros(B, S, dev)
    rc = lib.im23d_splat_blur_fwd(gz.data_ptr(), gy.data_ptr(),
                                  gx.data_ptr(), c.data_ptr(),
                                  taps.data_ptr(), taps.numel(),
                                  out.data_ptr(), B, N, S, _stream(dev))
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
    clamp's mask (raw <= 1, the JAX kernel's own tie rule) into a second
    one, then gathers per point as K6's backward does.  Scratch: two
    (B, S, S, S) float32 grids.
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
