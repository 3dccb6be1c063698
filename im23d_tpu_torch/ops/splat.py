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
(``splat_blur_slabs_torch`` is the plain twin of that partition).  K6's
and K7's backward are one launch each of a CTA a tile of z-planes
(``splat_backward_plan``) that rebuilds its raw splat with a halo plane and
gathers the points it owns (``splat_backward_slabs_torch`` is the plain
twin of that partition).  Both are
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
from im23d_tpu_torch.ops.voxel import (_band_matrix, blur_3d, splat_grid,
                                       splat_sum)
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


def _backward_outputs(B: int, N: int, dev, need_dc: bool) -> list:
    """(dgz, dgy, dgx, dc) of a backward kernel, (B, N) float32 with no
    initial value; dc None without ``need_dc``."""
    outs = [torch.empty((B, N), dtype=torch.float32, device=dev)
            for _ in range(4 if need_dc else 3)]
    return outs if need_dc else outs + [None]


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


def _backward_smem(planes: int, rows: int, S: int, stride: int, K: int,
                   lim: SplatBlurLimits) -> int:
    """Bytes of shared memory a backward CTA of ``planes`` z-planes by
    ``rows`` rows takes: its planes and rows and one halo of each (where
    the grid goes on), ``stride`` words a row; for K7 (K >= 1) a
    temporary of those rows; the point list, ``lim.list_min`` entries."""
    region = min(planes + 1, S) * min(rows + 1, S) * stride
    tmp = min(rows + 1, S) * stride if K else 0
    return 4 * (region + tmp + lim.list_min)


def _two_ctas(lim: SplatBlurLimits) -> int:
    """Dynamic shared memory a CTA may take for two to share a
    multiprocessor: the multiprocessor holds the opt-in limit and one
    block's 1 KB reserve, and each block takes its reserve and its static
    variables (K7 backward's counts and row mask, 156 bytes: 256 here)."""
    return (lim.smem_optin - 1024) // 2 - 256


# K6 backward's planes a tile: each tile reads its whole cloud's z and
# weights first, so few, large tiles (tools/time_split.py --only k6b)
K6_PLANES = 8


def splat_backward_plan(B: int, size: int, K: int,
                        lim: SplatBlurLimits) -> dict:
    """K6 (``K = 0``) or K7 backward's (K taps) split of B clouds' S³
    grids into tiles, a CTA a tile: ``planes`` z-planes by ``rows`` rows.

    A tile owns the points whose clamped lower corner (z, y) lies in it
    and rebuilds the raw splat of one halo plane and one halo row past
    its end (where the grid goes on), so that each owned point is
    gathered whole by one CTA and each output written once.  Rows are
    ``stride = S | 1`` words (odd: a warp reading a column hits 32
    banks).  ``rows`` is S (``bands`` 1) where a tile of one plane and its
    halo fits a block's shared memory with K7's temporary and the point
    list (``_backward_smem``); then ``planes`` is, for K7, as many as
    leave room for two CTAs a multiprocessor, but no more than spreads the
    B·S planes over 4 CTAs a multiprocessor, evened out over the slabs, as
    ``splat_blur_plan`` has it; for K6, K6_PLANES or as many as fit a
    block (every tile first reads its whole cloud, and K6 has no blur to
    spread).  Otherwise (K7 at S >= 134, K6 at S >= 164 on an H100) a
    tile is one plane by a band of rows, as many as fit, evened out over
    the bands.  ``halo`` is the share of voxels the CTAs rebuild
    beyond the grid's: (S + slabs - 1)(S + bands - 1) / S² - 1, largest
    at one plane a slab (the meshing shapes: ~1).  ``note`` says why a
    plan has fewer CTAs than multiprocessors."""
    S = int(size)
    if not 0 <= K <= 64:
        raise ValueError(f"splat_backward_plan takes 0 <= K <= 64 (K={K})")
    if S < 1:
        raise ValueError(f"splat_backward_plan takes S >= 1 (S={S})")
    stride = S | 1

    def need(planes, rows):
        return _backward_smem(planes, rows, S, stride, K, lim)

    if need(1, 1) > lim.smem_optin:
        raise ValueError(f"a tile of two rows of {S} does not fit "
                         f"{lim.smem_optin} bytes of shared memory")
    if need(1, S) <= lim.smem_optin:
        rows, bands = S, 1
        most = 1
        if K:
            while most < S and need(most + 1, S) <= _two_ctas(lim):
                most += 1
            planes = max(1, min(most, B * S // (4 * lim.sms)))
        else:
            while most < min(S, K6_PLANES) and need(most + 1,
                                                    S) <= lim.smem_optin:
                most += 1
            planes = most
        slabs = -(-S // planes)
        planes = -(-S // slabs)
        slabs = -(-S // planes)
    else:
        rows = 1
        while need(1, rows + 1) <= lim.smem_optin:
            rows += 1
        bands = -(-S // rows)
        rows = -(-S // bands)
        planes, slabs = 1, S
    plan = dict(planes=planes, rows=rows, slabs=slabs, bands=bands,
                ctas=B * slabs * bands, stride=stride,
                smem=need(planes, rows), list=lim.list_min,
                halo=(S + slabs - 1) * (S + bands - 1) / S ** 2 - 1)
    if plan["ctas"] < lim.sms:
        plan["note"] = (f"{B} x {slabs * bands} tiles, one a CTA: fewer "
                        f"than {lim.sms} multiprocessors")
    return plan


_bwd_plan = functools.lru_cache(maxsize=64)(splat_backward_plan)


def _tiles(S: int, plan: dict):
    """(z0, z1, y0, y1) of each tile's owned planes and rows."""
    for z0 in range(0, S, plan["planes"]):
        for y0 in range(0, S, plan["rows"]):
            yield (z0, min(S, z0 + plan["planes"]), y0,
                   min(S, y0 + plan["rows"]))


def splat_backward_slabs_torch(gz, gy, gx, c, g, plan: dict, taps=None,
                               need_dc: bool = True):
    """Plain twin of K6 (``taps`` None) and K7 backward's partition
    (``splat_backward_plan``) at the (B, S, S, S) cotangent ``g``: each
    tile splats the corners of the points of weight != 0 that land in its
    planes and rows and one halo plane and row past them (where the grid
    goes on), takes the clamp's mask there (0 <= raw <= 1), multiplies
    ``g`` (K6) or the transpose of the Y then X blur of ``g`` (K7) by it,
    and gathers the points it owns (clamped lower corner in its planes
    and rows) from it; zero-weight points only with ``need_dc``.  Returns
    (dgz, dgy, dgx, dc), dc None without ``need_dc``.  Equal to
    ``splat_backward_torch`` / ``splat_blur_backward_torch`` up to the
    order of sums."""
    S = g.shape[-1]
    B, N = gz.shape
    coords = torch.stack((gz, gy, gx), dim=-1)
    base = torch.floor(coords)
    t = coords - base
    lo = base.to(torch.int64)
    offs = torch.tensor([[dz, dy, dx] for dz in (0, 1) for dy in (0, 1)
                         for dx in (0, 1)], device=gz.device)  # (8, 3)
    idx = (lo[:, :, None, :] + offs).clamp(0, S - 1)  # (B, N, 8, 3)
    f = t[:, :, None, :]
    o = offs.to(t.dtype)
    wt = f * o + (1.0 - f) * (1.0 - o)  # per-axis corner weights
    dw = (2.0 * o - 1.0).expand_as(wt)  # their derivatives
    cw = wt.prod(dim=-1)  # (B, N, 8)
    d3 = torch.stack([torch.cat((dw[..., a:a + 1], wt[..., :a],
                                 wt[..., a + 1:]), dim=-1).prod(dim=-1)
                      for a in range(3)], dim=-1)  # (B, N, 8, 3)
    if taps is None:
        dv = g
    else:
        band = _band_matrix(taps.detach(), S).to(g.dtype)
        dv = torch.matmul(g.movedim(2, -1), band.T).movedim(-1, 2)
        dv = torch.matmul(dv, band.T)
    batch = torch.arange(B, device=gz.device)[:, None, None]
    za, ya = idx[:, :, 0, 0], idx[:, :, 0, 1]  # clamped lower corners
    dp = torch.zeros((B, N, 3), dtype=g.dtype, device=g.device)
    dc = torch.zeros((B, N), dtype=g.dtype, device=g.device)
    for z0, z1, y0, y1 in _tiles(S, plan):
        zh, yh = min(S, z1 + 1), min(S, y1 + 1)
        inside = ((idx[..., 0] >= z0) & (idx[..., 0] < zh)
                  & (idx[..., 1] >= y0) & (idx[..., 1] < yh))
        flat = ((batch * (zh - z0) + idx[..., 0] - z0) * (yh - y0)
                + idx[..., 1] - y0) * S + idx[..., 2]
        dump = B * (zh - z0) * (yh - y0) * S
        raw = torch.zeros(dump + 1, dtype=g.dtype, device=g.device)
        raw = raw.index_add(0, torch.where(inside, flat, dump).reshape(-1),
                            (cw * c[:, :, None]).reshape(-1))
        keep = (raw >= 0) & (raw <= 1)
        region = dv[:, z0:zh, y0:yh].reshape(-1)
        val = torch.where(keep[:-1], region, 0.0)
        owned = (za >= z0) & (za < z1) & (ya >= y0) & (ya < y1)
        if not need_dc:
            owned = owned & (c != 0)
        v = val[torch.where(inside, flat, 0)] * inside  # (B, N, 8)
        dp = torch.where(owned[..., None], (v[..., None] * d3).sum(dim=2),
                         dp)
        dc = torch.where(owned, (v * cw).sum(dim=2), dc)
    dgz, dgy, dgx = (dp * c[:, :, None]).unbind(-1)
    return dgz, dgy, dgx, dc if need_dc else None


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


def splat_backward_kernel(gz, gy, gx, c, g, need_dc: bool = True):
    """Launch K6's backward at the (B, S, S, S) cotangent ``g``; returns
    (dgz, dgy, dgx, dc), each (B, N), dc None without ``need_dc``.

    Replaces the Pallas kernel ``_bwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:93``) with the clamp's VJP in front of
    it.  One launch, no scratch grid, no memset (``torch.empty``
    outputs): a CTA a tile of z-planes (``splat_backward_plan``) lists its
    cloud's points, rebuilds the raw splat of its planes and a halo plane
    in shared memory (integer fixed point, for the clamp's mask 0 <= raw
    <= 1) and gathers ``g`` at the 8 corners of the points whose lower
    corner it owns, each output written once.  ``dc`` is the gradient at
    the point's own corners for every point; without ``need_dc``
    zero-weight points are skipped (their coordinate gradients are 0).
    The integer sums do not depend on the order of the adds, so launches
    are bit-equal; a voxel within rounding of 0 or 1 can take the other
    side of the mask than the plain version's float sum.  Bound by the
    bytes of ``g`` at the points' corners.
    """
    S = g.shape[-1]
    dev, B, N = _check_points("splat_backward_kernel", gz, gy, gx, c, S,
                              SPLAT_MAX_SIZE)
    _check_operand("g", g, (B, S, S, S), dev)
    plan = _bwd_plan(B, S, 0, splat_blur_limits(dev))
    lib = _build.load_kernels()
    dgz, dgy, dgx, dc = _backward_outputs(B, N, dev, need_dc)
    rc = lib.im23d_splat_bwd(gz.data_ptr(), gy.data_ptr(), gx.data_ptr(),
                             c.data_ptr(), g.data_ptr(), dgz.data_ptr(),
                             dgy.data_ptr(), dgx.data_ptr(),
                             None if dc is None else dc.data_ptr(), B, N, S,
                             plan["planes"], plan["rows"], plan["stride"],
                             plan["smem"], _stream(dev))
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


def splat_blur_backward_kernel(gz, gy, gx, c, taps, g,
                               need_dc: bool = True):
    """Launch K7's backward at the (B, S, S, S) cotangent ``g``; returns
    (dgz, dgy, dgx, dc), each (B, N), dc None without ``need_dc``; the
    taps get no gradient.

    Replaces the Pallas kernel ``_fused_bwd_kernel``
    (``im23d_tpu/ops/splat_pallas.py:234``).  One launch, no scratch
    grid, no memset: K6 backward's tiles (``splat_backward_plan``), and
    per plane of a tile the transpose of the Y then X blur of ``g`` (each
    plane of ``g`` read once, coalesced) times the clamp's mask (0 <= raw
    <= 1, ties passing) in shared memory, gathered there by the points the
    tile owns.  For weights >= 0 the mask is the raw <= 1 of the JAX
    kernel.  Launches are bit-equal (integer splat, fixed orders).
    """
    S = g.shape[-1]
    dev, B, N = _check_points("splat_blur_backward_kernel", gz, gy, gx, c, S,
                              SPLAT_BLUR_MAX_SIZE)
    _check_taps("splat_blur_backward_kernel", taps, dev)
    _check_operand("g", g, (B, S, S, S), dev)
    K = taps.numel()
    plan = _bwd_plan(B, S, K, splat_blur_limits(dev))
    lib = _build.load_kernels()
    dgz, dgy, dgx, dc = _backward_outputs(B, N, dev, need_dc)
    rc = lib.im23d_splat_blur_bwd(
        gz.data_ptr(), gy.data_ptr(), gx.data_ptr(), c.data_ptr(),
        taps.data_ptr(), K, g.data_ptr(), dgz.data_ptr(), dgy.data_ptr(),
        dgx.data_ptr(), None if dc is None else dc.data_ptr(), B, N, S,
        plan["planes"], plan["rows"], plan["stride"], plan["smem"],
        _stream(dev))
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
        # constant weights (a keep mask) need no dc: zero-weight points are
        # then not gathered
        return (*splat_backward_kernel(*ctx.saved_tensors, g.contiguous(),
                                       need_dc=ctx.needs_input_grad[3]),
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
        grads = splat_blur_backward_kernel(*ctx.saved_tensors, g.contiguous(),
                                           need_dc=ctx.needs_input_grad[3])
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
