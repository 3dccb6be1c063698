"""Chamfer distance between point clouds (counterpart of
``im23d_tpu/metrics/chamfer.py``).

``nn_dist2`` runs the plain ``nn_dist2_torch`` on CPU tensors and the CUDA
kernel K3 (``csrc/nn_dist2.cu``) on CUDA tensors.  ``chamfer_distance`` is the
symmetric Chamfer-L2:
``mean_n min_m ||a_n - b_m||^2 + mean_m min_n ||a_m - b_n||^2``; on CUDA
tensors both directions come from one launch of K3 (``chamfer_kernel``),
which evaluates each pair once.  ``chamfer_plan`` splits the pairs over
the card from the shape alone, with the kernel's limits read from the
library (``chamfer_limits``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from im23d_tpu_torch.ops import _build

# y points per step of the plain version's loop
_M_CHUNK = 256


def nn_dist2_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distance of each x point to its nearest y point, in the
    direct ``dz² + dy² + dx²`` form of the kernel, y taken in chunks so the
    (N, M) distance matrix never exists whole."""
    best = torch.full(x.shape[:2], float("inf"), dtype=x.dtype, device=x.device)
    xz, xy, xx = (x[..., i, None] for i in range(3))  # (B, N, 1)
    for m0 in range(0, y.shape[1], _M_CHUNK):
        yc = y[:, None, m0:m0 + _M_CHUNK]  # (B, 1, mc, 3)
        dz, dy, dx = yc[..., 0] - xz, yc[..., 1] - xy, yc[..., 2] - xx
        best = torch.minimum(best, (dz * dz + dy * dy + dx * dx).amin(-1))
    return best


def nn_dist2_pair_torch(a: torch.Tensor, b: torch.Tensor):
    """Plain version of K3's pair mode: (a -> b, b -> a) nearest squared
    distances, (B, Na) and (B, Nb)."""
    return nn_dist2_torch(a, b), nn_dist2_torch(b, a)


class ChamferLimits(NamedTuple):
    """What ``chamfer_plan`` reads from the kernel library
    (``im23d_chamfer_limits``): the card's multiprocessors, then the
    kernel's warps a CTA, x points a warp and y points a block."""
    sms: int
    warps: int
    rows: int
    cols: int


def chamfer_plan(B: int, N: int, M: int, lim: ChamferLimits) -> dict:
    """K3's split of B clouds of N x points by M y points.

    A warp holds ``lim.rows`` x points and walks a group of ``ny`` blocks
    of ``lim.cols`` y points; ``xwarps`` = ceil(N / rows) warps cover a
    cloud's x points, ``groups`` = ceil(blocks / ny) groups its y points,
    so each pair is one warp's.  CTAs are ``lim.warps`` warps.  ``ny`` is
    the one that minimises ceil(ctas / sms) · ny (the CTAs of the busiest
    multiprocessor times a CTA's blocks); at a tie, one that gives every
    multiprocessor a CTA, then the fewest groups: rows
    split over groups, and columns over x warps, are combined by atomics
    into a memset output (``row_red``, ``col_red`` in pair mode).
    ``note`` says why a plan has fewer CTAs than multiprocessors."""
    if min(B, N, M) < 1:
        raise ValueError(f"chamfer_plan needs B, N, M >= 1, got {B, N, M}")
    xwarps = -(-N // lim.rows)
    blocks = -(-M // lim.cols)
    best = None
    for groups in sorted({-(-blocks // ny) for ny in range(1, blocks + 1)}):
        ny = -(-blocks // groups)
        ctas = -(-B * xwarps * groups // lim.warps)
        key = (-(-ctas // lim.sms) * ny, ctas < lim.sms, groups)
        if best is None or key < best[0]:
            best = (key, ny, groups, ctas)
    _, ny, groups, ctas = best
    plan = dict(ny=ny, groups=groups, xwarps=xwarps, ctas=ctas,
                smem=lim.warps * lim.cols * 16, row_red=groups > 1,
                col_red=xwarps > 1)
    if ctas < lim.sms:
        plan["note"] = (f"{B} x {xwarps} x {groups} warps of work make "
                        f"{ctas} CTAs of {lim.warps}: fewer than "
                        f"{lim.sms} multiprocessors")
    return plan


def chamfer_tiles(B: int, N: int, M: int, plan: dict, lim: ChamferLimits):
    """The kernel's warps as (b, n0, n1, m0, m1): the x points [n0, n1) and
    y points [m0, m1) each pairs, in launch order."""
    blocks = -(-M // lim.cols)
    for g in range(B * plan["xwarps"] * plan["groups"]):
        xw, rest = g % plan["xwarps"], g // plan["xwarps"]
        yg, b = rest % plan["groups"], rest // plan["groups"]
        j0, j1 = yg * plan["ny"], min(blocks, (yg + 1) * plan["ny"])
        if j0 >= j1:
            continue
        yield (b, xw * lim.rows, min(N, (xw + 1) * lim.rows),
               j0 * lim.cols, min(M, j1 * lim.cols))


_CHAMFER_LIMITS: dict = {}


def chamfer_limits(dev: torch.device) -> ChamferLimits:
    """``ChamferLimits`` of CUDA device ``dev``, read from the library
    once."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _CHAMFER_LIMITS:
        lib = _build.load_kernels()
        out = (ctypes.c_int * len(ChamferLimits._fields))()
        _build.check(lib, lib.im23d_chamfer_limits(key, out),
                     "chamfer limits")
        _CHAMFER_LIMITS[key] = ChamferLimits(*out)
    return _CHAMFER_LIMITS[key]


def _check_clouds(what: str, x: torch.Tensor, y: torch.Tensor):
    dev = x.device
    if dev.type != "cuda" or y.device != dev:
        raise ValueError(f"{what} needs CUDA tensors on one device, got "
                         f"{x.device} and {y.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, n, 3) tensor, "
                             f"got {tuple(t.shape)}")
    B, N, _ = x.shape
    M = y.shape[1]
    if y.shape[0] != B or min(B, N, M) < 1:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(y.shape)} do "
                         "not pair up")
    return dev, B, N, M


# the wrappers' plans, kept for the shapes seen (a few a process)
_plan = functools.lru_cache(maxsize=64)(chamfer_plan)


def _launch(x, y, rows, cols, dev, B: int, N: int, M: int) -> None:
    plan = _plan(B, N, M, chamfer_limits(dev))
    lib = _build.load_kernels()
    rc = lib.im23d_chamfer(x.data_ptr(), y.data_ptr(), rows.data_ptr(),
                           None if cols is None else cols.data_ptr(), B, N,
                           M, plan["ny"],
                           torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(lib, rc, "chamfer kernel (K3)")


def nn_dist2_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K3 in its rows-only mode on (B, N, 3) and (B, M, 3) float32
    contiguous CUDA tensors: (B, N).

    Replaces the Pallas kernel ``_nn_kernel``
    (``im23d_tpu/metrics/chamfer.py:56``).  Bound by CUDA-core arithmetic
    (B·N·M distances); a warp holds 256 x points in registers and walks
    blocks of 128 y points staged in shared memory (``csrc/nn_dist2.cu``),
    split over the card by ``chamfer_plan``.
    """
    dev, B, N, M = _check_clouds("nn_dist2_kernel", x, y)
    rows = torch.empty((B, N), dtype=torch.float32, device=dev)
    _launch(x, y, rows, None, dev, B, N, M)
    nn_dist2_kernel.launches += 1
    return rows


nn_dist2_kernel.launches = 0


def chamfer_kernel(a: torch.Tensor, b: torch.Tensor):
    """Launch K3 in its pair mode: (a -> b, b -> a) nearest squared
    distances, (B, Na) and (B, Nb), from one pass over the pairs.  The
    larger cloud takes the x role (its points in registers); the values do
    not depend on the roles."""
    swap = b.shape[1] > a.shape[1]
    x, y = (b, a) if swap else (a, b)
    dev, B, N, M = _check_clouds("chamfer_kernel", x, y)
    rows = torch.empty((B, N), dtype=torch.float32, device=dev)
    cols = torch.empty((B, M), dtype=torch.float32, device=dev)
    _launch(x, y, rows, cols, dev, B, N, M)
    chamfer_kernel.launches += 1
    return (cols, rows) if swap else (rows, cols)


chamfer_kernel.launches = 0


def nn_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour squared distances: plain on CPU, K3 on CUDA."""
    if x.device.type == "cpu":
        return nn_dist2_torch(x, y)
    return nn_dist2_kernel(x.float().contiguous(), y.float().contiguous())


def chamfer_distance(a: torch.Tensor, b: torch.Tensor, sqrt: bool = False):
    """Symmetric Chamfer distance; returns (total, a->b term, b->a term).
    With ``sqrt`` each nearest distance is ``sqrt(max(d², 1e-12))`` before
    the means (Chamfer-L1 of distances, as the JAX function).  Plain on
    CPU; one K3 launch for both directions on CUDA."""
    if a.device.type == "cpu":
        d_ab, d_ba = nn_dist2_pair_torch(a, b)
    else:
        d_ab, d_ba = chamfer_kernel(a.float().contiguous(),
                                    b.float().contiguous())
    if sqrt:
        d_ab = torch.sqrt(torch.clamp(d_ab, min=1e-12))
        d_ba = torch.sqrt(torch.clamp(d_ba, min=1e-12))
    t1 = d_ab.mean(-1)
    t2 = d_ba.mean(-1)
    return t1 + t2, t1, t2
