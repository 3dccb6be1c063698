"""Triangle rasterization, DIB-R style (counterpart of
``im23d_tpu/render/rasterizer.py``).

* Hard pass: per pixel, the front-most (largest interpolated z) front-facing
  covering face wins and its per-corner attributes are barycentrically
  interpolated.  Faces are taken in chunks of 32 in face order: within a
  chunk, faces whose z equals the chunk's maximum share the pixel (their
  attributes are count-averaged); across chunks a strictly larger z wins, so
  an earlier chunk keeps a tie.  Pixels that no face covers get 0.
* Soft pass: ``1 - prod_f (1 - exp(-d_f^2 / sigma))`` over front faces,
  ``d_f`` the pixel's distance to face f (0 inside), each factor clamped
  at 1 - 1e-7.

``rasterize`` runs the plain ``rasterize_torch`` on CPU tensors and the CUDA
kernel K4 (``csrc/rasterize.cu``) on CUDA tensors; where a gradient is
needed, K4's forward also writes each pixel's winner and K4's backward is
the gradient (``_Rasterize``).  The gradient is the plain version's
autograd: the winners are a mask (d z = 0), d feat reaches the corners
through the winning chunk's barycentrics, d soft through the nearest edge
of each face.

Screen convention: vertex x, y in NDC [-1, 1], y up (image row 0 is y = +1);
larger z is closer.  Front faces wind counter-clockwise on screen.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from im23d_tpu_torch.ops import _build

FACE_CHUNK = 32
# most attributes per face corner K4 takes (the renderer uses 3: u, v, mask)
MAX_ATTRS = 8
_NEG_BIG = -1e9


def _pixel_grid(height: int, width: int, dtype, device):
    ys = 1.0 - (torch.arange(height, dtype=dtype, device=device) + 0.5) * (
        2.0 / height)
    xs = (torch.arange(width, dtype=dtype, device=device) + 0.5) * (
        2.0 / width) - 1.0
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    return px, py


def _edge(ax, ay, bx, by, px, py):
    """Signed area of (a, b, p): positive if p is left of a->b (CCW)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _point_segment_dist2(px, py, ax, ay, bx, by):
    """Squared distance from pixel p to segment a-b (broadcast shapes)."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby
    t = torch.clamp((apx * abx + apy * aby) / torch.clamp(denom, min=1e-12),
                    0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def _chunk_step(best_z, best_feat, log_miss, cfv, cattr, px, py, sigma,
                cull_backfaces):
    """One chunk of faces: the chunk's winners update the z-buffer and the
    interpolated attributes, its faces' coverage adds to log_miss."""
    B, height, width, A = best_feat.shape
    dt = best_z.dtype
    x = cfv[..., 0][..., None, None]       # (B, C, 3, 1, 1)
    y = cfv[..., 1][..., None, None]
    zc = cfv[..., 2]                       # (B, C, 3)
    x0, x1, x2 = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, C, 1, 1)
    y0, y1, y2 = y[:, :, 0], y[:, :, 1], y[:, :, 2]

    area = _edge(x0, y0, x1, y1, x2, y2)
    front = area > 1e-9 if cull_backfaces else torch.abs(area) > 1e-9
    e01 = _edge(x0, y0, x1, y1, px, py)    # (B, C, H, W)
    e12 = _edge(x1, y1, x2, y2, px, py)
    e20 = _edge(x2, y2, x0, y0, px, py)
    # signed inverse area: barycentrics stay right for clockwise faces
    # when back faces are drawn
    inv_area = 1.0 / torch.where(torch.abs(area) > 1e-9, area,
                                 torch.ones_like(area))
    w0 = e12 * inv_area
    w1 = e20 * inv_area
    w2 = e01 * inv_area
    inside = (e01 >= 0) & (e12 >= 0) & (e20 >= 0)
    if not cull_backfaces:
        inside = inside | ((e01 <= 0) & (e12 <= 0) & (e20 <= 0))
    inside = inside & front
    z = (w0 * zc[:, :, 0, None, None] + w1 * zc[:, :, 1, None, None]
         + w2 * zc[:, :, 2, None, None])
    z_masked = torch.where(inside, z, torch.full_like(z, _NEG_BIG))

    # the chunk's winners as a mask (ties share an edge: their
    # interpolated attributes agree, and the count averages them)
    cz = z_masked.amax(dim=1)              # (B, H, W)
    wsel = (inside & (z_masked >= cz[:, None])).to(dt)
    cnt = torch.clamp(wsel.sum(dim=1), min=1.0)
    C = wsel.shape[1]
    m0 = (w0 * wsel).reshape(B, C, -1)
    m1 = (w1 * wsel).reshape(B, C, -1)
    m2 = (w2 * wsel).reshape(B, C, -1)
    cfeat = (torch.einsum("bcp,bca->bpa", m0, cattr[:, :, 0])
             + torch.einsum("bcp,bca->bpa", m1, cattr[:, :, 1])
             + torch.einsum("bcp,bca->bpa", m2, cattr[:, :, 2])
             ).reshape(B, height, width, A) / cnt[..., None]
    better = cz > best_z
    best_feat = torch.where(better[..., None], cfeat, best_feat)
    best_z = torch.where(better, cz, best_z)

    d2 = torch.minimum(
        torch.minimum(_point_segment_dist2(px, py, x0, y0, x1, y1),
                      _point_segment_dist2(px, py, x1, y1, x2, y2)),
        _point_segment_dist2(px, py, x2, y2, x0, y0))
    d2 = torch.where(inside, torch.zeros_like(d2), d2)
    cov = torch.where(front, torch.exp(-d2 / sigma), torch.zeros_like(d2))
    log_miss = log_miss + torch.log1p(
        -torch.clamp(cov, max=1.0 - 1e-7)).sum(dim=1)
    return best_z, best_feat, log_miss


def rasterize_torch(verts: torch.Tensor, faces: torch.Tensor,
                    attrs: torch.Tensor, height: int, width: int,
                    sigma: float = 1e-4, cull_backfaces: bool = True):
    """Plain rasterizer: verts (B, V, 3), faces (F, 3) int, attrs
    (B, F, 3, A) -> feat (B, H, W, A), soft (B, H, W, 1).

    The JAX version's chunk loop, operation by operation: faces in chunks of
    ``FACE_CHUNK``, so the largest intermediate is (B, chunk, H, W), never
    (B, F, H, W).  Under autograd each chunk is checkpointed, as the JAX
    version remats its scan step: the backward recomputes one chunk's
    intermediates at a time instead of keeping all of them.
    """
    B = verts.shape[0]
    F = faces.shape[0]
    A = attrs.shape[-1]
    dt, dev = verts.dtype, verts.device
    px, py = _pixel_grid(height, width, dt, dev)
    faces = faces.to(device=dev, dtype=torch.int64)
    n_chunks = -(-F // FACE_CHUNK)
    pad = n_chunks * FACE_CHUNK - F
    if pad:  # padded faces are degenerate (all corners vertex 0): never drawn
        faces = torch.cat([faces, faces.new_zeros((pad, 3))])
        attrs = torch.cat([attrs, attrs.new_zeros((B, pad, 3, A))], dim=1)
    fv = verts[:, faces]  # (B, F_pad, 3 corners, 3 xyz)
    remat = torch.is_grad_enabled() and (fv.requires_grad
                                         or attrs.requires_grad)

    carry = (torch.full((B, height, width), _NEG_BIG, dtype=dt, device=dev),
             torch.zeros((B, height, width, A), dtype=dt, device=dev),
             torch.zeros((B, height, width), dtype=dt, device=dev))
    for c0 in range(0, n_chunks * FACE_CHUNK, FACE_CHUNK):
        args = (*carry, fv[:, c0:c0 + FACE_CHUNK],
                attrs[:, c0:c0 + FACE_CHUNK], px, py, sigma, cull_backfaces)
        carry = (checkpoint(_chunk_step, *args, use_reentrant=False)
                 if remat else _chunk_step(*args))
    best_z, best_feat, log_miss = carry

    covered = best_z > _NEG_BIG * 0.5
    feat = torch.where(covered[..., None], best_feat,
                       torch.zeros_like(best_feat))
    soft = (1.0 - torch.exp(log_miss))[..., None]
    return feat, soft


def soft_margin(sigma: float) -> float:
    """NDC distance beyond which a face's coverage exp(-d²/sigma) is 0 in
    float32 (expf underflows to 0 below -103.97): K4 may skip the face
    there without changing a bit of the soft silhouette."""
    return math.sqrt(104.0 * sigma)


def _check_operands(fv: torch.Tensor, attrs: torch.Tensor, height: int,
                    width: int) -> None:
    dev = fv.device
    if dev.type != "cuda" or attrs.device != dev:
        raise ValueError(f"K4 needs CUDA tensors on one device, got "
                         f"{fv.device} and {attrs.device}")
    for name, t in (("verts", fv), ("attrs", attrs)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    B, F = fv.shape[:2]
    A = attrs.shape[-1]
    if fv.shape[2:] != (3, 3) or attrs.shape[:3] != (B, F, 3):
        raise ValueError(f"face corners {tuple(fv.shape)} and attributes "
                         f"{tuple(attrs.shape)} do not pair up")
    if not 1 <= A <= MAX_ATTRS:
        raise ValueError(f"K4 takes 1 to {MAX_ATTRS} attributes, got {A}")
    if min(B, height, width) < 1:
        raise ValueError(f"empty raster: B={B}, {height} x {width}")


def _launch_forward(fv: torch.Tensor, attrs: torch.Tensor, height: int,
                    width: int, sigma: float, cull_backfaces: bool,
                    winners: bool):
    """K4 forward on gathered face corners fv (B, F, 3, 3); with
    ``winners`` also the winner cache (win int32, wz float32, (B, H, W))."""
    _check_operands(fv, attrs, height, width)
    dev = fv.device
    B, F = fv.shape[:2]
    A = attrs.shape[-1]
    fv, attrs = fv.contiguous(), attrs.contiguous()
    feat = torch.empty((B, height, width, A), dtype=torch.float32, device=dev)
    soft = torch.empty((B, height, width, 1), dtype=torch.float32, device=dev)
    win = wz = None
    if winners:
        win = torch.empty((B, height, width), dtype=torch.int32, device=dev)
        wz = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    lib = _build.load_kernels()
    rc = lib.im23d_rasterize_fwd(
        fv.data_ptr(), attrs.data_ptr(), feat.data_ptr(), soft.data_ptr(),
        win.data_ptr() if winners else None,
        wz.data_ptr() if winners else None,
        B, F, A, height, width, float(np.float32(2.0 / width)),
        float(np.float32(2.0 / height)), float(sigma), soft_margin(sigma),
        int(cull_backfaces), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rasterize kernel (K4)")
    rasterize_kernel.launches += 1
    return feat, soft, win, wz


def _gather_corners(verts: torch.Tensor, faces: torch.Tensor):
    """verts (B, V, 3), faces (F, 3) -> face corners fv (B, F, 3, 3), the
    kernels' operand (done in torch; its autograd scatters d fv onto the
    vertices)."""
    if verts.dim() != 3 or verts.shape[-1] != 3 or faces.dim() != 2 \
            or faces.shape[1] != 3:
        raise ValueError(f"shapes {tuple(verts.shape)} and "
                         f"{tuple(faces.shape)} are not (B, V, 3), (F, 3)")
    return verts[:, faces.to(device=verts.device, dtype=torch.int64)]


def rasterize_kernel(verts: torch.Tensor, faces: torch.Tensor,
                     attrs: torch.Tensor, height: int, width: int,
                     sigma: float = 1e-4, cull_backfaces: bool = True):
    """Launch K4 (forward) on CUDA tensors; same contract as
    ``rasterize_torch``.

    Replaces the Pallas kernel ``_fwd_kernel``
    (``im23d_tpu/render/rasterizer_pallas.py:216``).  Bound by arithmetic
    on the CUDA cores (edge functions, segment distances and one exp and
    one log1p per pixel and nearby face); one thread per pixel, faces staged
    through shared memory 32 at a time in face order, chunks and faces that
    cannot touch a tile skipped block-uniformly (see ``csrc/rasterize.cu``).
    """
    return _launch_forward(_gather_corners(verts, faces), attrs, height,
                           width, sigma, cull_backfaces, winners=False)[:2]


rasterize_kernel.launches = 0


def rasterize_backward_kernel(fv: torch.Tensor, attrs: torch.Tensor,
                              dfeat: torch.Tensor | None,
                              dsoft: torch.Tensor | None, soft: torch.Tensor,
                              win: torch.Tensor, wz: torch.Tensor,
                              height: int, width: int, sigma: float = 1e-4,
                              cull_backfaces: bool = True):
    """Launch K4's backward: (d fv (B, F, 3, 3), d attrs (B, F, 3, A)) from
    d feat (B, H, W, A) and d soft (B, H, W, 1) (either None), with the
    forward's soft and winner cache.

    Replaces the Pallas kernel ``_bwd_kernel``
    (``im23d_tpu/render/rasterizer_pallas.py:346``).  A gather, face-major:
    one warp per (image, face) walks the pixels of the face's box widened
    by ``soft_margin(sigma)``, takes the winner test from the forward's
    cache (no walk over the other faces), sums in registers and reduces
    once; plain stores, no atomics, the same result on every launch (see
    ``csrc/rasterize.cu``).
    """
    _check_operands(fv, attrs, height, width)
    dev = fv.device
    B, F = fv.shape[:2]
    A = attrs.shape[-1]
    fv, attrs = fv.contiguous(), attrs.contiguous()

    def upstream(t, shape):
        if t is None:
            return None
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"gradient {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {dev}")
        return t.float().contiguous()

    dfeat = upstream(dfeat, (B, height, width, A))
    dsoft = upstream(dsoft, (B, height, width, 1))
    for name, t, dt in (("soft", soft, torch.float32),
                        ("win", win, torch.int32), ("wz", wz, torch.float32)):
        if t.dtype != dt or t.numel() != B * height * width \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: not the forward's {dt} (B, H, W) "
                             f"output")
    if dfeat is None and dsoft is None:
        return torch.zeros_like(fv), torch.zeros_like(attrs)
    dfv = torch.empty_like(fv)
    dattrs = torch.empty_like(attrs)
    lib = _build.load_kernels()
    rc = lib.im23d_rasterize_bwd(
        fv.data_ptr(), attrs.data_ptr(),
        None if dfeat is None else dfeat.data_ptr(),
        None if dsoft is None else dsoft.data_ptr(), soft.data_ptr(),
        win.data_ptr(), wz.data_ptr(), dfv.data_ptr(), dattrs.data_ptr(),
        B, F, A, height, width, float(np.float32(2.0 / width)),
        float(np.float32(2.0 / height)), float(sigma), soft_margin(sigma),
        int(cull_backfaces), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rasterize backward kernel (K4 bwd)")
    rasterize_backward_kernel.launches += 1
    return dfv, dattrs


rasterize_backward_kernel.launches = 0


def rasterize_backward_torch(fv: torch.Tensor, attrs: torch.Tensor,
                             dfeat: torch.Tensor | None,
                             dsoft: torch.Tensor | None, height: int,
                             width: int, sigma: float = 1e-4,
                             cull_backfaces: bool = True):
    """Plain backward: (d fv, d attrs) by autograd of ``rasterize_torch``
    on the face corners fv (B, F, 3, 3) (each corner its own vertex)."""
    B, F = fv.shape[:2]
    faces = torch.arange(3 * F, device=fv.device).reshape(F, 3)
    with torch.enable_grad():
        v = fv.detach().reshape(B, 3 * F, 3).requires_grad_()
        a = attrs.detach().requires_grad_()
        feat, soft = rasterize_torch(v, faces, a, height, width, sigma,
                                     cull_backfaces)
        outs = [(o, g) for o, g in ((feat, dfeat), (soft, dsoft))
                if g is not None]
        dv, da = torch.autograd.grad([o for o, _ in outs],
                                     [v, a], [g for _, g in outs],
                                     allow_unused=True)
    dv = torch.zeros_like(v) if dv is None else dv
    da = torch.zeros_like(a) if da is None else da
    return dv.reshape(fv.shape), da


class _Rasterize(torch.autograd.Function):
    """K4 forward with the winner cache; K4 backward as its gradient, into
    the face corners fv and the attributes (CUDA, float32)."""

    @staticmethod
    def forward(ctx, fv, attrs, height, width, sigma, cull_backfaces):
        feat, soft, win, wz = _launch_forward(fv, attrs, height, width, sigma,
                                              cull_backfaces, winners=True)
        ctx.save_for_backward(fv, attrs, soft, win, wz)
        ctx.cfg = (height, width, sigma, cull_backfaces)
        ctx.set_materialize_grads(False)
        return feat, soft

    @staticmethod
    def backward(ctx, dfeat, dsoft):
        fv, attrs, soft, win, wz = ctx.saved_tensors
        dfv, dattrs = rasterize_backward_kernel(fv, attrs, dfeat, dsoft, soft,
                                                win, wz, *ctx.cfg)
        need_fv, need_attrs = ctx.needs_input_grad[:2]
        return (dfv if need_fv else None, dattrs if need_attrs else None,
                None, None, None, None)


def rasterize(verts: torch.Tensor, faces: torch.Tensor, attrs: torch.Tensor,
              height: int, width: int, sigma: float = 1e-4,
              cull_backfaces: bool = True):
    """Rasterize meshes to interpolated attributes and soft coverage: plain
    on CPU; K4 on CUDA (float32), with K4's backward as the gradient when
    one is needed (torch's indexing autograd scatters d fv onto the
    vertices)."""
    if verts.device.type == "cpu":
        return rasterize_torch(verts, faces, attrs, height, width, sigma,
                               cull_backfaces)
    fv, attrs = _gather_corners(verts.float(), faces), attrs.float()
    if torch.is_grad_enabled() and (fv.requires_grad or attrs.requires_grad):
        return _Rasterize.apply(fv, attrs, height, width, sigma,
                                cull_backfaces)
    return _launch_forward(fv, attrs, height, width, sigma, cull_backfaces,
                           winners=False)[:2]
