"""Frozen plain copy of the mesh template, the renderer and their ops
(UV sphere, template deformation, quaternion posing, the chunked
rasterizer, bilinear texture lookup), in plain PyTorch.

The benchmark's reference for the port's render path: it imports nothing
of the program, and the program's later changes do not reach it.  The
rasterizer is the port's plain version, face chunk by face chunk (under
autograd each chunk is checkpointed); the texture lookup is the
four-corner gather with align_corners=True and zero padding.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

FACE_CHUNK = 32
_NEG_BIG = -1e9


class Mesh(NamedTuple):
    vertices: np.ndarray
    uvs: np.ndarray
    faces: np.ndarray
    face_uvs: np.ndarray


def uv_sphere(segments: int = 32, rings: int = 16) -> Mesh:
    """Blender-style UV sphere with per-face UV indices.

    Geometry: ``rings - 1`` latitude rings of ``segments`` vertices plus two
    poles; quads split into triangles, triangle fans at the poles.  UV layout
    matches Blender's default sphere projection: u = seg/segments,
    v = ring/rings, pole triangles get centered u at the pole vertex.  This
    reproduces the combinatorics of the reference's shipped templates
    (16-ring: 482 verts / 960 faces; 31-ring: 962 / 1920).
    """
    verts = []
    for r in range(1, rings):
        phi = math.pi * r / rings  # from north pole
        y = math.cos(phi)
        s = math.sin(phi)
        for g in range(segments):
            theta = 2.0 * math.pi * g / segments
            # x spans the symmetry axis: x = s*sin(theta), z = -s*cos(theta)
            verts.append([s * math.sin(theta), y, -s * math.cos(theta)])
    north = len(verts)
    verts.append([0.0, 1.0, 0.0])
    south = len(verts)
    verts.append([0.0, -1.0, 0.0])

    def vid(r, g):  # ring r in [1, rings-1], segment g wraps
        return (r - 1) * segments + (g % segments)

    uv_list: list[tuple[float, float]] = []
    uv_cache: dict[tuple[float, float], int] = {}

    def uv_id(u, v):
        key = (round(u, 6), round(v, 6))
        if key not in uv_cache:
            uv_cache[key] = len(uv_list)
            uv_list.append(key)
        return uv_cache[key]

    faces, face_uvs = [], []

    def add_face(vis, uvs_):
        faces.append(vis)
        face_uvs.append([uv_id(u, v) for (u, v) in uvs_])

    for g in range(segments):
        u0 = g / segments
        u1 = (g + 1) / segments
        # north pole fan (v = 1 at pole in OBJ convention: v measured from south)
        add_face(
            [north, vid(1, g), vid(1, g + 1)],
            [((u0 + u1) / 2, 1.0), (u0, 1.0 - 1.0 / rings), (u1, 1.0 - 1.0 / rings)],
        )
        # body quads
        for r in range(1, rings - 1):
            v_hi = 1.0 - r / rings
            v_lo = 1.0 - (r + 1) / rings
            a, b = vid(r, g), vid(r, g + 1)
            c, d = vid(r + 1, g), vid(r + 1, g + 1)
            add_face([a, c, d], [(u0, v_hi), (u0, v_lo), (u1, v_lo)])
            add_face([a, d, b], [(u0, v_hi), (u1, v_lo), (u1, v_hi)])
        # south pole fan
        add_face(
            [south, vid(rings - 1, g + 1), vid(rings - 1, g)],
            [((u0 + u1) / 2, 0.0), (u1, 1.0 / rings), (u0, 1.0 / rings)],
        )

    faces_a = np.asarray(faces, np.int32)
    face_uvs_a = np.asarray(face_uvs, np.int32)
    # flip winding so normals point outward (CCW seen from outside)
    faces_a = faces_a[:, [0, 2, 1]]
    face_uvs_a = face_uvs_a[:, [0, 2, 1]]
    return Mesh(
        np.asarray(verts, np.float32),
        np.asarray(uv_list, np.float32),
        faces_a,
        face_uvs_a,
    )


def qnormalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=eps)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., N, 3) by unit quaternions ``q`` (..., 4).

    Cross-product form v + 2*(w*(u x v) + u x (u x v)); ``q`` must already
    be unit length.
    """
    u = q[..., None, 1:4]
    w = q[..., None, :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


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
                cull_backfaces, keep=None):
    """One chunk of faces: the chunk's winners update the z-buffer and the
    interpolated attributes, its faces' coverage adds to log_miss.  With
    ``keep`` (B, C, H, W) bool, a pixel-face pair outside it is skipped: not
    inside, coverage 0 (``rasterize_binned_torch``)."""
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
    if keep is not None:
        inside = inside & keep
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
    if keep is not None:
        cov = torch.where(keep, cov, torch.zeros_like(cov))
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


def fragment_shader(texcoords: torch.Tensor, texture: torch.Tensor,
                    mask: torch.Tensor,
                    background: torch.Tensor | None = None) -> torch.Tensor:
    """Sample the NHWC texture at the rasterized UVs and composite with the
    mask."""
    grid = texcoords * 2.0 - 1.0
    grid = grid * grid.new_tensor([1.0, -1.0])  # flip v
    color = grid_sample_bilinear_torch(texture, grid)  # (B, H, W, C)
    if background is None:
        return color * mask
    return background + (color - background) * mask


def compute_face_normals(verts: torch.Tensor,
                         faces: torch.Tensor) -> torch.Tensor:
    a = verts[:, faces[:, 0]]
    b = verts[:, faces[:, 1]]
    c = verts[:, faces[:, 2]]
    n = torch.linalg.cross(b - a, c - a, dim=-1)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-12)


def render_mesh(verts: torch.Tensor, faces: torch.Tensor, uvs: torch.Tensor,
                face_uvs: torch.Tensor, texture: torch.Tensor, height: int,
                width: int, background: torch.Tensor | None = None,
                return_hardmask: bool = False, sigma: float = 1e-4,
                cull_backfaces: bool = True):
    """Render textured meshes orthographically.

    verts (B, V, 3) NDC (x right, y up, larger z closer); faces (F, 3);
    uvs (B, T, 2); face_uvs (F, 3); texture (B, Ht, Wt, C), NHWC and already
    boundary-prepared.  Returns (image (B, H, W, C), alpha (B, H, W, 1),
    face normals (B, F, 3)).
    """
    B = verts.shape[0]
    F = faces.shape[0]
    uv_corners = uvs[:, face_uvs]  # (B, F, 3, 2)
    mask_attr = verts.new_ones((B, F, 3, 1))
    attrs = torch.cat([uv_corners, mask_attr], dim=-1)  # (B, F, 3, 3)
    feat, soft = rasterize_torch(verts, faces, attrs, height, width, sigma,
                           cull_backfaces)
    texcoords = feat[..., :2]
    hardmask = feat[..., 2:3]
    image = fragment_shader(texcoords, texture, hardmask, background)
    alpha = hardmask if return_hardmask else soft
    return image, alpha, compute_face_normals(verts, faces)


def _face_adjacency(faces: np.ndarray) -> np.ndarray:
    """(F, 3) index of the face across each edge of each face (the face
    itself on an open edge)."""
    edge_to_faces: dict[tuple[int, int], list[int]] = {}
    for fi, (a, b, c) in enumerate(faces):
        for e in [(a, b), (b, c), (c, a)]:
            edge_to_faces.setdefault((min(e), max(e)), []).append(fi)
    ff = np.zeros((len(faces), 3), np.int32)
    for fi, (a, b, c) in enumerate(faces):
        for k, e in enumerate([(a, b), (b, c), (c, a)]):
            adj = [f for f in edge_to_faces[(min(e), max(e))] if f != fi]
            ff[fi, k] = adj[0] if adj else fi
    return ff


class MeshTemplate:
    """Host-side precompute and tensor-side deformation of a UV sphere."""

    def __init__(self, mesh: Mesh | None = None,
                 is_symmetric: bool = True, segments: int = 32,
                 rings: int = 16):
        if mesh is None:
            mesh = uv_sphere(segments=segments, rings=rings)
        if mesh.uvs is not None and len(mesh.uvs):
            # ring and segment counts from the mesh itself: a UV sphere's v
            # chart has rings + 1 latitudes and (rings - 1) * segments + 2
            # vertices
            vs = np.unique(np.round(np.asarray(mesh.uvs)[:, 1], 5))
            inf_rings = len(vs) - 1
            n_body = len(mesh.vertices) - 2
            if inf_rings > 1 and n_body % (inf_rings - 1) == 0:
                segments, rings = n_body // (inf_rings - 1), inf_rings
            else:
                raise ValueError(
                    f"mesh is not a UV sphere: {inf_rings + 1} uv latitudes "
                    f"inconsistent with {len(mesh.vertices)} vertices")
        self.mesh = mesh
        self.is_symmetric = is_symmetric
        self.segments = segments
        self.rings = rings

        v = mesh.vertices
        self.poles = [int(np.argmax(v[:, 1])), int(np.argmin(v[:, 1]))]

        # symmetry index sets about the x axis
        neg = np.nonzero(v[:, 0] < -1e-4)[0]
        zero = np.nonzero(np.abs(v[:, 0]) < 1e-4)[0]
        pos = []
        for idx in neg:
            mirrored = v[idx].copy()
            mirrored[0] *= -1
            dists = np.linalg.norm(v - mirrored, axis=-1)
            j = int(np.argmin(dists))
            if dists[j] >= 1e-4:
                raise ValueError(f"vertex {idx} has no mirror image")
            pos.append(j)
        pos = np.asarray(pos, np.int64)
        if (len(pos) != len(set(pos.tolist()))
                or len(pos) + len(neg) + len(zero) != len(v)):
            raise ValueError("the mesh is not symmetric about x = 0")
        self.neg_indices = neg.astype(np.int64)
        self.pos_indices = pos
        self.zero_indices = zero.astype(np.int64)
        self.nonneg_indices = np.concatenate([pos, zero]).astype(np.int64)

        # per-vertex UV topo map from the face UVs, u wrapping around
        seg, rng = self.segments, self.rings
        accum: dict[int, list[np.ndarray]] = {}
        for f_uv, f_v in zip(mesh.face_uvs, mesh.faces):
            for t, vert in zip(f_uv, f_v):
                res = mesh.uvs[t] * [seg, rng]
                if abs(res[0] - seg) < 1e-4:
                    res = res.copy()
                    res[0] = 0.0
                accum.setdefault(int(vert), []).append(res)
        topo = np.zeros((len(v), 2), np.float32)
        for idx, vals in accum.items():
            topo[idx] = np.mean(np.asarray(vals, np.float32), axis=0) / [seg,
                                                                         rng]
        topo = topo * 2.0 - 1.0
        topo = topo * np.asarray([1.0, -1.0], np.float32)  # flip v
        self.topo_map = topo
        self.nonneg_topo_map = topo[self.nonneg_indices]

        # x = 0 for the vertices on the symmetry plane
        symmetry_mask = np.ones_like(v)
        symmetry_mask[zero, 0] = 0.0
        self.symmetry_mask = symmetry_mask

        # normal / tangent / bitangent frames, zero tangents at the poles
        normals = v / np.linalg.norm(v, axis=1, keepdims=True)
        up = np.asarray([[0.0, 1.0, 0.0]], np.float32)
        tangents = np.cross(normals, np.broadcast_to(up, normals.shape))
        t_norm = np.linalg.norm(tangents, axis=1, keepdims=True)
        tangents = tangents / np.maximum(t_norm, 1e-12)
        bitangents = np.cross(normals, tangents)
        for p in self.poles:
            tangents[p] = 0.0
            bitangents[p] = 0.0
        self.tangent_map = np.stack([normals, tangents, bitangents],
                                    axis=1).astype(np.float32)  # (V, 3, 3)
        self.nonneg_tangent_map = self.tangent_map[self.nonneg_indices]

        self.ff = _face_adjacency(mesh.faces)
        self._host = dict(
            vertices=mesh.vertices, faces=mesh.faces.astype(np.int64),
            face_uvs=mesh.face_uvs.astype(np.int64), uvs=mesh.uvs,
            symmetry_mask=symmetry_mask, nonneg_idx=self.nonneg_indices,
            neg_idx=self.neg_indices, pos_idx=self.pos_indices,
            ff=self.ff.astype(np.int64),
            tangent=(self.nonneg_tangent_map if is_symmetric
                     else self.tangent_map),
        )
        self._tensors: dict[tuple, torch.Tensor] = {}

    @property
    def num_vertices(self) -> int:
        return int(self.mesh.vertices.shape[0])

    def tensor(self, name: str, device) -> torch.Tensor:
        """A template constant (``faces``, ``face_uvs``, ``uvs``, ``ff``,
        ...) as a tensor on ``device``, made once per device."""
        key = (name, str(torch.device(device)))
        t = self._tensors.get(key)
        if t is None:
            t = torch.as_tensor(np.ascontiguousarray(self._host[name]),
                                device=device)
            self._tensors[key] = t
        return t

    def deform(self, deltas: torch.Tensor) -> torch.Tensor:
        """Local (normal, tangent, bitangent) displacements -> object
        space."""
        return torch.einsum("bvi,vij->bvj", deltas,
                            self.tensor("tangent", deltas.device))

    def compute_normals(self, vertex_positions: torch.Tensor) -> torch.Tensor:
        """(B, F, 3) unit face normals of (B, V, 3) vertex positions."""
        faces = self.tensor("faces", vertex_positions.device)
        a = vertex_positions[:, faces[:, 0]]
        b = vertex_positions[:, faces[:, 1]]
        c = vertex_positions[:, faces[:, 2]]
        n = torch.linalg.cross(b - a, c - a, dim=-1)
        return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                               min=1e-12)

    def vertex_sampler_matrix(self, H: int, W: int) -> np.ndarray:
        """(Vn, H*W) bilinear sampling matrix of the displacement map.

        The topo UVs are constants, so the circular pad, the UV shift and
        the align-corners bilinear gather of ``get_vertex_positions`` make
        one fixed matrix with four nonzeros per row (the JAX version's
        construction); sampling is then one matmul.
        """
        key = ("sampler", H, W)
        cached = self._host.get(key)
        if cached is not None:
            return cached
        topo = (self.nonneg_topo_map if self.is_symmetric
                else self.topo_map).astype(np.float32).copy()
        if self.is_symmetric:
            delta = 1.0 / (2 * W)
            expansion = (W + 1) / W
            topo[:, 0] = (topo[:, 0] + 1 + 2 * delta - expansion) / expansion
        Wp = W + 2  # circular pad of 1 on each side
        px = (topo[:, 0] + 1.0) * 0.5 * (Wp - 1)
        py = (topo[:, 1] + 1.0) * 0.5 * (H - 1)
        x0 = np.floor(px)
        y0 = np.floor(py)
        wx1 = px - x0
        wy1 = py - y0
        Vn = topo.shape[0]
        M = np.zeros((Vn, H * W), np.float32)
        rows = np.arange(Vn)
        for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
            for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
                xi = x0 + dx
                yi = y0 + dy
                valid = (xi >= 0) & (xi < Wp) & (yi >= 0) & (yi < H)
                # padded column -> source column (circular)
                xs = (np.clip(xi, 0, Wp - 1).astype(np.int64) - 1) % W
                ys = np.clip(yi, 0, H - 1).astype(np.int64)
                np.add.at(M, (rows, ys * W + xs),
                          (wy * wx * valid).astype(np.float32))
        self._host[key] = M
        return M

    def get_vertex_positions(self, displacement_map: torch.Tensor
                             ) -> torch.Tensor:
        """UV displacement map (B, H, W, 3) -> (B, V, 3) object-space
        vertices: sample at the topo UVs (one float32 matmul with the
        sampler matrix), tangent-space deform, mirror when symmetric."""
        B, H, W, _ = displacement_map.shape
        dev = displacement_map.device
        self.vertex_sampler_matrix(H, W)
        M = self.tensor(("sampler", H, W), dev)
        local = torch.matmul(M, displacement_map.reshape(B, H * W, 3))
        deltas = self.deform(local)
        if self.is_symmetric:
            full = deltas.new_zeros((B, self.num_vertices, 3))
            full[:, self.tensor("nonneg_idx", dev)] = deltas
            mirrored = full[:, self.tensor("pos_idx", dev)] * deltas.new_tensor(
                [-1.0, 1.0, 1.0])
            full[:, self.tensor("neg_idx", dev)] = mirrored
            deltas = full * self.tensor("symmetry_mask", dev)[None]
        return self.tensor("vertices", dev)[None] + deltas

    def adjust_uv_and_texture(self, texture: torch.Tensor):
        """UVs (B, T, 2) and the boundary-prepared texture (B, H, W', C):
        symmetric templates shift u into a circularly padded texture, others
        repeat the first column at the end."""
        B, H, W, _ = texture.shape
        uvs = self.tensor("uvs", texture.device)
        if self.is_symmetric:
            delta = 1.0 / (2 * W)
            expansion = (W + 1) / W
            uvs = torch.stack([(uvs[:, 0] + delta) / expansion, uvs[:, 1]],
                              dim=-1)
            texture = circpad(texture, 1)
        else:
            texture = torch.cat([texture, texture[:, :, :1]], dim=2)
        return uvs[None].expand(B, -1, -1), texture

