"""Iso-surface extraction and point-cloud meshing (counterpart of
``im23d_tpu/geometry/marching.py``).

``marching_tetrahedra`` and ``save_obj_simple`` are numpy copies of the JAX
module's: each cell splits into 6 tetrahedra whose 16 sign cases are
derived programmatically, and triangle winding is fixed globally by aligning
each face normal against the local field gradient (outward = decreasing
occupancy).  ``point_cloud_to_mesh`` takes its occupancy from
``ops/splat.splat_blur`` (the kernel K7 on CUDA, then the Z blur) and
extracts the surface on the host.
"""

from __future__ import annotations

import numpy as np

# Cube corner offsets in (z, y, x), index = bit order used below.
_CORNERS = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
    ],
    np.int64,
)

# 6-tetrahedra decomposition of the cube around the 0-6 diagonal; every
# face diagonal is shared consistently between neighboring cubes.
_TETS = np.array(
    [
        [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
        [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
    ],
    np.int64,
)

_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _case_table():
    """mask (4 bits of 'corner inside') -> list of triangles, each triangle a
    triple of tet-edge indices into ``_TET_EDGES``."""
    edge_index = {e: i for i, e in enumerate(_TET_EDGES)}

    def edge(a, b):
        return edge_index[(a, b) if a < b else (b, a)]

    table: list[list[tuple[int, int, int]]] = []
    for mask in range(16):
        inside = [i for i in range(4) if mask >> i & 1]
        outside = [i for i in range(4) if not mask >> i & 1]
        if len(inside) in (0, 4):
            table.append([])
        elif len(inside) == 1 or len(inside) == 3:
            a = inside[0] if len(inside) == 1 else outside[0]
            others = [i for i in range(4) if i != a]
            e = [edge(a, b) for b in others]
            table.append([(e[0], e[1], e[2])])
        else:  # 2 inside / 2 outside: 4 crossing edges form a quad ring
            a0, a1 = inside
            b0, b1 = outside
            ring = [edge(a0, b0), edge(a0, b1), edge(a1, b1), edge(a1, b0)]
            table.append([(ring[0], ring[1], ring[2]),
                          (ring[0], ring[2], ring[3])])
    return table


_CASES = _case_table()


def marching_tetrahedra(volume: np.ndarray, level: float = 0.5):
    """Extract the iso-surface of a (D, H, W) scalar field.

    Returns ``(vertices (M, 3) float32 in index coordinates (z, y, x),
    faces (K, 3) int32)`` with outward-oriented windings (normals point
    toward decreasing field values).  Vertices on shared edges are merged.
    """
    vol = np.asarray(volume, np.float32)
    assert vol.ndim == 3
    D, H, W = vol.shape

    cz, cy, cx = np.meshgrid(
        np.arange(D - 1), np.arange(H - 1), np.arange(W - 1), indexing="ij"
    )
    cells = np.stack([cz, cy, cx], -1).reshape(-1, 3)  # (C, 3)
    corners = cells[:, None, :] + _CORNERS[None]  # (C, 8, 3)
    vals = vol[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)

    # cheap cull: only cells the surface crosses
    crossing = (vals.min(1) < level) & (vals.max(1) >= level)
    corners = corners[crossing]
    vals = vals[crossing]
    if len(vals) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # per-tet corner positions/values: (C, 6, 4, ...)
    tpos = corners[:, _TETS]  # (C, 6, 4, 3) int grid coords
    tval = vals[:, _TETS]  # (C, 6, 4)
    mask = ((tval > level) << np.arange(4)).sum(-1)  # (C, 6)

    tpos = tpos.reshape(-1, 4, 3)
    tval = tval.reshape(-1, 4)
    mask = mask.reshape(-1)

    tri_chunks = []
    for m in range(1, 15):
        sel = np.nonzero(mask == m)[0]
        if len(sel) == 0:
            continue
        p = tpos[sel]  # (n, 4, 3)
        v = tval[sel]  # (n, 4)
        # global lexicographic corner keys: tets sharing an edge must
        # interpolate it with identical endpoint order, or last-ulp float
        # differences defeat the vertex merge below
        key = (p[..., 0] * (H * W) + p[..., 1] * W + p[..., 2])  # (n, 4)
        for tri in _CASES[m]:
            pts = []
            for e in tri:
                a, b = _TET_EDGES[e]
                swap = (key[:, b] < key[:, a])[:, None]
                pa = np.where(swap, p[:, b], p[:, a]).astype(np.float32)
                pb = np.where(swap, p[:, a], p[:, b]).astype(np.float32)
                va = np.where(swap[:, 0], v[:, b], v[:, a])
                vb = np.where(swap[:, 0], v[:, a], v[:, b])
                t = (level - va) / np.where(
                    np.abs(vb - va) < 1e-12, 1e-12, vb - va
                )
                t = np.clip(t, 0.0, 1.0)[:, None]
                pts.append(pa * (1 - t) + pb * t)
            tri_chunks.append(np.stack(pts, axis=1))  # (n, 3, 3)
    if not tri_chunks:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    soup = np.concatenate(tri_chunks, axis=0).astype(np.float32)  # (T, 3, 3)

    # drop degenerate slivers (two merged edge points)
    e1 = soup[:, 1] - soup[:, 0]
    e2 = soup[:, 2] - soup[:, 0]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    soup = soup[area2 > 1e-10]

    # merge shared vertices (edge interpolations are bitwise identical
    # between tets sharing an edge, but round defensively)
    flat = soup.reshape(-1, 3)
    keys = np.round(flat * 1e5).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    # representative float position per unique key
    verts = np.zeros((len(uniq), 3), np.float32)
    verts[inverse] = flat
    faces = inverse.reshape(-1, 3).astype(np.int32)

    # orient: normal should align with -gradient (outward of the blob)
    fc = verts[faces].mean(axis=1)
    idx = np.clip(np.round(fc).astype(np.int64), 1, [D - 2, H - 2, W - 2])
    grad = np.stack(
        [
            vol[idx[:, 0] + 1, idx[:, 1], idx[:, 2]]
            - vol[idx[:, 0] - 1, idx[:, 1], idx[:, 2]],
            vol[idx[:, 0], idx[:, 1] + 1, idx[:, 2]]
            - vol[idx[:, 0], idx[:, 1] - 1, idx[:, 2]],
            vol[idx[:, 0], idx[:, 1], idx[:, 2] + 1]
            - vol[idx[:, 0], idx[:, 1], idx[:, 2] - 1],
        ],
        axis=-1,
    )
    n = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                 verts[faces[:, 2]] - verts[faces[:, 0]])
    flip = np.einsum("ij,ij->i", n, -grad) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return verts, faces


def point_cloud_to_mesh(points: np.ndarray, voxel_size: int = 96,
                        sigma: float = 1.5, level: float = 0.2,
                        weights: np.ndarray | None = None,
                        device: str = "cuda"):
    """Point cloud (N, 3) in [-0.5, 0.5] (z, y, x) -> (vertices, faces).

    Occupancy: the trilinear splat, clamped, blurred by the Gaussian of
    ``sigma`` along X, Y and Z, as the JAX version's ``gaussian_blur_3d(
    trilinear_splat(...))``, here through ``splat_blur`` at scale 1 on
    ``device``.  Scale 1 gives the JAX values: the clamped splat lies in
    [0, 1], and a blur with normalised, non-negative, zero-padded taps
    keeps values in [0, 1], so ``splat_blur``'s final clip changes nothing
    (the argument of ``losses/effective.py:project_candidates``).  The
    volume is normalised by its maximum and iso-surfaced at ``level`` on the
    host.  Returned vertices are back in the [-0.5, 0.5] cloud frame.
    """
    import torch

    from im23d_tpu_torch.ops.splat import splat_blur

    dev = torch.device(device)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)[None]
    w = (None if weights is None else
         torch.as_tensor(np.asarray(weights, np.float32), device=dev)[None])
    with torch.no_grad():
        grid = splat_blur(pts, voxel_size, float(sigma),
                          torch.ones(1, device=dev), weights=w)
    vol = grid[0].cpu().numpy()
    vol = vol / max(vol.max(), 1e-8)
    verts, faces = marching_tetrahedra(vol, level)
    verts = verts / (voxel_size - 1) - 0.5
    return verts, faces


def save_obj_simple(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Plain v/f OBJ writer (x, y, z order; input verts are (z, y, x))."""
    with open(path, "w") as fh:
        fh.write("# im23d_tpu point_cloud_to_mesh\n")
        for v in verts:
            fh.write(f"v {v[2]:.6f} {v[1]:.6f} {v[0]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
