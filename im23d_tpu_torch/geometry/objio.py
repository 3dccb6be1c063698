"""Host-side OBJ mesh IO and procedural UV-sphere templates, numpy only (a
copy of ``im23d_tpu/geometry/objio.py``; ``save_obj`` writes the texture
PNG with ``core/metrics_logger.write_png``, no imaging library).

A dependency-free OBJ parser, and Blender-style UV spheres generated
procedurally; a user-supplied template .obj loads through ``load_obj``.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np

from im23d_tpu_torch.core.metrics_logger import write_png


class Mesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) float32
    uvs: np.ndarray  # (T, 2) float32
    faces: np.ndarray  # (F, 3) int32 vertex indices
    face_uvs: np.ndarray  # (F, 3) int32 uv indices


def load_obj(path: str) -> Mesh:
    """Parse v / vt / f records (f supports v, v/vt, v/vt/vn, v//vn)."""
    vertices, uvs, faces, face_uvs = [], [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif parts[0] == "f":
                assert len(parts) == 4, f"non-triangle face: {line}"
                vi, ti = [], []
                for tok in parts[1:4]:
                    fields = tok.split("/")
                    vi.append(int(fields[0]) - 1)
                    if len(fields) > 1 and fields[1]:
                        ti.append(int(fields[1]) - 1)
                faces.append(vi)
                face_uvs.append(ti if len(ti) == 3 else vi)
    return Mesh(
        np.asarray(vertices, np.float32),
        np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
        np.asarray(faces, np.int32),
        np.asarray(face_uvs, np.int32),
    )


def save_obj(path_prefix: str, mesh: Mesh, vertex_positions: np.ndarray,
             texture: np.ndarray | None = None) -> None:
    """Export .obj + .mtl (+ .png texture) — reference ``export_obj``
    (``mesh_template.py:188-219``) output layout."""
    material_name = os.path.basename(path_prefix)
    with open(path_prefix + ".obj", "w") as fh:
        print("mtllib " + material_name + ".mtl", file=fh)
        for v in vertex_positions:
            print("v {:.5f} {:.5f} {:.5f}".format(*v), file=fh)
        for uv in mesh.uvs:
            print("vt {:.5f} {:.5f}".format(*uv), file=fh)
        print("usemtl " + material_name, file=fh)
        for f, ft in zip(mesh.faces, mesh.face_uvs):
            print(
                "f {}/{} {}/{} {}/{}".format(
                    f[0] + 1, ft[0] + 1, f[1] + 1, ft[1] + 1, f[2] + 1, ft[2] + 1
                ),
                file=fh,
            )
    with open(path_prefix + ".mtl", "w") as fh:
        print("newmtl " + material_name, file=fh)
        print("Ka 1.000 1.000 1.000", file=fh)
        print("Kd 1.000 1.000 1.000", file=fh)
        print("Ks 0.000 0.000 0.000", file=fh)
        print("d 1.0", file=fh)
        print("illum 1", file=fh)
        print("map_Ka " + material_name + ".png", file=fh)
        print("map_Kd " + material_name + ".png", file=fh)
    if texture is not None:
        arr = np.clip(np.asarray(texture) * 255.0, 0, 255).astype(np.uint8)
        write_png(path_prefix + ".png", arr)


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
