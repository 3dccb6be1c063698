"""Mesh template: UV-sphere topology and its deformation by UV displacement
maps (counterpart of ``im23d_tpu/geometry/mesh_template.py``).

Every topology-derived constant (topo map, tangent frames, symmetry index
sets, face adjacency, the vertex sampler) is computed in numpy at
construction, by the JAX version's code; ``tensor(name, device)`` hands out
each constant as a tensor on a device, made once per device.  The
deformation methods take and return NHWC maps and (B, V, 3) vertices.
"""

from __future__ import annotations

import numpy as np
import torch

from im23d_tpu_torch.geometry.objio import Mesh, load_obj, save_obj, uv_sphere
from im23d_tpu_torch.ops.sampling import circpad


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

    def __init__(self, mesh: Mesh | str | None = None,
                 is_symmetric: bool = True, segments: int = 32,
                 rings: int = 16):
        if mesh is None:
            mesh = uv_sphere(segments=segments, rings=rings)
        elif isinstance(mesh, str):
            mesh = load_obj(mesh)
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

    def export_obj(self, path_prefix: str, vertex_positions,
                   texture=None) -> None:
        """Write ``<prefix>.obj``, ``.mtl`` and, with a (H, W, 3) texture in
        [0, 1], ``.png`` for (V, 3) vertex positions on this topology."""
        save_obj(path_prefix, self.mesh, np.asarray(vertex_positions),
                 None if texture is None else np.asarray(texture))
