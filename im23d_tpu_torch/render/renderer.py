"""Mesh renderer: orthographic projection, rasterizer and UV shading
(counterpart of ``im23d_tpu/render/renderer.py``).

NDC vertices are rasterized (K4 on CUDA) with (u, v, mask) face-corner
attributes, and the texture is sampled at the rasterized UVs (K5 on CUDA)
with the [0, 1] -> [-1, 1] and v-flip mapping of the JAX version.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops.sampling import grid_sample_bilinear
from im23d_tpu_torch.render.rasterizer import rasterize


def fragment_shader(texcoords: torch.Tensor, texture: torch.Tensor,
                    mask: torch.Tensor,
                    background: torch.Tensor | None = None) -> torch.Tensor:
    """Sample the NHWC texture at the rasterized UVs and composite with the
    mask."""
    grid = texcoords * 2.0 - 1.0
    grid = grid * grid.new_tensor([1.0, -1.0])  # flip v
    color = grid_sample_bilinear(texture, grid)  # (B, H, W, C)
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
    feat, soft = rasterize(verts, faces, attrs, height, width, sigma,
                           cull_backfaces)
    texcoords = feat[..., :2]
    hardmask = feat[..., 2:3]
    image = fragment_shader(texcoords, texture, hardmask, background)
    alpha = hardmask if return_hardmask else soft
    return image, alpha, compute_face_normals(verts, faces)


class Renderer:
    """Holds the output size and the coverage softness."""

    def __init__(self, height: int, width: int, sigma: float = 1e-4):
        self.height = height
        self.width = width
        self.sigma = sigma

    def __call__(self, verts, faces, uvs, face_uvs, texture, background=None,
                 return_hardmask=False):
        return render_mesh(verts, faces, uvs, face_uvs, texture, self.height,
                           self.width, background=background,
                           return_hardmask=return_hardmask, sigma=self.sigma)
