"""Inverse rendering and texel visibility for pseudo-ground-truth generation
(counterpart of ``im23d_tpu/render/inverse.py``).

* ``inverse_render`` draws the mesh flattened into its UV chart (vertex
  positions = the template's UVs in NDC, z = 0) with the predicted
  vertices' screen xy as the per-corner UV attributes and the photo as the
  texture: the photo is projected onto the UV chart.  The chart's winding is
  arbitrary, so back faces are drawn (K4 with ``cull_backfaces=False``).
* ``visibility_mask`` is the gradient of the summed render with respect to
  the texture (K5's backward on CUDA): positive where a texel reached a
  pixel.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.render.renderer import render_mesh


def inverse_render(template, predicted_vertices: torch.Tensor,
                   target_image: torch.Tensor, resolution: int):
    """Project photos (B, H, W, 3) onto the UV chart of the posed meshes
    (B, V, 3) NDC; returns (texture (B, R, R, 3), hard alpha (B, R, R, 1))
    at R = ``resolution``."""
    B = predicted_vertices.shape[0]
    dev = predicted_vertices.device
    uv_ndc = template.tensor("uvs", dev) * 2.0 - 1.0
    verts = torch.cat([uv_ndc, torch.zeros_like(uv_ndc[:, :1])], dim=-1)
    verts = verts[None].expand(B, -1, -1)
    # per-vertex UVs = the predicted screen xy in [0, 1], indexing the photo;
    # the roles swap: faces from face_uvs (the chart), attributes by the
    # mesh's vertex indices
    uvs_attr = (predicted_vertices[..., :2] + 1.0) / 2.0
    image, alpha, _ = render_mesh(
        verts, template.tensor("face_uvs", dev), uvs_attr,
        template.tensor("faces", dev), target_image, resolution, resolution,
        return_hardmask=True, cull_backfaces=False)
    return image, alpha


def visibility_mask(renderer_fn, vtx: torch.Tensor,
                    texture: torch.Tensor) -> torch.Tensor:
    """d sum(``renderer_fn(vtx, texture)``) / d texture, shaped like
    ``texture``: positive where the texel influenced a pixel."""
    with torch.enable_grad():
        tex = texture.detach().requires_grad_()
        (grad,) = torch.autograd.grad(renderer_fn(vtx, tex).sum(), tex)
    return grad
