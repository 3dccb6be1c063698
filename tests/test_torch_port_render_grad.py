"""Gradients of the PyTorch port's renderer against the JAX reference, on
the CPU: the plain rasterizer's autograd against ``jax.grad`` of the JAX
``rasterize`` (and, once, of the Pallas ``rasterize_tiled`` in interpret
mode), the plain texture sampler's d texture and d coordinates, and
``render_mesh``'s gradients with respect to the vertices and the texture.

Same numpy inputs through both.  Tolerances:
  * rasterizer: the limits of the JAX package's own gradient test
    (``tests/test_rasterizer_pallas.py:76-80``): max |Δ d verts| below
    1e-3 × max(max |d verts|, 1), max |Δ d attrs| below
    1e-4 × max(max |d attrs|, 1) (edge pixels whose edge function rounds
    to the other side move a face's sum; float32 sums in another order);
  * the checkpointed and the unchecked plain rasterizer: bit-equal;
  * texture sampler: d img and d grid within rtol 1e-5, atol 1e-6 (the same
    products, summed in another order);
  * ``render_mesh``: relative L2 of each gradient below 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.geometry.objio import uv_sphere
from im23d_tpu.ops.sampling import grid_sample_bilinear as j_sample
from im23d_tpu.render.rasterizer import rasterize as j_rasterize
from im23d_tpu.render.rasterizer_pallas import rasterize_tiled
from im23d_tpu.render.renderer import render_mesh as j_render_mesh
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.ops.sampling import (
    grid_sample_bilinear_backward_torch,
)
from im23d_tpu_torch.render import rasterizer as trast
from im23d_tpu_torch.render.renderer import render_mesh

RES, SIGMA = 48, 1e-3


def _sphere_case(seed=3):
    """The JAX gradient test's scene: a jittered uv_sphere(8, 4) at 48²,
    random attributes and upstream weights."""
    tpl = uv_sphere(8, 4)
    rng = np.random.RandomState(seed)
    B, V, F = 2, tpl.vertices.shape[0], tpl.faces.shape[0]
    verts = (tpl.vertices[None].repeat(B, 0) * 1.5
             + 0.05 * rng.randn(B, V, 3)).astype(np.float32)
    attrs = rng.rand(B, F, 3, 3).astype(np.float32)
    wf = rng.randn(B, RES, RES, 3).astype(np.float32)
    ws = rng.randn(B, RES, RES, 1).astype(np.float32)
    return tpl.faces.astype(np.int32), verts, attrs, wf, ws


def _jax_grads(impl, faces, verts, attrs, wf, ws, cull):
    def loss(v, a):
        f, s = impl(v, jnp.asarray(faces), a, RES, RES, sigma=SIGMA,
                    cull_backfaces=cull)
        return jnp.sum(f * wf) + jnp.sum(s * ws)

    return [np.asarray(g) for g in jax.grad(loss, (0, 1))(
        jnp.asarray(verts), jnp.asarray(attrs))]


def _torch_grads(faces, verts, attrs, wf, ws, cull):
    v = torch.from_numpy(verts).requires_grad_()
    a = torch.from_numpy(attrs).requires_grad_()
    f, s = trast.rasterize_torch(v, torch.from_numpy(faces), a, RES, RES,
                                 SIGMA, cull)
    loss = (f * torch.from_numpy(wf)).sum() + (s * torch.from_numpy(ws)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (v, a))]


def _check_raster_grads(got, ref):
    for g, r, k in zip(got, ref, (1e-3, 1e-4)):
        scale = max(float(np.abs(r).max()), 1.0)
        assert float(np.abs(g - r).max()) < k * scale, (k, scale)
    assert float(np.abs(ref[0]).max()) > 1.0  # the soft term moves vertices


@pytest.mark.parametrize("cull", [True, False])
def test_rasterizer_autograd_matches_jax_grad(cull):
    case = _sphere_case()
    _check_raster_grads(_torch_grads(*case, cull),
                        _jax_grads(j_rasterize, *case, cull))


def test_rasterizer_autograd_matches_the_pallas_vjp():
    """The TPU kernel's custom VJP (``rasterize_tiled`` in interpret mode)."""
    case = _sphere_case(seed=5)
    _check_raster_grads(_torch_grads(*case, True),
                        _jax_grads(rasterize_tiled, *case, True))


def test_checkpointed_chunks_give_the_unchecked_gradients(monkeypatch):
    case = _sphere_case(seed=7)
    for cull in (True, False):
        ref = _torch_grads(*case, cull)
        with monkeypatch.context() as m:
            m.setattr(trast, "checkpoint",
                      lambda fn, *args, **_: fn(*args))
            got = _torch_grads(*case, cull)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("shape,integer", [
    ((2, 16, 130, 3), False), ((2, 9, 7, 1), True), ((1, 33, 20, 4), False),
])
def test_sampler_gradients_match_jax(shape, integer):
    """d img and d grid: a 130-wide texture, coordinates in [-1.1, 1.1],
    exact texel corners (x an integer, where floor has no derivative)."""
    rng = np.random.RandomState(8)
    B, H, W, C = shape
    img = rng.rand(*shape).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (B, 24, 20, 2)).astype(np.float32)
    if integer:  # -1 + 2 i / (W - 1), exact in float32 for these sizes
        grid[..., 0] = (rng.randint(0, W, (B, 24, 20)) * 0.5 - 1.0)
        grid[..., 1] = (rng.randint(0, 5, (B, 24, 20)) * 0.5 - 1.0)
    dout = rng.randn(B, 24, 20, C).astype(np.float32)
    ref = jax.vjp(j_sample, jnp.asarray(img), jnp.asarray(grid))[1](
        jnp.asarray(dout))
    got = grid_sample_bilinear_backward_torch(
        torch.from_numpy(img), torch.from_numpy(grid), torch.from_numpy(dout))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


def test_render_mesh_gradients_match_jax():
    """d displacement map (through the vertices) and d texture of an image
    and soft-alpha loss of a deformed sphere."""
    jt, tt = JTemplate(segments=16, rings=8), MeshTemplate(segments=16,
                                                           rings=8)
    rng = np.random.RandomState(9)
    dmap = (rng.randn(2, 16, 16, 3) * 0.05).astype(np.float32)
    tex = rng.rand(2, 16, 16, 3).astype(np.float32)
    w_img = rng.randn(2, 64, 64, 3).astype(np.float32)
    w_a = rng.randn(2, 64, 64, 1).astype(np.float32)

    def j_loss(d, t):
        v = jt.get_vertex_positions(d) * 0.7
        uvs, ta = jt.adjust_uv_and_texture(t)
        img, alpha, _ = j_render_mesh(v, jt.faces_j, uvs, jt.face_uvs_j, ta,
                                      64, 64)
        return jnp.sum(img * w_img) + jnp.sum(alpha * w_a)

    ref = jax.grad(j_loss, (0, 1))(jnp.asarray(dmap), jnp.asarray(tex))
    d = torch.from_numpy(dmap).requires_grad_()
    t = torch.from_numpy(tex).requires_grad_()
    v = tt.get_vertex_positions(d) * 0.7
    uvs, ta = tt.adjust_uv_and_texture(t)
    img, alpha, _ = render_mesh(v, tt.tensor("faces", "cpu"), uvs,
                                tt.tensor("face_uvs", "cpu"), ta, 64, 64)
    loss = ((img * torch.from_numpy(w_img)).sum()
            + (alpha * torch.from_numpy(w_a)).sum())
    got = torch.autograd.grad(loss, (d, t))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.linalg.norm(g.numpy() - r) / np.linalg.norm(r) < 1e-4
        assert np.abs(r).max() > 0
