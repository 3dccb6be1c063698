"""Renderer of the PyTorch port (rasterizer, texture sampler, shading)
against the JAX reference, on the CPU.

Same numpy inputs through both.  Tolerances:
  * rasterizer feat: the 0.999 quantile of |port - JAX| below 1e-5 (a pixel
    on a shared edge may pick the other face's attributes when the two
    frameworks round an edge function differently, as in
    ``tests/test_rasterizer_pallas.py``); soft: max |port - JAX| below 1e-5
    (1e-4 against the Pallas kernel, whose chunks are Morton-ordered);
  * texture sampling: max |port - JAX| below 1e-6 (the same gather and
    weights; the sums may round differently);
  * the texture ops: 1e-6; renders of a deformed sphere: the rasterizer's
    limits on the image and alpha.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.ops import sampling as jsamp
from im23d_tpu.ops.sampling_pallas import grid_sample_bilinear_pallas
from im23d_tpu.render.rasterizer import rasterize as j_rasterize
from im23d_tpu.render.rasterizer_pallas import rasterize_tiled
from im23d_tpu.render.renderer import render_mesh as j_render_mesh
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.ops import sampling as tsamp
from im23d_tpu_torch.render.rasterizer import rasterize, rasterize_torch
from im23d_tpu_torch.render.renderer import render_mesh

FEAT_Q, SOFT_ATOL = 1e-5, 1e-5


def _scene(seed, B=2, V=40, F=60, A=3):
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-0.9, 0.9, (B, V, 3)).astype(np.float32)
    # distinct corners: a degenerate sliver's front test flips on noise
    faces = np.stack([rng.choice(V, 3, replace=False)
                      for _ in range(F)]).astype(np.int32)
    attrs = rng.rand(B, F, 3, A).astype(np.float32)
    return verts, faces, attrs


def _check_raster(port, ref, soft_atol=SOFT_ATOL):
    """The limits above; a failure names its assertion and how many pixels
    differ."""
    (f1, s1), (f0, s0) = port, ref
    d = np.abs(f1.numpy() - np.asarray(f0)).max(axis=-1)
    q = np.quantile(np.abs(f1.numpy() - np.asarray(f0)), 0.999)
    assert q < FEAT_Q, (f"feat 0.999-quantile |port - JAX| {q:.3e}; "
                        f"{int((d > FEAT_Q).sum())} of {d.size} pixels differ")
    ds = np.abs(s1.numpy() - np.asarray(s0))
    assert ds.max() < soft_atol, (
        f"soft max |port - JAX| {ds.max():.3e} at "
        f"{np.unravel_index(ds.argmax(), ds.shape)}; "
        f"{int((ds > soft_atol).sum())} of {ds.size} pixels over {soft_atol}")


@contextlib.contextmanager
def _compiled_here():
    """Compile the JAX reference in this process: the on-disk compilation
    cache is shared by the concurrently running test workers, each of
    which writes its entries in place."""
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", enabled)


@pytest.mark.parametrize("cull,res,sigma", [
    (True, 64, 1e-3), (False, 64, 1e-3), (True, 70, 1e-4), (False, 70, 1e-4),
])
def test_rasterize_matches_jax(cull, res, sigma):
    verts, faces, attrs = _scene(0)
    with _compiled_here():
        # each framework reads its own copy; the reference is finished
        # before the port starts
        ref = jax.block_until_ready(j_rasterize(
            jnp.array(verts), jnp.array(faces), jnp.array(attrs), res, res,
            sigma=sigma, cull_backfaces=cull))
    got = rasterize_torch(torch.tensor(verts), torch.tensor(faces),
                          torch.tensor(attrs), res, res, sigma=sigma,
                          cull_backfaces=cull)
    _check_raster(got, ref)
    assert float(got[1].max()) > 0.5  # the scene is on screen


def test_rasterize_empty_scene():
    """Faces behind the image edge and an empty face list: feat and soft
    are 0, as in JAX."""
    verts, faces, attrs = _scene(1)
    verts[..., 0] += 5.0  # every face off screen
    for f in (faces, faces[:0]):
        a = attrs[:, :len(f)]
        ref = j_rasterize(jnp.asarray(verts), jnp.asarray(f), jnp.asarray(a),
                          32, 40)
        got = rasterize(torch.from_numpy(verts), torch.from_numpy(f),
                        torch.from_numpy(a), 32, 40)
        _check_raster(got, ref)
        assert not got[0].any() and not got[1].any()


def test_rasterize_matches_pallas_interpret():
    """One 32² case against the tiled Pallas kernel in interpret mode, at the
    size of ``tests/test_kernels_smoke.py``."""
    rng = np.random.RandomState(0)
    verts = rng.uniform(-0.9, 0.9, (1, 12, 3)).astype(np.float32)
    faces = np.stack([rng.choice(12, 3, replace=False)
                      for _ in range(16)]).astype(np.int32)
    attrs = rng.rand(1, 16, 3, 3).astype(np.float32)
    ref = rasterize_tiled(jnp.asarray(verts), jnp.asarray(faces),
                          jnp.asarray(attrs), 32, 32, sigma=1e-3)
    got = rasterize_torch(torch.from_numpy(verts), torch.from_numpy(faces),
                          torch.from_numpy(attrs), 32, 32, sigma=1e-3)
    _check_raster(got, ref, soft_atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (2, 16, 130, 3),
                                   (1, 9, 7, 5)])
def test_grid_sample_matches_jax(shape):
    """Aligned and unaligned widths (the renderer's circularly padded
    texture is 130 wide), out-of-range coordinates included."""
    rng = np.random.RandomState(2)
    img = rng.rand(*shape).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (shape[0], 20, 30, 2)).astype(np.float32)
    grid[0, 0, :4] = [[-1, -1], [1, 1], [1, -1], [-1.0, 1.0]]  # corners
    ref = jsamp.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(grid))
    got = tsamp.grid_sample_bilinear(torch.from_numpy(img),
                                     torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_grid_sample_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    img = rng.rand(1, 16, 16, 3).astype(np.float32)
    grid = rng.uniform(-1, 1, (1, 8, 8, 2)).astype(np.float32)
    ref = grid_sample_bilinear_pallas(jnp.asarray(img), jnp.asarray(grid))
    got = tsamp.grid_sample_bilinear_torch(torch.from_numpy(img),
                                           torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name,args", [
    ("circpad", (1,)), ("circpad", (2,)), ("symmetrize_texture", ()),
    ("adjust_poles", ()),
])
def test_texture_ops_match_jax(name, args):
    x = np.random.RandomState(3).rand(2, 6, 8, 3).astype(np.float32)
    ref = getattr(jsamp, name)(jnp.asarray(x), *args)
    got = getattr(tsamp, name)(torch.from_numpy(x), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("align,out", [(False, (5, 9)), (False, (24, 20)),
                                       (True, (5, 9))])
def test_resize_bilinear_matches_jax(align, out):
    x = np.random.RandomState(4).rand(2, 12, 10, 3).astype(np.float32)
    ref = jsamp.resize_bilinear(jnp.asarray(x), *out, align_corners=align)
    got = tsamp.resize_bilinear(torch.from_numpy(x), *out,
                                align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("cull,hardmask", [(True, False), (False, True)])
def test_render_mesh_deformed_sphere_matches_jax(cull, hardmask):
    jt, pt = JTemplate(segments=16, rings=8), MeshTemplate(segments=16,
                                                           rings=8)
    rng = np.random.RandomState(5)
    B, res = 2, 64
    dmap = (rng.randn(B, 16, 16, 3) * 0.05).astype(np.float32)
    tex = rng.rand(B, 16, 16, 3).astype(np.float32)
    rot = np.array([[1.0, 0.0, 0.0, 0.0], [0.9, 0.3, 0.2, 0.1]], np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)

    def pose_j(v):
        from im23d_tpu.ops.quaternion import qrot
        return qrot(jnp.asarray(rot), 0.7 * v) * jnp.asarray([1.0, -1, -1])

    def pose_t(v):
        from im23d_tpu_torch.ops.quaternion import qrot
        return qrot(torch.from_numpy(rot), 0.7 * v) * torch.tensor(
            [1.0, -1, -1])

    vj = pose_j(jt.get_vertex_positions(jnp.asarray(dmap)))
    uj, tj = jt.adjust_uv_and_texture(jnp.asarray(tex))
    ref = j_render_mesh(vj, jt.faces_j, uj, jt.face_uvs_j, tj, res, res,
                        return_hardmask=hardmask, cull_backfaces=cull)
    vt = pose_t(pt.get_vertex_positions(torch.from_numpy(dmap)))
    ut, tt = pt.adjust_uv_and_texture(torch.from_numpy(tex))
    got = render_mesh(vt, pt.tensor("faces", "cpu"), ut,
                      pt.tensor("face_uvs", "cpu"), tt, res, res,
                      return_hardmask=hardmask, cull_backfaces=cull)
    for g, r in zip(got[:2], ref[:2]):
        d = np.abs(g.numpy() - np.asarray(r))
        assert np.quantile(d, 0.999) < FEAT_Q, np.quantile(d, 0.999)
    if not hardmask:
        assert np.abs(got[1].numpy() - np.asarray(ref[1])).max() < SOFT_ATOL
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-5)
    assert float(got[1].mean()) > 0.05


@pytest.mark.parametrize("with_background", [False, True])
def test_fragment_shader_matches_jax(with_background):
    from im23d_tpu.render.renderer import fragment_shader as j_shader
    from im23d_tpu_torch.render.renderer import fragment_shader

    rng = np.random.RandomState(6)
    uv = rng.rand(2, 12, 10, 2).astype(np.float32)
    tex = rng.rand(2, 8, 10, 3).astype(np.float32)
    mask = (rng.rand(2, 12, 10, 1) > 0.3).astype(np.float32)
    bg = rng.rand(2, 12, 10, 3).astype(np.float32) if with_background else None
    ref = j_shader(jnp.asarray(uv), jnp.asarray(tex), jnp.asarray(mask),
                   None if bg is None else jnp.asarray(bg))
    got = fragment_shader(torch.from_numpy(uv), torch.from_numpy(tex),
                          torch.from_numpy(mask),
                          None if bg is None else torch.from_numpy(bg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
