"""Mesh template and OBJ IO of the PyTorch port against the JAX reference,
on the CPU.

The numpy precompute (index sets, topo and tangent maps, face adjacency,
vertex sampler) must equal the JAX template's exactly; the tensor methods
(vertex positions, normals, UVs and texture) agree within 1e-6 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.geometry import objio as jobj
from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu_torch.geometry import objio
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate

ATOL = 1e-6
_SIZES = [(16, 8, True), (16, 8, False), (32, 16, True)]


def _pair(seg, rings, sym):
    return (JTemplate(segments=seg, rings=rings, is_symmetric=sym),
            MeshTemplate(segments=seg, rings=rings, is_symmetric=sym))


@pytest.mark.parametrize("seg,rings", [(16, 8), (32, 16), (32, 31)])
def test_uv_sphere_matches_jax(seg, rings):
    a, b = objio.uv_sphere(seg, rings), jobj.uv_sphere(seg, rings)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_obj_roundtrip(tmp_path):
    mesh = objio.uv_sphere(16, 8)
    objio.save_obj(str(tmp_path / "m"), mesh, mesh.vertices)
    back = objio.load_obj(str(tmp_path / "m.obj"))
    np.testing.assert_allclose(back.vertices, mesh.vertices, atol=1e-5)
    np.testing.assert_allclose(back.uvs, mesh.uvs, atol=1e-5)
    np.testing.assert_array_equal(back.faces, mesh.faces)
    np.testing.assert_array_equal(back.face_uvs, mesh.face_uvs)
    # the template infers rings and segments from a loaded sphere
    t = MeshTemplate(str(tmp_path / "m.obj"))
    assert (t.segments, t.rings) == (16, 8)


@pytest.mark.parametrize("seg,rings,sym", _SIZES)
def test_template_constants_match_jax(seg, rings, sym):
    jt, pt = _pair(seg, rings, sym)
    for name in ("neg_indices", "pos_indices", "zero_indices",
                 "nonneg_indices", "topo_map", "nonneg_topo_map",
                 "symmetry_mask", "tangent_map", "nonneg_tangent_map", "ff"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name),
                                      err_msg=name)
    assert pt.poles == jt.poles and pt.num_vertices == jt.num_vertices
    for hw in ((16, 16), (32, 32), (8, 12)):
        np.testing.assert_array_equal(pt.vertex_sampler_matrix(*hw),
                                      np.asarray(jt._vertex_sampler(*hw)))


@pytest.mark.parametrize("seg,rings,sym", _SIZES)
def test_template_methods_match_jax(seg, rings, sym):
    jt, pt = _pair(seg, rings, sym)
    rng = np.random.RandomState(0)
    dmap = (rng.randn(3, 16, 16, 3) * 0.1).astype(np.float32)
    ref_v = jt.get_vertex_positions(jnp.asarray(dmap))
    got_v = pt.get_vertex_positions(torch.from_numpy(dmap))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=ATOL)
    np.testing.assert_allclose(pt.compute_normals(got_v).numpy(),
                               np.asarray(jt.compute_normals(ref_v)),
                               atol=1e-5)
    n_local = len(pt.nonneg_indices) if sym else pt.num_vertices
    local = rng.randn(3, n_local, 3).astype(np.float32)
    np.testing.assert_allclose(pt.deform(torch.from_numpy(local)).numpy(),
                               np.asarray(jt.deform(jnp.asarray(local))),
                               atol=ATOL)
    tex = rng.rand(3, 8, 8, 3).astype(np.float32)
    ref_uv, ref_tex = jt.adjust_uv_and_texture(jnp.asarray(tex))
    got_uv, got_tex = pt.adjust_uv_and_texture(torch.from_numpy(tex))
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(ref_uv), atol=ATOL)
    np.testing.assert_array_equal(got_tex.numpy(), np.asarray(ref_tex))


def test_template_tensors_are_cached_per_device():
    pt = MeshTemplate(segments=16, rings=8)
    faces = pt.tensor("faces", "cpu")
    assert faces is pt.tensor("faces", torch.device("cpu"))
    assert faces.dtype == torch.int64 and faces.shape == (pt.mesh.faces.shape)


def test_template_rejects_a_non_sphere(tmp_path):
    mesh = objio.uv_sphere(16, 8)
    bad = objio.Mesh(mesh.vertices[:-1], mesh.uvs, mesh.faces, mesh.face_uvs)
    with pytest.raises(ValueError):
        MeshTemplate(bad)
