"""The port's point-cloud meshing on the CPU against the JAX package:
``marching_tetrahedra`` bit-equal on the volumes of ``tests/test_marching.py``;
``point_cloud_to_mesh``'s occupancy (``splat_blur`` at scale 1, the plain
path here) within 1e-5 of JAX's ``gaussian_blur_3d(trilinear_splat(...))``,
with equal vertex and face counts and vertices within 1e-4; and the CLI
(``--input`` .npy and .npz, ``--workdir --image`` on a port checkpoint of
a JAX learner's parameters, the no-surface return code) against the JAX
CLI.  The ``--workdir`` case patches both packages' chairs config to a tiny
one (32² images, 128 points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from im23d_tpu.cli import pointcloud_to_mesh as j_cli
from im23d_tpu.core import jax_setup
from im23d_tpu.core.checkpoint import wait_for_async_saves
from im23d_tpu.geometry import marching as j_marching
from im23d_tpu.ops.voxel import gaussian_blur_3d as j_blur
from im23d_tpu.ops.voxel import trilinear_splat as j_splat
from im23d_tpu.train import shapenet_learner as j_learner
from im23d_tpu_torch.cli import pointcloud_to_mesh as cli
from im23d_tpu_torch.geometry import marching
from im23d_tpu_torch.ops.splat import splat_blur
from im23d_tpu_torch.train import shapenet_learner as learner


def _sphere_volume(S, r):
    z, y, x = np.meshgrid(*[np.linspace(-0.5, 0.5, S)] * 3, indexing="ij")
    return (np.sqrt(z**2 + y**2 + x**2) < r).astype(np.float32)


def _shell(seed, n, r):
    d = np.random.RandomState(seed).randn(n, 3)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True) * r).astype(
        np.float32)


@pytest.mark.parametrize("volume,level", [
    (_sphere_volume(32, 0.35), 0.5),
    (_sphere_volume(24, 0.3), 0.5),
    (np.zeros((8, 8, 8), np.float32), 0.5),
    (np.ones((8, 8, 8), np.float32), 0.5),
    (np.random.RandomState(0).rand(12, 10, 9).astype(np.float32), 0.4),
], ids=["sphere32", "sphere24", "empty", "full", "noise"])
def test_marching_tetrahedra_is_bit_equal(volume, level):
    got = marching.marching_tetrahedra(volume, level)
    want = j_marching.marching_tetrahedra(volume, level)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("S,sigma,level,weighted", [
    (96, 1.5, 0.2, False),   # the CLI's defaults
    (48, 1.0, 0.25, True),
])
def test_point_cloud_to_mesh_matches_jax(S, sigma, level, weighted):
    pts = _shell(0, 4000, 0.3)
    w = (np.random.RandomState(1).rand(4000).astype(np.float32)
         if weighted else None)
    occ = splat_blur(torch.from_numpy(pts)[None], S, sigma, torch.ones(1),
                     None if w is None else torch.from_numpy(w)[None])
    j_occ = j_blur(j_splat(jnp.asarray(pts)[None], S,
                           None if w is None else jnp.asarray(w)[None]),
                   jnp.float32(sigma))
    np.testing.assert_allclose(occ.numpy(), np.asarray(j_occ), rtol=0,
                               atol=1e-5)

    verts, faces = marching.point_cloud_to_mesh(pts, S, sigma, level, w,
                                                device="cpu")
    _assert_same_mesh(verts, faces,
                      *j_marching.point_cloud_to_mesh(pts, S, sigma, level, w))


def _assert_same_mesh(verts, faces, j_verts, j_faces):
    """Equal vertex and face counts; every vertex and face centre within
    1e-4 of one of the other mesh's, both ways.  The vertex order is not
    compared: the merge sorts vertices by positions rounded to 1e-5, and a
    last-ulp difference of the occupancy can carry a vertex across a
    rounding boundary and swap it with its neighbour in that order."""
    assert len(faces) > 100
    assert verts.shape == j_verts.shape and faces.shape == j_faces.shape
    for a, b in ((verts, j_verts),
                 (verts[faces].mean(1), j_verts[j_faces].mean(1))):
        assert cKDTree(b).query(a)[0].max() <= 1e-4
        assert cKDTree(a).query(b)[0].max() <= 1e-4


def _read_obj(path):
    lines = path.read_text().splitlines()
    v = np.array([[float(t) for t in line.split()[1:]] for line in lines
                  if line.startswith("v ")])
    f = np.array([[int(t) for t in line.split()[1:]] for line in lines
                  if line.startswith("f ")])
    return v, f


def _same_mesh(path, j_path):
    v, f = _read_obj(path)
    jv, jf = _read_obj(j_path)
    _assert_same_mesh(v, f - 1, jv, jf - 1)


@pytest.fixture(autouse=True)
def _no_jax_disk_cache(monkeypatch):
    """The JAX CLI's ``setup_jax`` would turn on JAX's on-disk compilation
    cache for the rest of this test process."""
    monkeypatch.setattr(jax_setup, "setup_jax", lambda: None)


@pytest.mark.parametrize("ext", ["npy", "npz"])
def test_cli_from_file_matches_jax(tmp_path, ext):
    pts = _shell(1, 2000, 0.25)
    src = tmp_path / f"cloud.{ext}"
    if ext == "npy":
        np.save(src, pts)
    else:
        np.savez(src, points=pts, other=np.zeros(3))
    flags = ["--input", str(src), "--voxel_size", "40", "--sigma", "1.0",
             "--level", "0.25"]
    out, j_out = tmp_path / "mesh.obj", tmp_path / "jax.obj"
    assert cli.main([*flags, "--output", str(out), "--device", "cpu"]) == 0
    assert j_cli.main([*flags, "--output", str(j_out)]) == 0
    _same_mesh(out, j_out)


def test_cli_without_a_surface_returns_1(tmp_path, capsys):
    np.save(tmp_path / "cloud.npy", _shell(2, 500, 0.2))
    out = tmp_path / "mesh.obj"
    rc = cli.main(["--input", str(tmp_path / "cloud.npy"), "--output",
                   str(out), "--level", "1.5", "--voxel_size", "24",
                   "--device", "cpu"])
    assert rc == 1 and not out.exists()
    assert "no surface found" in capsys.readouterr().out


def test_cli_predicts_the_jax_clis_cloud(tmp_path, monkeypatch):
    """A port checkpoint of a JAX learner's parameters (``load_params``,
    ``core/convert.py``) predicts the cloud that the JAX CLI predicts from
    the JAX checkpoint, and meshes it."""
    from PIL import Image

    tiny = dict(image_size=32, num_points=128, num_views=2,
                num_candidates=2, batch_size=2)
    j_cfg = j_learner.ShapeNetConfig(**tiny)
    cfg = learner.ShapeNetConfig(**tiny)
    monkeypatch.setattr(j_learner.ShapeNetConfig, "chairs",
                        staticmethod(lambda: j_cfg))
    monkeypatch.setattr(learner.ShapeNetConfig, "chairs",
                        staticmethod(lambda: cfg))
    j_dir, dir_ = tmp_path / "jax", tmp_path / "port"
    jl = j_learner.ShapeNetLearner(j_cfg, workdir=str(j_dir))
    jl.save()
    wait_for_async_saves()
    pl = learner.ShapeNetLearner(cfg, device="cpu")
    pl.load_params(jax.tree.map(np.asarray, jl.state.params))
    pl.save(str(dir_))

    rng = np.random.RandomState(4)
    image = tmp_path / "view.png"
    Image.fromarray((rng.rand(48, 48, 3) * 255).astype(np.uint8)).save(image)
    got = cli.predict_points(str(dir_), str(image), "chairs", "cpu")
    want = np.asarray(j_cli.predict_points(str(j_dir), str(image), "chairs"))
    assert got.shape == (128, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    out = tmp_path / "chair.obj"
    assert cli.main(["--workdir", str(dir_), "--image", str(image),
                     "--output", str(out), "--voxel_size", "32", "--sigma",
                     "2.0", "--device", "cpu"]) == 0
    assert _read_obj(out)[1].shape[0] > 0
