"""Pipeline A on real ShapeNet data in the PyTorch port, on the CPU,
against the JAX package on the same inputs.

``data/shapenet.py`` imports neither PIL nor scipy.  Bit-equal to JAX:
``blender_camera_to_quaternion``; ``DataBunch`` over a
reference-layout render tree (PNG renders, ``camera*.mat``), its first 3
train batches and every valid batch, with and without the RAM cache and
camera poses, and through an in-memory ``(train, valid)`` pair;
``sample_mesh_points``, ``normalize_cloud`` and ``load_gt_points`` from
``points.npy``, ``points.npz``, ``models/model_normalized.obj`` and nothing,
with the same generator; ``ShapeNetRenderSet``'s views against JAX's numpy
silhouette renderer.  ``evaluate_gt_clouds`` on 3 models, one without GT:
the same ``n_scored``, Chamfer within relative 1e-4 of JAX's
``chamfer_distance`` and IoU within 1e-6 of JAX's ``iou_3d`` on the port's
predicted clouds (a voxel that flips moves an IoU by 1 / union, ~1e-2
here: no voxel may flip); the port's device-side cloud normalization within
2e-7 of JAX's numpy one (float32 rounding of values <= 0.5).  Both chairs
CLIs run on the tree at the tiny config, and the JAX CLI's ``--multihost``
and ``--tp`` raise ``NotImplementedError``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.data import shapenet as J
from im23d_tpu.data.synthetic import render_silhouettes_np as j_render
from im23d_tpu.metrics.chamfer import chamfer_distance as j_chamfer
from im23d_tpu.metrics.iou import iou_3d as j_iou
from im23d_tpu.ops.quaternion import blender_camera_to_quaternion as j_q
from im23d_tpu_torch.cli import evaluation_test_shape_net as eval_cli
from im23d_tpu_torch.cli import training_test_shape_net as train_cli
from im23d_tpu_torch.data import shapenet as P
from im23d_tpu_torch.data.fabricate import ShapeNetRenderSet
from im23d_tpu_torch.ops.quaternion import blender_camera_to_quaternion
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)
from test_data import _make_shapenet_tree
from test_shapenet_gt import CUBE_OBJ

B, V, K, N, H, S = 2, 2, 2, 128, 32, 16
FLAGS = ["--image_size", str(H), "--voxel_size", str(S), "--num_points",
         str(N), "--num_views", str(V), "--num_candidates", str(K),
         "--batch_size", str(B), "--device", "cpu"]
CHAIRS = "03001627"
GT_POINTS = 256


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """12 chair models (4 train, 8 valid) of 2 views at 48²; valid models
    4-7 carry a points file, so the eval CLI scores 4 of 8."""
    root = str(tmp_path_factory.mktemp("shapenet"))
    _make_shapenet_tree(root, synset=CHAIRS, n=12, views=V, res=48)
    rng = np.random.RandomState(1)
    for i in range(8, 12):
        np.save(os.path.join(root, CHAIRS, f"model_{i:04d}", "points.npy"),
                rng.randn(300, 3).astype(np.float32))
    return root


def test_shapenet_module_imports_without_pil_or_scipy():
    """The card's machine has neither: the data modules import them only
    where an image or a camera file is read."""
    code = ("import sys\n"
            "sys.modules['PIL'] = sys.modules['scipy'] = None\n"
            "import im23d_tpu_torch.data.shapenet\n"
            "import im23d_tpu_torch.data.fabricate\n"
            "import im23d_tpu_torch.cli.evaluation_test_shape_net\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pos", [(4.2, -3.1, 2.0), (-1.5, 2.5, 0.3),
                                 (0.2, 0.1, -3.0), ([[5.0, 4.0, 3.5]])])
def test_blender_camera_to_quaternion_matches_jax(pos):
    got = blender_camera_to_quaternion(np.asarray(pos))
    want = j_q(np.asarray(pos))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _first(it, n):
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("cache_in_ram", [True, False])
@pytest.mark.parametrize("use_camera", [True, False])
def test_databunch_matches_jax(tree, cache_in_ram, use_camera):
    kw = dict(batch_size=B, image_size=H, use_camera=use_camera,
              cache_in_ram=cache_in_ram, num_workers=2)
    jb = J.DataBunch(tree, "chairs", **kw)
    pb = P.DataBunch(tree, "chairs", **kw)
    _assert_batches_equal(_first(pb.train_iter(num_prefetch=2), 3),
                          _first(jb.train_iter(num_prefetch=2), 3))
    valid = list(pb.valid_batches())
    assert len(valid) == 2
    _assert_batches_equal(valid, list(jb.valid_batches()))
    if cache_in_ram:  # a second visit is the cached item itself
        assert all(x is y for x, y in zip(pb.train_ds[0], pb.train_ds[0]))


def test_databunch_in_memory_pair_uses_the_same_batching(tree):
    """A (train, valid) pair of datasets in place of the root gives the
    tree's batches."""
    dirs = [P.get_model_dirs(tree, CHAIRS, s) for s in ("train", "valid")]
    pair = tuple(P.ShapeNetRenders(d, False, H) for d in dirs)
    pb = P.DataBunch(pair, batch_size=B, num_workers=2)
    jb = J.DataBunch(tree, "chairs", B, H, use_camera=False, num_workers=2)
    _assert_batches_equal(_first(pb.train_iter(), 3),
                          _first(jb.train_iter(), 3))
    _assert_batches_equal(list(pb.valid_batches()),
                          list(jb.valid_batches()))


def test_render_set_views_match_jax_renderer():
    """``ShapeNetRenderSet``: each view is JAX's numpy silhouette of the
    model's cloud, quantised to uint8; the item contract and a DataBunch
    batch over it."""
    rs = ShapeNetRenderSet(5, image_size=H, num_views=V, gt_points=GT_POINTS,
                           seed=3)
    sil = j_render(np.repeat(rs.clouds, V, axis=0), rs.quats.reshape(-1, 4),
                   1.2, voxel_size=H // 2, kernel_size=9, out_size=H)
    want = np.clip(sil * 255.0, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(rs.masks.reshape(want.shape), want)
    images, poses, masks = rs[1]
    assert images.shape == (V, H, H, 3) and images.dtype == np.uint8
    assert poses is images and masks.shape == (V, H, H)
    batch = next(iter(P.DataBunch((rs, rs), batch_size=B).valid_batches()))
    assert batch["images"].shape == (2 * B, H, H, 3)
    assert batch["pose_input"].shape == (2 * B * V, H, H, 3)
    assert batch["masks"].shape == (2 * B * V, H, H)
    gt = [g for _, g in rs.gt_pairs(100)]
    jr = np.random.RandomState(0)
    for cloud, g in zip(rs.clouds, gt):
        idx = jr.choice(len(cloud), 100, replace=False)
        np.testing.assert_array_equal(g, J.normalize_cloud(cloud[idx]))


def test_sample_mesh_points_matches_jax():
    rng = np.random.RandomState(0)
    verts = rng.randn(9, 3).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5], [6, 7, 8], [0, 4, 8]])
    got = P.sample_mesh_points(verts, faces, 500, np.random.RandomState(5))
    want = J.sample_mesh_points(verts, faces, 500, np.random.RandomState(5))
    np.testing.assert_array_equal(got, want)
    flat = np.zeros((3, 3), np.float32)  # zero area: uniform faces
    np.testing.assert_array_equal(
        P.sample_mesh_points(flat, faces[:1], 7, np.random.RandomState(1)),
        J.sample_mesh_points(flat, faces[:1], 7, np.random.RandomState(1)))


def test_normalize_cloud_matches_jax():
    pts = np.random.RandomState(0).randn(2, 200, 3) * 7 + 3
    np.testing.assert_array_equal(P.normalize_cloud(pts),
                                  J.normalize_cloud(pts))
    np.testing.assert_array_equal(P.normalize_cloud(pts[0]),
                                  J.normalize_cloud(pts[0]))


@pytest.mark.parametrize("source", ["points.npy", "points.npz", "obj",
                                    "none", "exact"])
def test_load_gt_points_matches_jax(tmp_path, source):
    rng = np.random.RandomState(0)
    raw = rng.randn(100 if source != "exact" else 64, 3).astype(np.float32)
    if source in ("points.npy", "exact"):
        np.save(tmp_path / "points.npy", raw)
    elif source == "points.npz":
        np.savez(tmp_path / "points.npz", pts=raw)
    elif source == "obj":
        (tmp_path / "models").mkdir()
        (tmp_path / "models" / "model_normalized.obj").write_text(CUBE_OBJ)
    jr, pr = np.random.RandomState(3), np.random.RandomState(3)
    want = J.load_gt_points(tmp_path, 64, jr)
    got = P.load_gt_points(tmp_path, 64, pr)
    if source == "none":
        assert got is None and want is None
        return
    assert got.shape == (64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the generators advanced alike
    assert jr.randint(1 << 30) == pr.randint(1 << 30)


def _tiny_cfg():
    return ShapeNetConfig(image_size=H, voxel_size=S, num_points=N,
                          num_views=V, num_candidates=K, batch_size=B,
                          total_steps=10)


def test_evaluate_gt_clouds_matches_jax_metrics(tmp_path):
    """3 models, the third without GT: its render dir is walked after the
    GT read, as JAX's.  The port's predicted clouds, normalized, go
    through JAX's metrics."""
    from PIL import Image

    rng = np.random.RandomState(0)
    dirs = []
    for i in range(3):
        d = tmp_path / f"model_{i}"
        d.mkdir()
        img = (rng.rand(32, 32, 4) * 255).astype(np.uint8)
        Image.fromarray(img, "RGBA").save(d / "render_0.png")
        if i < 2:
            np.save(d / "points.npy", rng.randn(300, 3).astype(np.float32))
        dirs.append(str(d))
    learner = ShapeNetLearner(_tiny_cfg(), device="cpu")
    chamfer, iou, n = eval_cli.evaluate_gt_clouds(
        learner, P.gt_cloud_pairs(dirs, GT_POINTS, H), B)
    assert n == 2

    jr = np.random.RandomState(0)
    gts = [J.load_gt_points(d, GT_POINTS, jr) for d in dirs]
    assert gts[2] is None
    imgs = np.stack([J._load_image_rgba(os.path.join(d, "render_0.png"),
                                        H)[..., :3] for d in dirs[:2]])
    with torch.no_grad():
        x = torch.as_tensor(imgs).float() / 255.0
        pred = learner.model(x, x)["point_cloud"]
    pred_n = eval_cli.normalize_clouds(pred).numpy()
    np.testing.assert_allclose(pred_n, J.normalize_cloud(pred.numpy()),
                               rtol=0, atol=2e-7)
    gt = jnp.asarray(np.stack(gts[:2]))
    total, _, _ = j_chamfer(jnp.asarray(pred_n), gt)
    np.testing.assert_allclose(chamfer, float(jnp.mean(total)), rtol=1e-4)
    want_iou = float(jnp.mean(j_iou(jnp.asarray(pred_n), gt, voxel_size=32)))
    np.testing.assert_allclose(iou, want_iou, rtol=0, atol=1e-6)
    assert 0.0 < want_iou < 1.0

    none = eval_cli.evaluate_gt_clouds(learner, iter(()), B)
    assert np.isnan(none[0]) and none[2] == 0


def test_chairs_clis_on_a_render_tree(tree, tmp_path):
    """2 training steps without ``--synthetic`` (the profiler's trace
    lands), then the eval CLI on the valid split with its ground truth."""
    work, prof = tmp_path / "w", tmp_path / "prof"
    rc = train_cli.main(["--data_root", tree, "--steps", "2", "--workdir",
                         str(work), "--profile_dir", str(prof), *FLAGS])
    assert rc == 0
    assert (work / "checkpoint_2.pt").exists()
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert json.loads((prof / traces[0]).read_text())["traceEvents"]

    out = tmp_path / "eval"
    rc = eval_cli.main(["--workdir", str(work), "--data_root", tree,
                        "--gt_points", str(GT_POINTS), "--out_dir",
                        str(out), *FLAGS])
    assert rc == 0
    metrics = json.loads((out / "eval_metrics.json").read_text())
    assert metrics["step"] == 2
    assert metrics["n_scored"] == 4 and metrics["gt_points"] == GT_POINTS
    for key in ("projection_loss", "total_loss", "chamfer_l2", "iou_3d"):
        assert np.isfinite(metrics[key]), key
    assert metrics["student_projection_shape"] == [2 * B * V, S, S]
