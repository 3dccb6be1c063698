"""The Pipeline-A inference slice of the PyTorch port against JAX.

``unsupervised_loss`` (both ``training`` values) at B=2, V=2, K=2, N=256,
S=32 with one numpy keep mask on both sides (rtol 1e-4); the learner's eval
step from converted JAX params; the eval CLI end to end on the CPU; and the
rule that the port never imports JAX.
"""

import json
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import im23d_tpu_torch
from im23d_tpu.data.synthetic import SyntheticSilhouettes as JSynthetic
from im23d_tpu.losses.effective import unsupervised_loss as j_loss
from im23d_tpu_torch.cli.evaluation_test_shape_net import main as cli_main
from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes
from im23d_tpu_torch.losses.effective import unsupervised_loss
from im23d_tpu_torch.train.shapenet_learner import (
    ShapeNetConfig,
    ShapeNetLearner,
)

B, V, K, N, S, H = 2, 2, 2, 256, 32, 64
RTOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outputs(seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        point_cloud=((rng.rand(B, N, 3) - 0.5) * 0.7).astype(np.float32),
        scale=(0.3 + 0.6 * rng.rand(B, 1)).astype(np.float32),
        ensemble_q=rng.randn(B * V, K, 4).astype(np.float32),
        student_q=rng.randn(B * V, 4).astype(np.float32),
    ), rng.rand(B * V, H, H).astype(np.float32), (
        rng.rand(B, N) > 0.4).astype(np.float32)


@pytest.mark.parametrize("training", [False, True])
def test_unsupervised_loss_matches_jax(training):
    outputs, masks, keep = _outputs()
    ref_l, ref_aux = j_loss(
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(masks),
        jnp.float32(1.1), jnp.asarray(keep), V, voxel_size=S,
        training=training)
    with torch.no_grad():
        got_l, got_aux = unsupervised_loss(
            {k: torch.from_numpy(v) for k, v in outputs.items()},
            torch.from_numpy(masks), torch.tensor(1.1),
            torch.from_numpy(keep), V, voxel_size=S, training=training)
    assert set(got_l) == set(ref_l)
    for k in ref_l:
        np.testing.assert_allclose(float(got_l[k]), float(ref_l[k]),
                                   rtol=RTOL)
    np.testing.assert_allclose(got_aux["projection"].numpy(),
                               np.asarray(ref_aux["projection"]), atol=1e-5)
    if training:
        np.testing.assert_array_equal(got_aux["min_indexes"].numpy(),
                                      np.asarray(ref_aux["min_indexes"]))


def test_project_candidates_without_scale_matches_jax():
    """No scale head: the port projects at scale 1, JAX skips the scale."""
    from im23d_tpu.losses.effective import project_candidates as j_project
    from im23d_tpu_torch.losses.effective import project_candidates

    outputs, _, keep = _outputs(1)
    q = outputs["ensemble_q"].reshape(B, V * K, 4)
    ref = j_project(jnp.asarray(outputs["point_cloud"]), jnp.asarray(q),
                    jnp.float32(0.7), weights=jnp.asarray(keep), voxel_size=S)
    got = project_candidates(torch.from_numpy(outputs["point_cloud"]),
                             torch.from_numpy(q), torch.tensor(0.7),
                             weights=torch.from_numpy(keep), voxel_size=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _small_cfg(**kw):
    return ShapeNetConfig(image_size=H, voxel_size=S, num_points=N,
                          num_views=V, num_candidates=K, batch_size=B, **kw)


def test_eval_step_matches_jax_learner():
    """Same params and batch; keep-prob 1 so both dropout masks keep all."""
    from im23d_tpu.train.shapenet_learner import ShapeNetConfig as JConfig
    from im23d_tpu.train.shapenet_learner import ShapeNetLearner as JLearner

    fields = dict(image_size=H, voxel_size=S, num_points=N, num_views=V,
                  num_candidates=K, batch_size=B, p_schedule=(1.0, 1.0))
    jl = JLearner(JConfig(**fields))
    port = ShapeNetLearner(ShapeNetConfig(**fields), device="cpu")
    port.load_params(jax.tree.map(np.asarray, jl.state.params))
    batch = JSynthetic(B, H, V, n_points=128, seed=3).next_batch()
    ref = jl.eval_step(batch)
    got = port.eval_step(batch)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL)


def test_synthetic_copy_matches_jax_generator():
    a = SyntheticSilhouettes(2, 32, 2, n_points=64, seed=5).next_batch(True)
    b = JSynthetic(2, 32, 2, n_points=64, seed=5).next_batch(True)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_save_restore_roundtrip(tmp_path):
    cfg = _small_cfg()
    a = ShapeNetLearner(cfg, device="cpu")
    a.step = 7
    a.save(str(tmp_path))
    b = ShapeNetLearner(ShapeNetConfig(**{**cfg.__dict__, "seed": 1}),
                        device="cpu")
    b.restore(str(tmp_path))
    assert b.step == 7
    torch.testing.assert_close(b.model.state_dict(), a.model.state_dict())
    with pytest.raises(FileNotFoundError):
        b.restore(str(tmp_path), step=8)


def test_eval_cli_synthetic_on_cpu(tmp_path):
    ShapeNetLearner(_small_cfg(), device="cpu").save(str(tmp_path / "ckpt"))
    flags = ["--image_size", str(H), "--voxel_size", str(S), "--num_points",
             str(N), "--num_views", str(V), "--num_candidates", str(K),
             "--batch_size", str(B)]
    out = tmp_path / "eval"
    rc = cli_main(["--workdir", str(tmp_path / "ckpt"), "--synthetic",
                   "--num_batches", "2", "--out_dir", str(out), "--device",
                   "cpu", *flags])
    assert rc == 0
    metrics = json.loads((out / "eval_metrics.json").read_text())
    for key in ("projection_loss", "total_loss", "chamfer_l2", "iou_3d"):
        assert np.isfinite(metrics[key]), key
    assert metrics["student_projection_shape"] == [B * V, S, S]
    assert metrics["candidate_projection_shape"] == [B * V, K, S, S]
    for name in ("student_projections", "candidate_projections", "gt_masks"):
        assert (out / f"{name}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_port_never_imports_jax():
    mods = [m.name for m in pkgutil.walk_packages(
        im23d_tpu_torch.__path__, "im23d_tpu_torch.")]
    assert "im23d_tpu_torch.ops.projection" in mods
    for m in ("ops.conv", "models.gan", "data.pseudogt", "train.gan_trainer",
              "train.gan_eval", "cli.main", "ops.splat", "geometry.marching",
              "cli.pointcloud_to_mesh", "parallel.mesh", "parallel.launch",
              "parallel.stages", "graft_entry", "cli.import_torch",
              "data.fastloader"):
        assert f"im23d_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'im23d_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
