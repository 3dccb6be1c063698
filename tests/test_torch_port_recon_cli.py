"""The port's ``run_reconstruction --evaluate`` on the CPU against the JAX
``ReconTrainer.evaluate``.

A tiny CMR-format CUB tree from the JAX ``build_structured_cmr_tree`` (3
photos, rendered at 64²) is read by the port's CMR loader through the CLI,
which restores a port checkpoint of the JAX trainer's parameters; JAX
evaluates them on the batches of its own loader.  The CLI
prints its means rounded to 5 decimals: rtol 1e-4, atol 1e-5.  The
training loop, ``--continue_train`` and ``--generate_pseudogt`` run on such
a tree at a tiny configuration (the finite losses, checkpoints, images and
cache files are checked; their values are held to JAX in
``tests/test_torch_port_recon_train.py`` and
``tests/test_torch_port_pseudogt.py``).  ``--multihost``, which a later
slice brings, raises ``NotImplementedError``; ``--data_processes`` runs in
``tests/test_torch_port_data_feeds.py``, ``--export_serving`` in
``tests/test_torch_port_serve.py``.
"""

import ast
import json
import os

import jax
import numpy as np
import pytest
import torch

from im23d_tpu.data.cmr import CUBDataset as JCUB
from im23d_tpu.data.cmr import batch_iterator as j_batches
from im23d_tpu.data.fabricate import build_structured_cmr_tree
from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.train.recon_trainer import ReconConfig as JConfig
from im23d_tpu.train.recon_trainer import ReconTrainer as JTrainer
from im23d_tpu_torch.cli.run_reconstruction import main
from im23d_tpu_torch.core.profiler import StepProfiler
from im23d_tpu_torch.data.cmr import CUBDataset
from im23d_tpu_torch.data.fabricate import StructuredReconSet
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.geometry.objio import save_obj, uv_sphere
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

N, RES, BS = 3, 64, 2
FLAGS = ["--name", "r", "--dataset", "cub", "--batch_size", str(BS),
         "--image_resolution", str(RES), "--texture_resolution", "64",
         "--compute_dtype", "float32", "--num_workers", "1", "--device",
         "cpu"]
KEYS = ("image", "scale", "translation", "rotation", "idx")


def _trainers(dataset_size):
    """The JAX trainer with a mesh head that moves the sphere, and the
    port's trainer with its parameters."""
    jt = JTrainer(JConfig(image_resolution=RES, texture_resolution=64,
                          batch_size=BS), dataset_size=dataset_size,
                  template=JTemplate(segments=32, rings=16),
                  mesh=make_mesh(jax.devices()[:1]))
    params = jax.tree.map(np.asarray, jt.params)
    k = params["conv_mesh"]["kernel"]
    params["conv_mesh"]["kernel"] = np.random.RandomState(0).randn(
        *k.shape).astype(np.float32) * 0.01
    jt.params = params
    pt = ReconTrainer(ReconConfig(image_resolution=RES, texture_resolution=64,
                                  batch_size=BS, compute_dtype="float32"),
                      dataset_size=dataset_size,
                      template=MeshTemplate(segments=32, rings=16),
                      device="cpu")
    pt.load_params({"params": params,
                    "batch_stats": jax.tree.map(np.asarray, jt.batch_stats)})
    return jt, pt


def test_evaluate_cli_matches_jax_on_a_cmr_tree(tmp_path, monkeypatch,
                                                capsys):
    root = build_structured_cmr_tree(str(tmp_path), N, photo_res=RES,
                                     texture_resolution=32, batch=N)
    jt, pt = _trainers(N)
    pt.total_it = 4
    pt.save(str(tmp_path / "checkpoints_recon" / "r"))
    monkeypatch.chdir(tmp_path)
    assert main([*FLAGS, "--datasets_root", root, "--evaluate"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])

    ref = jt.evaluate(j_batches(JCUB(root, "testval", False, RES), BS,
                                shuffle=False, drop_last=False, keys=KEYS))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert ref["iou"] > 0.1  # the sphere overlaps the rendered birds

    # the port's loader reads the tree as the JAX loader does
    a, b = CUBDataset(root, "testval", False, RES)[1], JCUB(
        root, "testval", False, RES)[1]
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k])


def test_evaluate_cli_takes_datasets(tmp_path, monkeypatch, capsys):
    """``main(datasets=...)`` evaluates an in-memory set, as the GPU smoke
    run feeds the fabricated photos."""
    tpl = MeshTemplate(segments=32, rings=16)
    ds = StructuredReconSet(tpl, N, photo_res=RES, texture_resolution=32,
                            batch=N)
    _, pt = _trainers(len(ds))
    pt.save(str(tmp_path / "checkpoints_recon" / "r"), tag="latest")
    monkeypatch.chdir(tmp_path)
    assert main([*FLAGS, "--evaluate"], datasets=(ds, ds)) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    ref = pt.evaluate(j_batches(ds, BS, shuffle=False, drop_last=False))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5)


def test_train_continue_and_pseudogt_cli_on_a_cmr_tree(tmp_path,
                                                       monkeypatch):
    """Two epochs with every frequency at 1, one more with
    ``--continue_train``, then ``--generate_pseudogt`` (its visibility
    render at the CLI's 1024²): a uv_sphere(8, 4) template keeps the plain
    rasterizer quick on the CPU."""
    root = build_structured_cmr_tree(str(tmp_path), N, photo_res=RES,
                                     texture_resolution=32, batch=N)
    sphere = uv_sphere(8, 4)
    save_obj(str(tmp_path / "sphere"), sphere, sphere.vertices)
    flags = [*FLAGS, "--datasets_root", root, "--mesh_path",
             str(tmp_path / "sphere.obj")]
    freqs = ["--checkpoint_freq", "1", "--save_freq", "1", "--evaluate_freq",
             "1", "--image_freq", "1"]
    monkeypatch.chdir(tmp_path)
    assert main([*flags, "--epochs", "2", *freqs, "--tensorboard",
                 "--profile_dir", str(tmp_path / "prof")]) == 0
    workdir = tmp_path / "checkpoints_recon" / "r"
    assert {"checkpoint_1.pt", "checkpoint_2.pt"} <= set(os.listdir(workdir))
    assert main([*flags, "--epochs", "3", "--continue_train", *freqs]) == 0
    assert "checkpoint_3.pt" in os.listdir(workdir)
    records = [json.loads(line) for line in
               (workdir / "metrics_recon.jsonl").read_text().splitlines()]
    train = [r for r in records if "recon_loss" in r]
    val = [r for r in records if "val/recon_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert len(val) == 3
    assert all(np.isfinite(v) for r in records for k, v in r.items()
               if k not in ("step", "time"))
    assert len(os.listdir(workdir / "images")) == 3

    assert main([*flags, "--generate_pseudogt", "--pseudogt_resolution",
                 "32"]) == 0
    cache = tmp_path / "cache" / "cub"
    assert sorted(os.listdir(cache / "pseudogt_32x32")) == [
        f"{i}.npz" for i in range(N)]
    item = np.load(cache / "pseudogt_32x32" / "1.npz",
                   allow_pickle=True)["data"].item()
    assert item["mesh"].shape == (3, 32, 32)
    assert item["texture"].shape == (3, 32, 32)
    assert item["texture"].dtype == np.float16
    assert item["texture_alpha"].shape == (1, 32, 32)
    assert item["image"].shape == (3, 299, 299)
    assert 0 < float((item["texture_alpha"] > 0).mean()) < 1
    meta = np.load(cache / "poses_metadata.npz",
                   allow_pickle=True)["data"].item()
    assert meta["path"] == CUBDataset(root, "train", False, RES).get_paths()
    for split in ("train", "testval"):
        stats = np.load(cache / f"precomputed_fid_299x299_{split}.npz")
        assert stats["stats_m"].shape == (288,)
        assert np.isfinite(stats["stats_s"]).all()
        assert int(stats["num_images"]) == N


def test_step_profiler_writes_a_chrome_trace(tmp_path):
    """``--profile_dir``'s profiler traces ticks ``start`` to
    ``start + steps`` and writes one Chrome trace; ``close`` ends an open
    window."""
    prof = StepProfiler(str(tmp_path / "a"), start=1, steps=2)
    for _ in range(5):
        prof.tick()
        torch.ones(8).sum()
    prof.close()
    assert os.listdir(tmp_path / "a") == ["trace_steps_1-3.json"]
    trace = json.loads((tmp_path / "a" / "trace_steps_1-3.json").read_text())
    assert trace["traceEvents"]
    open_window = StepProfiler(str(tmp_path / "b"), start=0, steps=10)
    open_window.tick()
    open_window.close()
    assert os.listdir(tmp_path / "b") == ["trace_steps_0-1.json"]
