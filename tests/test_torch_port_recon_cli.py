"""The port's ``run_reconstruction --evaluate`` on the CPU against the JAX
``ReconTrainer.evaluate``.

A tiny CMR-format CUB tree from the JAX ``build_structured_cmr_tree`` (3
photos, rendered at 64²) is read by the port's CMR loader through the CLI,
which restores a port checkpoint of the JAX trainer's parameters; JAX
evaluates them on the batches of its own loader.  The CLI
prints its means rounded to 5 decimals: rtol 1e-4, atol 1e-5.  The modes
that later slices bring raise ``NotImplementedError``.
"""

import ast

import jax
import numpy as np
import pytest

from im23d_tpu.data.cmr import CUBDataset as JCUB
from im23d_tpu.data.cmr import batch_iterator as j_batches
from im23d_tpu.data.fabricate import build_structured_cmr_tree
from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.train.recon_trainer import ReconConfig as JConfig
from im23d_tpu.train.recon_trainer import ReconTrainer as JTrainer
from im23d_tpu_torch.cli.run_reconstruction import main
from im23d_tpu_torch.data.cmr import CUBDataset
from im23d_tpu_torch.data.fabricate import StructuredReconSet
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
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


@pytest.mark.parametrize("flags", [
    [], ["--evaluate", "--generate_pseudogt"],
    ["--evaluate", "--export_serving", "x"], ["--evaluate", "--multihost"],
    ["--evaluate", "--profile_dir", "x"], ["--evaluate", "--tensorboard"],
])
def test_unported_modes_raise(flags):
    with pytest.raises(NotImplementedError):
        main([*FLAGS, *flags], datasets=([], []))
