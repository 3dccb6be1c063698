"""The pseudo-GT cache's FID statistics pair with the GAN's extractor.

``run_reconstruction --generate_pseudogt --inception_weights F`` writes the
cache's statistics with the 2048-d pool3 extractor of ``F``, and the GAN's
``FIDEvaluator`` with the extractor of the same file (what ``cli/main.py
--inception_weights F`` builds) scores against them.  Without the flag the
cache holds the random extractor's 288-d statistics, which that evaluator
refuses.  No pretrained file exists here: ``F`` is a saved random-init
``InceptionV3Features`` state dict.  A tiny run on the CPU: a 2-photo
CMR-format CUB tree at 64², the pseudo-GT at 32² with a ``uv_sphere(8, 4)``
template (its visibility render is at the CLI's 1024²), FID renders at 32².
"""

import numpy as np
import pytest
import torch

from im23d_tpu.data.fabricate import build_structured_cmr_tree
from im23d_tpu_torch.cli.run_reconstruction import main
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.geometry.objio import save_obj, uv_sphere
from im23d_tpu_torch.metrics.inception import (
    InceptionV3Features,
    load_inception,
)
from im23d_tpu_torch.models.gan import GANConfig
from im23d_tpu_torch.train.gan_eval import (
    FIDEvaluator,
    load_precomputed_stats,
)
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer

N, RES = 2, 64


def test_pseudogt_statistics_pair_with_the_gan_extractor(tmp_path,
                                                         monkeypatch):
    torch.manual_seed(0)
    weights = tmp_path / "inception.pth"
    torch.save(InceptionV3Features("pool3").state_dict(), weights)
    root = build_structured_cmr_tree(str(tmp_path), N, photo_res=RES,
                                     texture_resolution=32, batch=N)
    sphere = uv_sphere(8, 4)
    save_obj(str(tmp_path / "sphere"), sphere, sphere.vertices)
    template = MeshTemplate(str(tmp_path / "sphere.obj"))
    ReconTrainer(ReconConfig(image_resolution=RES, texture_resolution=64,
                             batch_size=N, compute_dtype="float32"),
                 dataset_size=N, template=template, device="cpu").save(
        str(tmp_path / "checkpoints_recon" / "r"), tag="latest")
    monkeypatch.chdir(tmp_path)
    assert main(["--name", "r", "--dataset", "cub", "--batch_size", str(N),
                 "--image_resolution", str(RES), "--texture_resolution",
                 "64", "--compute_dtype", "float32", "--num_workers", "1",
                 "--device", "cpu", "--datasets_root", root, "--mesh_path",
                 str(tmp_path / "sphere.obj"), "--generate_pseudogt",
                 "--pseudogt_resolution", "32", "--inception_weights",
                 str(weights)]) == 0
    cache = tmp_path / "cache" / "cub"
    stats = {split: load_precomputed_stats(
        str(cache / f"precomputed_fid_299x299_{split}.npz"))
        for split in ("train", "testval")}
    for m, s, n, _ in stats.values():
        assert m.shape == (2048,) and s.shape == (2048, 2048) and n == N
        assert np.isfinite(m).all() and np.isfinite(s).all()

    gan = GANTrainer(GANTrainConfig(
        model=GANConfig(texture_resolution=128, num_discriminators=2,
                        compute_dtype="float32"), batch_size=N),
        template=template, device="cpu")
    evaluator = FIDEvaluator(gan, template, 32,
                             load_inception(str(weights), "cpu"))
    meta = np.load(cache / "poses_metadata.npz",
                   allow_pickle=True)["data"].item()
    batch = {k: np.asarray(meta[k], np.float32)
             for k in ("scale", "translation", "rotation")}
    acts = evaluator.activations_for_batches([batch])["combined"]
    m_real, s_real, _, _ = stats["train"]
    assert np.isfinite(evaluator.fid_against_stats(acts, m_real, s_real))
    with pytest.raises(ValueError, match="288"):
        evaluator.fid_against_stats(acts, np.zeros(288), np.eye(288))
