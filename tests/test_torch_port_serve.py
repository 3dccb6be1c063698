"""The port's serving export (``serve/export.py`` on ``torch.export``) and
the custom ops K8 and K9 run as, on the CPU.

  * ``im23d::head_conv_tanh`` (and K8's dW, ``im23d::head_conv_dw``,
    which its backward calls) and ``im23d::fused_affine_conv3x3``: their
    CPU implementations bit-equal to the plain versions, and
    ``torch.library.opcheck`` (schema, fake tensors, autograd
    registration, AOT dispatch) on each, with and without the affine;
  * artifacts round-tripped on the CPU: a small module, the GAN's EMA
    generator with and without class conditioning (and a text-conditional
    one, its captions unresolved), the reconstruction network in eval
    mode, each against the port trainer's own output (the same graph on
    the same weights: bit-equal); an unknown platform raises;
  * ``--export_serving`` in both CLIs: the GAN CLI's artifact of a trained
    checkpoint against ``generate`` of the restored trainer, the
    ``--which_epoch best`` refusal; the recon CLI's against ``predict``.
"""

import os
import zipfile

import pytest
import torch

from im23d_tpu_torch.cli import main as gan_cli
from im23d_tpu_torch.cli import run_reconstruction as recon_cli
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.models.gan import GANConfig
from im23d_tpu_torch.ops.conv import (
    fused_affine_conv3x3_torch,
    head_conv_dw_torch,
    head_conv_tanh_torch,
)
from im23d_tpu_torch.serve import (
    export_gan_inference,
    export_reconstruction_inference,
    load_artifact,
    save_artifact,
)
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer
from test_cli_main import make_synthetic_cub_cache

HEAD_OP = torch.ops.im23d.head_conv_tanh
FUSED_OP = torch.ops.im23d.fused_affine_conv3x3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread beside the suite's other workers (as the GAN
    test files)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _head_args(seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 16, 8, 12), generator=gen).to(dtype)
    w = torch.randn((3, 16, 5, 5), generator=gen) * 0.1
    b = torch.randn(3, generator=gen) * 0.1
    return x, w, b


def _fused_args(seed, affine, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 16, 6, 8), generator=gen).to(dtype)
    a = torch.rand((2, 16), generator=gen) + 0.5 if affine else None
    b = torch.randn((2, 16), generator=gen) if affine else None
    w = torch.randn((32, 16, 3, 3), generator=gen) * 0.1
    return x, a, b, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
def test_head_conv_op_cpu_is_the_plain_version(pad_mode, dtype):
    x, w, b = _head_args(1, dtype)
    y = HEAD_OP(x, w, b, pad_mode)
    assert y.dtype == dtype
    assert torch.equal(y, head_conv_tanh_torch(x, w, b, pad_mode))
    args = [t.clone().requires_grad_(t.is_floating_point()) for t in
            _head_args(2)]
    torch.library.opcheck(HEAD_OP.default, (*args, pad_mode))
    g = torch.randn((2, 3, 8, 12), generator=torch.Generator().manual_seed(5))
    dw = torch.ops.im23d.head_conv_dw(x, g, pad_mode)
    assert torch.equal(dw, head_conv_dw_torch(x, g, pad_mode))
    torch.library.opcheck(torch.ops.im23d.head_conv_dw.default,
                          (x, g, pad_mode))


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
def test_fused_conv_op_cpu_is_the_plain_version(pad_mode, affine):
    x, a, b, w = _fused_args(3, affine, torch.bfloat16)
    assert torch.equal(FUSED_OP(x, a, b, w, pad_mode),
                       fused_affine_conv3x3_torch(x, a, b, w, pad_mode))
    args = [None if t is None else t.clone().requires_grad_()
            for t in _fused_args(4, affine)]
    torch.library.opcheck(FUSED_OP.default, (*args, pad_mode))


def test_artifact_roundtrip_simple(tmp_path):
    lin = torch.nn.Linear(4, 4)
    module = torch.nn.Sequential(lin, torch.nn.Tanh())
    x = torch.ones((2, 4))
    path = str(tmp_path / "fn.pt2.zip")
    save_artifact(path, module, (x,), platforms=("cpu",))
    with zipfile.ZipFile(path) as zf:
        assert zf.namelist() == ["cpu.pt2"]
    with torch.no_grad():
        assert torch.equal(load_artifact(path, "cpu")(x), module(x))
    with pytest.raises(ValueError):
        load_artifact(path, "cuda")
    with pytest.raises(ValueError):
        save_artifact(path, module, (x,), platforms=("tpu", "cpu"))


@pytest.mark.parametrize("kind", ["class", "text"])
def test_gan_export_matches_trainer(tmp_path, kind):
    model = dict(texture_resolution=128, mesh_resolution=32, n_classes=(3,))
    if kind == "class":
        model["conditional_class"] = True
    else:  # no class input; the captions stay unresolved
        model.update(conditional_text=True, text_embedding_dim=32)
    trainer = GANTrainer(GANTrainConfig(model=GANConfig(**model),
                                        batch_size=2, text_vocab_size=50),
                         template=MeshTemplate(segments=16, rings=8),
                         device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-zero mesh head and running statistics
        for name, t in trainer.g_ema.state_dict().items():
            if name.startswith("conv_mesh") or "running_mean" in name:
                t.add_(torch.randn(t.shape, generator=gen) * 0.05)
    path = str(tmp_path / "gen.zip")
    export_gan_inference(trainer, 2, path, platforms=("cpu",))
    z = torch.randn((2, 64), generator=gen)
    c = torch.tensor([[0], [2]]) if kind == "class" else None
    served = load_artifact(path, "cpu")
    got = served(z, c) if c is not None else served(z)
    want = trainer.generate(z, c)
    assert got[0].shape == (2, 128, 128, 3)
    assert got[1].shape == (2, 32, 32, 3)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert float(want[1].abs().max()) > 0


def _recon_trainer(workdir=None, dataset_size=3):
    cfg = ReconConfig(image_resolution=64, texture_resolution=64,
                      batch_size=2, compute_dtype="float32")
    trainer = ReconTrainer(cfg, dataset_size=dataset_size,
                           template=MeshTemplate(segments=16, rings=8),
                           workdir=workdir, device="cpu")
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, t in trainer.model.state_dict().items():
            if name.startswith("conv_mesh") or "running" in name:
                t.add_(torch.rand(t.shape, generator=gen) * 0.1)
    return trainer


def _images(seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((2, 64, 64, 4), generator=gen)


def test_recon_export_matches_trainer(tmp_path):
    trainer = _recon_trainer()
    path = str(tmp_path / "recon.zip")
    export_reconstruction_inference(trainer, 2, path, platforms=("cpu",))
    images = _images(3)
    got = load_artifact(path, "cpu")(images)
    want = trainer.predict(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(want[1].abs().max()) > 0


def test_gan_cli_export_serving(tmp_path, monkeypatch):
    """``--export_serving`` of a saved checkpoint: the artifact against
    ``generate`` of the trainer that saved it; ``--which_epoch best``
    refuses to export."""
    make_synthetic_cub_cache(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    trainer = GANTrainer(GANTrainConfig(model=GANConfig(
        texture_resolution=128, num_discriminators=2,
        conditional_class=True, n_classes=(200,)), batch_size=2),
        template=MeshTemplate(segments=32, rings=16),
        workdir=os.path.join("gan_weights", "srv"), device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, t in trainer.g_ema.state_dict().items():
            if name.startswith("conv_mesh") or "running_mean" in name:
                t.add_(torch.randn(t.shape, generator=gen) * 0.05)
    trainer.save()
    args = ["--name", "srv", "--dataset", "cub", "--texture_resolution",
            "128", "--batch_size", "2", "--num_discriminators", "2",
            "--device", "cpu", "--conditional_class"]
    path = str(tmp_path / "gan.zip")
    with pytest.raises(SystemExit):
        gan_cli.main([*args, "--export_serving", path, "--which_epoch",
                      "best"])
    assert not os.path.exists(path)
    assert gan_cli.main([*args, "--export_serving", path,
                         "--export_platforms", "cpu"]) == 0
    z = torch.randn((2, 64), generator=gen)
    c = torch.tensor([[5], [199]])
    got = load_artifact(path, "cpu")(z, c)
    for g, w in zip(got, trainer.generate(z, c)):
        assert torch.equal(g, w)


def test_recon_cli_export_serving(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = _recon_trainer(os.path.join("checkpoints_recon", "r"))
    trainer.save()
    path = str(tmp_path / "recon.zip")
    flags = ["--name", "r", "--dataset", "cub", "--batch_size", "2",
             "--image_resolution", "64", "--texture_resolution", "64",
             "--device", "cpu",
             "--export_serving", path, "--export_platforms", "cpu"]
    assert recon_cli.main(flags, datasets=([None] * 3, [])) == 0
    images = _images(5)
    for g, w in zip(load_artifact(path, "cpu")(images),
                    trainer.predict(images)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
