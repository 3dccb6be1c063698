"""The port's reference-checkpoint import (``cli/import_torch.py``) on the
CPU: fabricated ``.pth`` files in the reference's layout (the state
dicts of ``tests/test_torch_convert.py``) go through the port's CLI with
``--device cpu``, are restored by the port's trainers and CLIs, and are
held against the JAX package's conversion of the same dicts
(``convert_generator`` / ``convert_reconstruction`` and flax ``.apply``;
no JAX trainer is built).

Tolerances, those of ``tests/test_torch_port_gan.py`` and
``tests/test_torch_port_recon.py``: the generator's texture and mesh map
within 1e-4 × max(1, max |ref|) (1600 products a pixel through the
conditional batch norms, summed in another order than XLA's); the recon
network's outputs within 1e-4 at unit gain a layer.  Copied weights,
counters, curves and the fresh critics' and optimizers' state are held
exactly.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.core.torch_convert import (
    convert_generator,
    convert_reconstruction,
)
from im23d_tpu.models import gan as jgan
from im23d_tpu.models.reconstruction import ReconstructionNetwork as JNet
from im23d_tpu_torch.cli import import_torch
from im23d_tpu_torch.cli import main as gan_cli
from im23d_tpu_torch.cli import run_reconstruction as recon_cli
from im23d_tpu_torch.core.convert import REFERENCE_CURVES
from im23d_tpu_torch.data.fabricate import StructuredReconSet
from im23d_tpu_torch.data.cmr import batch_iterator
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.models import gan as tgan
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig, GANTrainer
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer
from test_cli_main import make_synthetic_cub_cache
from test_torch_convert import (
    _rand,
    make_generator_state_dict,
    make_recon_state_dict,
)

RES = 128  # the generator's smallest texture resolution
N = 6  # images behind the recon checkpoint's DatasetParams
CURVES = dict(g_curve=[1.0, 0.5], flat_curve=[3.0], d_fake_curve=[0.1],
              d_real_curve=[0.2, 0.3])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread beside the suite's other workers (see
    ``tests/test_torch_port_gan.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _gan_state_dict(seed: int, n_classes=(5,), text_dim=None) -> dict:
    """A reference ``Generator`` state dict at 128² with a non-zero mesh
    head; two class counts give the class + colour embeddings, half the
    latent width each; ``text_dim`` adds ``SpatialAttention``."""
    rng = np.random.RandomState(seed)
    sd = make_generator_state_dict(rng, tex_res=RES, n_classes=n_classes[0])
    if len(n_classes) == 2:
        sd["emb_class.weight"] = _rand(rng, n_classes[0], 32)
        sd["emb_color.weight"] = _rand(rng, n_classes[1], 32)
    sd["conv_mesh.weight"] = _rand(rng, 3, 64, 5, 5)
    sd["conv_mesh.bias"] = _rand(rng, 3)
    if text_dim is not None:
        sd["att.conv_context.weight"] = _rand(rng, 256, text_dim, 1, 1)
    return sd


def _gan_pth(path, n_classes=(5,), dataset="cub", **args) -> tuple:
    """Write a reference GAN checkpoint (``args`` override the snapshot's
    entries); returns (generator dict, EMA dict)."""
    gen_sd = _gan_state_dict(0, n_classes)
    ema_sd = _gan_state_dict(1, n_classes)
    snapshot = dict(texture_resolution=RES, mesh_resolution=32,
                    symmetric_g=True, texture_only=False, latent_dim=64,
                    # the reference's truthy-string default: the weights,
                    # not this, decide the conditioning
                    conditional_class="--conditional_class",
                    norm_g="syncbatch", num_discriminators=-1,
                    dataset=dataset)
    snapshot.update(args)
    torch.save(dict(generator=_tensors(gen_sd),
                    generator_running_avg=_tensors(ema_sd),
                    epoch=7, iteration=123, **CURVES, args=snapshot), path)
    return gen_sd, ema_sd


def _gan_trainer(seed: int, **model) -> GANTrainer:
    cfg = tgan.GANConfig(texture_resolution=RES, num_discriminators=2,
                         **model)
    return GANTrainer(GANTrainConfig(model=cfg, batch_size=2, seed=seed),
                      template=MeshTemplate(segments=8, rings=4),
                      device="cpu")


def _check_gan(tmp_path, n_classes, c, dataset, model):
    """Import, restore into a trainer of another seed, and hold it to flax
    and to a fresh trainer of the import's seed."""
    gen_sd, ema_sd = _gan_pth(tmp_path / "ref.pth", n_classes, dataset)
    assert import_torch.main([
        "--checkpoint", str(tmp_path / "ref.pth"), "--weights", "imp",
        "--out_root", str(tmp_path), "--device", "cpu"]) == 0
    trainer = _gan_trainer(1, **model)
    trainer.restore(str(tmp_path / "imp"))
    assert trainer.epoch == 7 and trainer.total_it == 123
    # the port's curves file keeps float32
    assert trainer.curves == {key: np.float32(CURVES[ref]).tolist()
                              for ref, key in REFERENCE_CURVES}
    for net, sd in ((trainer.generator, gen_sd), (trainer.g_ema, ema_sd)):
        have = net.state_dict()
        for k, v in sd.items():
            assert torch.equal(have[k], torch.from_numpy(v)), k
    fresh = _gan_trainer(0, **model)
    for k, v in fresh.discriminator.state_dict().items():
        assert torch.equal(trainer.discriminator.state_dict()[k], v), k
    for opt in ("opt_g", "opt_d"):
        got, want = (getattr(t, opt).state_dict() for t in (trainer, fresh))
        assert got == want and not got["state"]

    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, 64)).astype(np.float32)
    jg = jgan.Generator(jgan.GANConfig(texture_resolution=RES, **model))
    (tex, mesh), _ = jax.jit(lambda v, z, c: jg.apply(
        v, z, c, train=False, mutable=["batch_stats"]))(
        convert_generator(ema_sd), jnp.asarray(z), jnp.asarray(c))
    got = trainer.generate(torch.from_numpy(z), c)
    for g, r in zip(got, (tex, mesh)):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()))
    assert float(np.abs(np.asarray(mesh)).max()) > 1e-3


def test_import_cub_gan_matches_flax(tmp_path):
    """Class conditioning inferred from ``emb_class`` (5 classes), the
    snapshot's ``syncbatch`` and ``-1`` critics read as the CLI reads
    them."""
    _check_gan(tmp_path, (5,), np.array([[1], [3]], np.int32), "cub",
               dict(conditional_class=True, n_classes=(5,)))


def test_import_p3d_gan_matches_flax(tmp_path):
    """Class and colour conditioning inferred from ``emb_class`` and
    ``emb_color``."""
    _check_gan(tmp_path, (6, 4), np.array([[1, 0], [5, 3]], np.int32), "p3d",
               dict(conditional_class=True, conditional_color=True,
                    n_classes=(6, 4)))


def test_import_text_gan_sets_the_encoder(tmp_path):
    """A text-conditional checkpoint's ``text_encoder`` dict gives the
    encoder that ``set_text_encoder`` on that dict gives."""
    dim, vocab = 16, 23
    gen = torch.Generator().manual_seed(3)
    te_sd = {"encoder.weight": torch.randn((vocab, dim), generator=gen)}
    for sfx in ("", "_reverse"):
        for name, shape in (("weight_ih", (2 * dim, dim)),
                            ("weight_hh", (2 * dim, dim // 2)),
                            ("bias_ih", (2 * dim,)), ("bias_hh", (2 * dim,))):
            te_sd[f"rnn.{name}_l0{sfx}"] = torch.randn(shape, generator=gen)
    sd = _gan_state_dict(0, text_dim=dim)
    torch.save(dict(generator=_tensors(sd), generator_running_avg=_tensors(sd),
                    text_encoder=te_sd, epoch=1, iteration=2,
                    args=dict(texture_resolution=RES, conditional_text=True,
                              text_embedding_dim=dim, num_discriminators=2)),
               tmp_path / "ref.pth")
    assert import_torch.main([
        "--checkpoint", str(tmp_path / "ref.pth"), "--weights", "imp",
        "--out_root", str(tmp_path), "--device", "cpu"]) == 0
    model = dict(conditional_class=True, n_classes=(5,),
                 conditional_text=True, text_embedding_dim=dim)
    cfg = tgan.GANConfig(texture_resolution=RES, num_discriminators=2,
                         **model)
    trainer = GANTrainer(GANTrainConfig(model=cfg, batch_size=2, seed=1,
                                        text_vocab_size=vocab),
                         template=MeshTemplate(segments=8, rings=4),
                         device="cpu")
    trainer.restore(str(tmp_path / "imp"))
    direct = _gan_trainer(0, **model)
    direct.set_text_encoder(te_sd, vocab, dim, dim // 2)
    want = direct.text_encoder.state_dict()
    assert trainer.text_encoder.state_dict().keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(trainer.text_encoder.state_dict()[k], v), k
    tokens = torch.tensor([[3, 7, 22, 0], [1, 2, 0, 0]])
    for a, b in zip(trainer.encode_caption(tokens),
                    direct.encode_caption(tokens)):
        assert torch.equal(a, b)
    assert torch.equal(trainer.g_ema.state_dict()["att.conv_context.weight"],
                       torch.from_numpy(sd["att.conv_context.weight"]))


def _recon_state_dict(seed: int) -> dict:
    """``make_recon_state_dict`` (256² photos, 64² texture) with a
    non-zero mesh head, each layer at unit gain (as
    ``tests/test_torch_port_recon.py`` holds it to flax)."""
    sd = make_recon_state_dict(np.random.RandomState(seed))
    sd["conv_mesh.weight"] = np.random.RandomState(seed + 1).randn(
        3, 64, 5, 5).astype(np.float32) * 0.05
    return {k: (v / (0.05 * np.sqrt(v[0].size))).astype(np.float32)
            if v.ndim >= 2 else v for k, v in sd.items()}


def _dataset_params(n: int, seed: int, z0: bool = True) -> dict:
    rng = np.random.RandomState(seed)
    dp = dict(ds_translation=rng.randn(n, 2).astype(np.float32),
              ds_scale=rng.randn(n, 1).astype(np.float32) * 0.1)
    if z0:
        dp["ds_z0"] = rng.rand(n, 1).astype(np.float32) + 1.0
    return dp


def test_import_recon_matches_flax(tmp_path):
    sd = _recon_state_dict(2)
    dp = _dataset_params(N, 3)
    torch.save(dict(generator=_tensors(sd), dataset_params=_tensors(dp),
                    optimizer=None, epoch=3, iteration=60,
                    args=dict(texture_resolution=64, mesh_resolution=32,
                              symmetric=True, dataset="cub")),
               tmp_path / "ref.pth")
    assert import_torch.main([
        "--checkpoint", str(tmp_path / "ref.pth"), "--name", "imp",
        "--out_root", str(tmp_path), "--device", "cpu"]) == 0
    trainer = ReconTrainer(
        ReconConfig(texture_resolution=64, optimize_z0=True, batch_size=2,
                    seed=1), dataset_size=N,
        template=MeshTemplate(segments=8, rings=4), device="cpu")
    trainer.restore(str(tmp_path / "imp"))
    assert trainer.epoch == 3 and trainer.total_it == 60
    for k, v in dp.items():
        assert torch.equal(trainer.dp_model.state_dict()[k],
                           torch.from_numpy(v)), k
    assert not trainer.opt.state_dict()["state"]

    x = np.random.RandomState(4).uniform(-1, 1, (2, 256, 256, 4)).astype(
        np.float32)
    net = JNet(symmetric=True, texture_res=64)
    ref = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        convert_reconstruction(sd), jnp.asarray(x))
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert float(np.abs(np.asarray(ref[1])).max()) > 1e-3


def test_import_recon_without_dataset_params(tmp_path):
    """No ``dataset_params``: the import turns ``optimize_deltas`` off, so
    a run at any dataset size restores it; ``--dataset p3d`` takes the
    31-ring template."""
    sd = _recon_state_dict(5)
    chk = dict(generator=_tensors(sd), epoch=1, iteration=10,
               args=dict(texture_resolution=64, dataset="cub"))
    torch.save(chk, tmp_path / "ref.pth")
    assert import_torch.main([
        "--checkpoint", str(tmp_path / "ref.pth"), "--name", "imp",
        "--out_root", str(tmp_path), "--device", "cpu"]) == 0
    trainer = ReconTrainer(
        ReconConfig(texture_resolution=64, optimize_deltas=False,
                    batch_size=2), dataset_size=20,
        template=MeshTemplate(segments=8, rings=4), device="cpu")
    trainer.restore(str(tmp_path / "imp"))
    assert trainer.epoch == 1 and trainer.total_it == 10
    assert trainer.dp_model is None
    for k, v in sd.items():
        assert torch.equal(trainer.model.state_dict()[k],
                           torch.from_numpy(v)), k
    p3d = import_torch.make_recon_trainer(chk, "p", str(tmp_path), "p3d",
                                          "cpu")
    assert (p3d.template.segments, p3d.template.rings) == (32, 31)
    assert not p3d.cfg.optimize_deltas and not p3d.cfg.optimize_z0


def test_import_refusals(tmp_path):
    """A config that disagrees with the weights raises ``ValueError`` naming
    the entry; a trainer built for another model raises at ``restore``,
    naming the entries."""
    _gan_pth(tmp_path / "ref.pth", latent_dim=32)
    with pytest.raises(ValueError,
                       match="shape mismatch at generator/emb_class.weight"):
        import_torch.main(["--checkpoint", str(tmp_path / "ref.pth"),
                           "--weights", "bad", "--out_root", str(tmp_path),
                           "--device", "cpu"])
    _gan_pth(tmp_path / "ref.pth")
    assert import_torch.main([
        "--checkpoint", str(tmp_path / "ref.pth"), "--weights", "imp",
        "--out_root", str(tmp_path), "--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="emb_class.weight"):
        _gan_trainer(0).restore(str(tmp_path / "imp"))


def test_imported_checkpoints_run_through_the_clis(tmp_path, monkeypatch,
                                                   capsys):
    """The commands a reference user runs on pretrained weights, from the
    imported checkpoints: the GAN CLI's ``--save_results`` (without
    ``--conditional_class`` it refuses the class-conditioned weights) and
    the recon CLI's ``--evaluate``, whose means equal the imported
    network's own."""
    make_synthetic_cub_cache(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    _gan_pth(tmp_path / "gan.pth", (200,))
    assert import_torch.main(["--checkpoint", "gan.pth", "--weights", "pre",
                              "--device", "cpu"]) == 0
    flags = ["--weights", "pre", "--dataset", "cub", "--texture_resolution",
             str(RES), "--batch_size", "2", "--device", "cpu",
             "--num_workers", "1", "--save_results"]
    with pytest.raises(RuntimeError, match="emb_class.weight"):
        gan_cli.main(flags)
    assert gan_cli.main([*flags, "--conditional_class"]) == 0
    assert sorted(os.listdir(tmp_path / "results" / "pre")) == sorted(
        f"mesh_{i}.{e}" for i in range(2) for e in ("obj", "mtl", "png"))
    assert (tmp_path / "results" / "pre.png").exists()

    res, n = 64, 3
    sd = _recon_state_dict(6)
    sd["fc1e.weight"] = np.random.RandomState(7).randn(
        256, 64 * 2 * 2).astype(np.float32) / 16.0  # 64² photos: a 2² map
    torch.save(dict(generator=_tensors(sd),
                    dataset_params=_tensors(_dataset_params(n, 8, z0=False)),
                    epoch=2, iteration=9,
                    args=dict(image_resolution=res, texture_resolution=64,
                              dataset="cub")), tmp_path / "recon.pth")
    assert import_torch.main(["--checkpoint", "recon.pth", "--name", "pre",
                              "--device", "cpu"]) == 0
    data = StructuredReconSet(MeshTemplate(segments=32, rings=16), n,
                              photo_res=res, texture_resolution=32, batch=n)
    capsys.readouterr()
    assert recon_cli.main(
        ["--name", "pre", "--dataset", "cub", "--evaluate", "--batch_size",
         "2", "--image_resolution", str(res), "--texture_resolution", "64",
         "--compute_dtype", "float32", "--num_workers", "1", "--device",
         "cpu"], datasets=(data, data)) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    direct = import_torch.make_recon_trainer(
        torch.load("recon.pth", weights_only=False), "x", str(tmp_path),
        "cub", "cpu")
    want = direct.evaluate(batch_iterator(
        data, 2, shuffle=False, drop_last=False, num_workers=1,
        keys=("image", "scale", "translation", "rotation", "idx")))
    assert got == {k: round(v, 5) for k, v in want.items()}
