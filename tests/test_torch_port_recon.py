"""Pipeline-B inference of the PyTorch port against the JAX reference, on
the CPU: the reconstruction network and its converters, ``DatasetParams``,
``transform_vertices``, ``flatness_loss``, ``mean_iou``, the fabricated
data, and ``ReconTrainer``'s eval step, evaluation (with a tail batch) and
multi-view render at 64² images, a 64² texture, ``MeshTemplate(16, 8)`` and
batch 2.

Tolerances: network outputs atol 1e-4 (float32 convs summed in another
order over up to 4608 terms); the trainer's losses rtol 1e-4; renders and
poses 1e-5 (renders by the 0.999 quantile, as in
``tests/test_torch_port_render.py``); converters and fabricated maps
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.core.torch_convert import convert_reconstruction
from im23d_tpu.data.fabricate import StructuredPseudoGT as JFab
from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.losses.gan_losses import flatness_loss as j_flat
from im23d_tpu.metrics.iou import mean_iou as j_miou
from im23d_tpu.models.reconstruction import DatasetParams as JDP
from im23d_tpu.models.reconstruction import ReconstructionNetwork as JNet
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.train.recon_trainer import ReconConfig as JConfig
from im23d_tpu.train.recon_trainer import ReconTrainer as JTrainer
from im23d_tpu.train.recon_trainer import transform_vertices as j_transform
from im23d_tpu_torch.core.convert import (
    dataset_params_state_dict,
    reconstruction_state_dict,
)
from im23d_tpu_torch.data.cmr import batch_iterator
from im23d_tpu_torch.data.fabricate import StructuredPseudoGT, StructuredReconSet
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.losses.gan_losses import flatness_loss
from im23d_tpu_torch.metrics.iou import mean_iou
from im23d_tpu_torch.models.reconstruction import (
    DatasetParams,
    ReconstructionNetwork,
)
from im23d_tpu_torch.train.recon_trainer import (
    ReconConfig,
    ReconTrainer,
    transform_vertices,
)
from test_torch_convert import make_recon_state_dict

RES, TEX, BS, DS = 64, 64, 2, 10
RTOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_reference_state_dict_loads_and_matches_flax():
    """A reference-shaped state dict loads strictly and gives the outputs of
    flax applied to ``convert_reconstruction`` of it (eval mode)."""
    sd = make_recon_state_dict(np.random.RandomState(0))
    sd["conv_mesh.weight"] = np.random.RandomState(1).randn(
        3, 64, 5, 5).astype(np.float32) * 0.05
    # unit gain per layer (std 1 / sqrt(fan_in)), so activations stay O(1)
    # and the tolerance reads the network, not float32 sums of values ~1e3
    for k, v in sd.items():
        if v.ndim >= 2:
            sd[k] = (v / (0.05 * np.sqrt(v[0].size))).astype(np.float32)
    net = ReconstructionNetwork(symmetric=True, texture_res=64).eval()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    x = np.random.RandomState(2).uniform(-1, 1, (2, 256, 256, 4)).astype(
        np.float32)
    ref = JNet(symmetric=True, texture_res=64).apply(
        convert_reconstruction(sd), jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert float(np.abs(np.asarray(ref[1])).max()) > 1e-3


@pytest.mark.parametrize("texture_res,symmetric", [(64, True), (128, True),
                                                   (64, False)])
def test_reconstruction_state_dict_inverts_convert(texture_res, symmetric):
    """flax init -> port state dict -> ``convert_reconstruction`` gives the
    flax variables back, and the port network loads it strictly (at 256²
    images, the only size ``convert_reconstruction`` takes)."""
    net = JNet(symmetric=symmetric, texture_res=texture_res)
    variables = _np_tree(jax.jit(lambda r, x: net.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 4))))
    sd = reconstruction_state_dict(variables)
    back = convert_reconstruction({k: v.numpy() for k, v in sd.items()})
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    ReconstructionNetwork(symmetric=symmetric,
                          texture_res=texture_res).load_state_dict(sd,
                                                                   strict=True)


@pytest.mark.parametrize("with_idx", [True, False])
def test_dataset_params_match_jax(with_idx):
    rng = np.random.RandomState(3)
    N = 6
    params = dict(ds_translation=rng.randn(N, 2).astype(np.float32),
                  ds_scale=rng.randn(N, 1).astype(np.float32),
                  ds_z0=rng.randn(N, 1).astype(np.float32))
    idx = np.array([0, 5, 7, 11], np.int32) if with_idx else None
    jdp = JDP(N, True, True)
    tdp = DatasetParams(N, True, True)
    tdp.load_state_dict(dataset_params_state_dict({"params": params}))
    ti = torch.from_numpy(idx) if with_idx else None
    ji = jnp.asarray(idx) if with_idx else None
    for mode in ("deltas", "z0"):
        ref = jdp.apply({"params": params}, ji, mode)
        with torch.no_grad():
            got = tdp(ti, mode)
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_transform_vertices_matches_jax():
    rng = np.random.RandomState(4)
    B, V = 3, 20
    args = [rng.randn(B, V, 3) * 0.2, rng.rand(B) + 0.5, rng.randn(B, 3) * 0.1,
            rng.randn(B, 4), rng.randn(B, 3) * 0.01, rng.randn(B) * 0.01,
            1.0 + np.exp(rng.randn(B, 1))]
    args = [a.astype(np.float32) for a in args]
    for z0 in (None, args[6]):
        ref = j_transform(*map(jnp.asarray, args[:6]),
                          None if z0 is None else jnp.asarray(z0))
        got = transform_vertices(*map(torch.from_numpy, args[:6]),
                                 None if z0 is None else torch.from_numpy(z0))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("per_sample", [False, True])
def test_flatness_loss_and_mean_iou_match_jax(per_sample):
    rng = np.random.RandomState(5)
    tpl = MeshTemplate(segments=16, rings=8)
    n = rng.randn(2, tpl.mesh.faces.shape[0], 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        flatness_loss(torch.from_numpy(n), torch.from_numpy(tpl.ff).long(),
                      per_sample).numpy(),
        np.asarray(j_flat(jnp.asarray(n), jnp.asarray(tpl.ff), per_sample)),
        rtol=1e-5)
    a, b = rng.rand(2, 2, 16, 16).astype(np.float32)
    np.testing.assert_allclose(
        mean_iou(torch.from_numpy(a), torch.from_numpy(b), per_sample).numpy(),
        np.asarray(j_miou(jnp.asarray(a), jnp.asarray(b), per_sample)),
        rtol=1e-6)


@pytest.mark.parametrize("idx", [0, 5, 13])
def test_fabricated_maps_equal_jax(idx):
    a = StructuredPseudoGT(20, 32, n_classes=4, seed=7)
    b = JFab(20, 32, n_classes=4, seed=7)
    for k, v in b.maps(idx).items():
        np.testing.assert_array_equal(a.maps(idx)[k], v)
    for k, v in b.poses().items():
        np.testing.assert_array_equal(a.poses()[k], v)


def test_structured_recon_set_item_contract():
    tpl = MeshTemplate(segments=16, rings=8)
    ds = StructuredReconSet(tpl, 3, photo_res=32, texture_resolution=16,
                            batch=2)
    assert len(ds) == 3
    item = ds[2]
    assert item["image"].shape == (32, 32, 4)
    rgb, mask = item["image"][..., :3], item["image"][..., 3:]
    assert set(np.unique(mask)) <= {0.0, 1.0} and 0 < mask.mean() < 1
    assert np.abs(rgb).max() <= 1.0 and not rgb[mask[..., 0] == 0].any()
    assert item["idx"] == 2 and item["translation"][2] == 0.0
    np.testing.assert_allclose(np.linalg.norm(item["rotation"]), 1.0,
                               rtol=1e-6)
    batches = list(batch_iterator(ds, 2, shuffle=False, drop_last=False,
                                  num_workers=1))
    assert [len(b["image"]) for b in batches] == [2, 1]


@pytest.fixture(scope="module")
def trainers():
    """The JAX trainer with perturbed parameters, and the port's trainer
    with the same parameters loaded."""
    jt = JTrainer(JConfig(image_resolution=RES, texture_resolution=TEX,
                          batch_size=BS), dataset_size=DS,
                  template=JTemplate(segments=16, rings=8),
                  mesh=make_mesh(jax.devices()[:1]))
    rng = np.random.RandomState(6)
    params = _np_tree(jt.params)
    params["conv_mesh"]["kernel"] = rng.randn(
        *params["conv_mesh"]["kernel"].shape).astype(np.float32) * 0.02
    stats = jax.tree.map(
        lambda s: (s + 0.1 * np.abs(rng.randn(*s.shape))).astype(np.float32),
        _np_tree(jt.batch_stats))
    dp = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.05).astype(np.float32),
        _np_tree(jt.dp_params))
    jt.params, jt.batch_stats, jt.dp_params = (
        jax.tree.map(jnp.asarray, t) for t in (params, stats, dp))
    pt = ReconTrainer(ReconConfig(image_resolution=RES,
                                  texture_resolution=TEX, batch_size=BS),
                      dataset_size=DS,
                      template=MeshTemplate(segments=16, rings=8),
                      device="cpu")
    pt.load_params({"params": params, "batch_stats": stats}, dp)
    return jt, pt


def _batch(n, seed):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (n, RES, RES, 4)).astype(np.float32)
    img[..., 3] = (rng.rand(n, RES, RES) > 0.5).astype(np.float32)
    rot = rng.randn(n, 4).astype(np.float32)
    return dict(image=img,
                scale=(0.6 + 0.2 * rng.rand(n)).astype(np.float32),
                translation=(rng.randn(n, 3) * 0.05).astype(np.float32),
                rotation=rot / np.linalg.norm(rot, axis=-1, keepdims=True),
                idx=rng.randint(0, 2 * DS, size=(n,)).astype(np.int32))


def test_eval_step_matches_jax_trainer(trainers):
    jt, pt = trainers
    batch = _batch(BS, 7)
    w = np.array([1.0, 0.5], np.float32)
    ref, ref_x = jt.eval_step(batch, w)
    got, got_x = pt.eval_step(batch, w)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL,
                                   err_msg=k)
    d = np.abs(got_x.numpy() - np.asarray(ref_x))
    assert np.quantile(d, 0.999) < 1e-5
    assert float(ref["flat_loss"]) > 0 and float(ref["iou"]) > 0


def test_evaluate_pads_the_tail_like_jax(trainers):
    jt, pt = trainers
    full = _batch(3, 8)
    batches = [{k: v[:2] for k, v in full.items()},
               {k: v[2:] for k, v in full.items()}]
    ref = jt.evaluate(batches)
    got = pt.evaluate(batches)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, err_msg=k)


def test_predict_and_render_multiview_match_jax(trainers):
    jt, pt = trainers
    img = _batch(BS, 9)["image"]
    ref_tex, ref_mesh = jt.predict(img)
    got_tex, got_mesh = pt.predict(img)
    np.testing.assert_allclose(got_tex.numpy(), np.asarray(ref_tex),
                               atol=1e-4)
    np.testing.assert_allclose(got_mesh.numpy(), np.asarray(ref_mesh),
                               atol=1e-5)
    ref = jt.render_multiview(jt.template.get_vertex_positions(ref_mesh),
                              ref_tex, idx=1)
    got = pt.render_multiview(pt.template.get_vertex_positions(got_mesh),
                              got_tex, idx=1)
    assert got.shape == ref.shape == (2 * RES, 4 * RES, 3)
    assert np.quantile(np.abs(got - ref), 0.999) < 1e-4


def test_save_restore_roundtrip(trainers, tmp_path):
    _, pt = trainers
    pt.epoch, pt.total_it = 3, 17
    pt.save(str(tmp_path))
    pt.save(str(tmp_path), tag="latest")
    other = ReconTrainer(ReconConfig(image_resolution=RES,
                                     texture_resolution=TEX, batch_size=BS,
                                     seed=1),
                         dataset_size=DS,
                      template=MeshTemplate(segments=16, rings=8),
                         device="cpu")
    other.restore(str(tmp_path), step=17)
    assert (other.epoch, other.total_it) == (3, 17)
    torch.testing.assert_close(other.model.state_dict(),
                               pt.model.state_dict())
    torch.testing.assert_close(other.dp_model.state_dict(),
                               pt.dp_model.state_dict())
    other.restore(str(tmp_path), step="latest")
    with pytest.raises(FileNotFoundError):
        other.restore(str(tmp_path), step=5)
