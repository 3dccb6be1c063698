"""Pseudo-ground-truth generation of the PyTorch port against the JAX
reference, on the CPU: the inverse render and the visibility mask, the
InceptionV3 feature extractor (both feature layers) on converted flax
weights, one calibration pass, the FID statistics, and
``generate_pseudogt`` end to end on the loader of ``tests/test_pseudogt.py``
with the converted trainer and Inception.

Same numpy inputs through both.  Tolerances:
  * inverse render: texture and alpha by the 0.999 quantile of |Δ| below
    1e-5 (a pixel on a shared edge may take the other face, as in
    ``tests/test_torch_port_render.py``); visibility: the same texels > 0
    exactly, values (sums of up to ~100 bilinear weights) within rtol 1e-4,
    atol 1e-5 (such an edge pixel samples at the other face's UVs);
  * Inception features: rtol 1e-4, atol 1e-5 of values ~1 (float32 convs
    over up to 2048 channels summed in another order); one calibration
    pass: the running moments within rtol 1e-4, atol 1e-5;
  * FID statistics of the same activations: rtol 1e-6;
  * ``generate_pseudogt``: mesh maps atol 1e-5; the float16 texture and
    alpha by the 0.999 quantile of |Δ| below 2e-3 (a float16 step near 1
    is 1e-3) and at most 0.5 % of the visibility-masked texels differing;
    the stored Inception image equal; poses equal; the FID statistics
    rtol 1e-4, atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.geometry.mesh_template import MeshTemplate as JTemplate
from im23d_tpu.metrics import fid as jfid
from im23d_tpu.metrics import inception as jinc
from im23d_tpu.parallel.mesh import make_mesh
from im23d_tpu.render.inverse import inverse_render as j_inverse_render
from im23d_tpu.render.inverse import visibility_mask as j_visibility
from im23d_tpu.render.renderer import render_mesh as j_render_mesh
from im23d_tpu.train.recon_trainer import ReconConfig as JConfig
from im23d_tpu.train.recon_trainer import ReconTrainer as JTrainer
from im23d_tpu_torch.core.convert import inception_state_dict
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.metrics import fid
from im23d_tpu_torch.metrics.inception import (
    InceptionV3Features,
    calibrate_pass,
)
from im23d_tpu_torch.render.inverse import inverse_render, visibility_mask
from im23d_tpu_torch.render.renderer import render_mesh
from im23d_tpu_torch.train.recon_trainer import ReconConfig, ReconTrainer


@pytest.fixture(scope="module")
def jax_inception():
    """The JAX package's calibrated random Inception (20 passes)."""
    return jinc.init_inception()


def _port_inception(variables, feature_layer="Mixed_5d"):
    model = InceptionV3Features(feature_layer=feature_layer)
    model.load_state_dict(inception_state_dict(
        jax.tree.map(np.asarray, variables)))
    return model


def _close_q999(got, ref, limit):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(ref, np.float32))
    assert np.quantile(d, 0.999) < limit, np.quantile(d, 0.999)


def test_inverse_render_and_visibility_match_jax():
    jt, tt = JTemplate(segments=16, rings=8), MeshTemplate(segments=16,
                                                           rings=8)
    rng = np.random.RandomState(0)
    dmap = (rng.randn(2, 16, 16, 3) * 0.05).astype(np.float32)
    photo = rng.rand(2, 128, 128, 3).astype(np.float32)
    tex = rng.rand(2, 16, 16, 3).astype(np.float32)
    j_vtx = jt.get_vertex_positions(jnp.asarray(dmap)) * 0.8
    t_vtx = tt.get_vertex_positions(torch.from_numpy(dmap)) * 0.8

    ref = j_inverse_render(jt, j_vtx, jnp.asarray(photo), 64)
    got = inverse_render(tt, t_vtx, torch.from_numpy(photo), 64)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close_q999(g.numpy(), r, 1e-5)
    assert float(np.asarray(ref[1]).mean()) > 0.5

    def j_render(v, t):
        uvs, ta = jt.adjust_uv_and_texture(t)
        return j_render_mesh(v, jt.faces_j, uvs, jt.face_uvs_j, ta, 96, 96)[0]

    def t_render(v, t):
        uvs, ta = tt.adjust_uv_and_texture(t)
        return render_mesh(v, tt.tensor("faces", "cpu"), uvs,
                           tt.tensor("face_uvs", "cpu"), ta, 96, 96)[0]

    ref = np.asarray(j_visibility(jt, j_render, j_vtx, jnp.asarray(tex)))
    got = visibility_mask(t_render, t_vtx, torch.from_numpy(tex)).numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert 0 < (ref > 0).mean() < 1


@pytest.mark.parametrize("feature_layer", ["Mixed_5d", "pool3"])
def test_inception_features_match_flax(feature_layer, jax_inception):
    rng = np.random.RandomState(1)
    x = rng.rand(2, 150, 170, 3).astype(np.float32)  # resized to 299
    if feature_layer == "Mixed_5d":
        model, variables = jax_inception
    else:  # random init: checks the architecture, not calibrated values
        model = jinc.InceptionV3Features(feature_layer="pool3")
        variables = jax.jit(model.init)(jax.random.PRNGKey(2),
                                        jnp.zeros((1, 299, 299, 3)))
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_inception(variables, feature_layer)(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 288 if feature_layer == "Mixed_5d"
                                      else 2048)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    assert np.abs(ref).max() > 1e-3


def test_one_calibration_pass_matches_flax():
    """The moments of every conv output become its sibling batch norm's
    running statistics, sanitised: flax ``capture_intermediates`` against
    the port's forward hooks, from the same uncalibrated weights."""
    model = jinc.InceptionV3Features(feature_layer="Mixed_5d")
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    jnp.zeros((1, 299, 299, 3)))
    probe = np.random.RandomState(4).rand(2, 299, 299, 3).astype(np.float32)
    _, state = model.apply(variables, jnp.asarray(probe),
                           capture_intermediates=True,
                           mutable=["intermediates"])

    def walk(stats, inter):
        out = {}
        for key, val in stats.items():
            if key == "bn":
                o = inter["conv"]["__call__"][0]
                m, v = jnp.mean(o, axis=(0, 1, 2)), jnp.var(o, axis=(0, 1, 2))
                m = jnp.where(jnp.isfinite(m), jnp.clip(m, -1e4, 1e4), 0.0)
                v = jnp.where(jnp.isfinite(v), jnp.clip(v, 1e-4, 1e8), 1.0)
                out[key] = {"mean": m, "var": v}
            else:
                out[key] = walk(val, inter[key])
        return out

    ref = inception_state_dict(jax.tree.map(np.asarray, {
        "params": variables["params"],
        "batch_stats": walk(variables["batch_stats"],
                            state["intermediates"])}))
    port = _port_inception(variables)
    calibrate_pass(port, torch.from_numpy(probe))
    got = port.state_dict()
    n = 0
    for k, v in ref.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            n += 1
    assert n == 2 * sum(1 for k in ref if k.endswith("bn.weight")) > 50


def test_calculate_stats_and_frechet_distance_match():
    rng = np.random.RandomState(5)
    a, b = rng.randn(40, 12), rng.randn(30, 12) + 0.3
    for g, r in zip(fid.calculate_stats(a), jfid.calculate_stats(a)):
        np.testing.assert_allclose(g, r, rtol=1e-6)
    np.testing.assert_allclose(
        fid.frechet_distance(*fid.calculate_stats(a),
                             *fid.calculate_stats(b)),
        jfid.fid_from_activations(a, b), rtol=1e-6)


def _loader(seed):
    """The loader of ``tests/test_pseudogt.py``: 4 images in batches of 2."""
    rng = np.random.RandomState(seed)
    for start in range(0, 4, 2):
        rot = rng.randn(2, 4).astype(np.float32)
        rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
        yield dict(
            image=rng.rand(2, 64, 64, 4).astype(np.float32),
            hd_image=rng.rand(2, 128, 128, 3).astype(np.float32),
            inception_image=rng.rand(2, 75, 75, 3).astype(np.float32) * 2 - 1,
            scale=np.full((2,), 0.7, np.float32),
            translation=np.zeros((2, 3), np.float32),
            rotation=rot,
            idx=np.arange(start, start + 2, dtype=np.int32),
        )


def test_generate_pseudogt_matches_jax(tmp_path, jax_inception, monkeypatch):
    """Both writers on the same loader; the visibility render at 256²
    (``renderer_resolution``; the CLI's 1024² is too slow for the plain
    rasterizer on the CPU) so the 64² texture is down-resized to 32²."""
    jt = JTrainer(JConfig(image_resolution=64, texture_resolution=64,
                          batch_size=2), dataset_size=4,
                  template=JTemplate(segments=8, rings=4),
                  mesh=make_mesh(jax.devices()[:1]))
    params = jax.tree.map(np.asarray, jt.params)
    params["conv_mesh"]["kernel"] = np.random.RandomState(6).randn(
        *params["conv_mesh"]["kernel"].shape).astype(np.float32) * 0.01
    jt.params = jax.tree.map(jnp.asarray, params)
    pt = ReconTrainer(ReconConfig(image_resolution=64, texture_resolution=64,
                                  batch_size=2), dataset_size=4,
                      template=MeshTemplate(segments=8, rings=4),
                      device="cpu")
    pt.load_params({"params": params,
                    "batch_stats": jax.tree.map(np.asarray, jt.batch_stats)},
                   jax.tree.map(np.asarray, jt.dp_params))
    monkeypatch.setattr(jinc, "init_inception", lambda: jax_inception)
    paths = [f"img_{i}.jpg" for i in range(4)]
    dirs = {}
    for name, trainer, extra in (
            ("jax", jt, {}),
            ("port", pt, {"inception": _port_inception(jax_inception[1])})):
        d = str(tmp_path / name)
        os.makedirs(d)
        trainer.generate_pseudogt(_loader(7), d, "cub",
                                  pseudogt_resolution=32,
                                  inception_resolution=75, paths=paths,
                                  val_loader=_loader(8),
                                  renderer_resolution=256, **extra)
        dirs[name] = d

    def npz(name, rel):
        return np.load(os.path.join(dirs[name], rel), allow_pickle=True)

    assert sorted(os.listdir(os.path.join(dirs["port"], "pseudogt_32x32"))) \
        == sorted(os.listdir(os.path.join(dirs["jax"], "pseudogt_32x32"))) \
        == ["0.npz", "1.npz", "2.npz", "3.npz"]
    covered = 0.0
    for i in range(4):
        g = npz("port", f"pseudogt_32x32/{i}.npz")["data"].item()
        r = npz("jax", f"pseudogt_32x32/{i}.npz")["data"].item()
        assert set(g) == set(r)
        for k in r:
            assert g[k].shape == r[k].shape and g[k].dtype == r[k].dtype, k
        np.testing.assert_allclose(g["mesh"], r["mesh"], atol=1e-5)
        np.testing.assert_array_equal(g["image"], r["image"])
        for k in ("texture", "texture_alpha"):
            _close_q999(g[k], r[k], 2e-3)
        assert ((g["texture_alpha"] > 0) != (r["texture_alpha"] > 0)).mean() \
            <= 5e-3
        covered += float((r["texture_alpha"] > 0).mean()) / 4
    assert 0 < covered < 1
    g = npz("port", "poses_metadata.npz")["data"].item()
    r = npz("jax", "poses_metadata.npz")["data"].item()
    assert g["path"] == r["path"] == paths
    for k in ("scale", "translation", "rotation"):
        np.testing.assert_array_equal(g[k], r[k])
    for split in ("train", "testval"):
        g = npz("port", f"precomputed_fid_75x75_{split}.npz")
        r = npz("jax", f"precomputed_fid_75x75_{split}.npz")
        assert g["stats_s"].dtype == r["stats_s"].dtype == np.float32
        for k in ("stats_m", "stats_s"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        for k in ("num_images", "resolution"):
            assert int(g[k]) == int(r[k])
