"""Pipeline-A networks of the PyTorch port against the flax models.

JAX params are converted by ``im23d_tpu_torch.core.convert``; 64² images make
the encoder end at 2×2, so a wrong flatten order would show.  float32 on the
CPU, rtol and atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.models.pointcloud_nets import UnsupervisedPart as JPart
from im23d_tpu_torch.core.convert import unsupervised_part_state_dict
from im23d_tpu_torch.models.pointcloud_nets import (
    UnsupervisedPart,
    kaiming_init_,
)

H, NPTS, K, V = 64, 96, 3, 2
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    imgs = rng.rand(2, H, H, 3).astype(np.float32)
    pose = rng.rand(2 * V, H, H, 3).astype(np.float32)
    jmodel = JPart(num_points=NPTS, num_candidates=K, num_views=V)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(imgs),
                         jnp.asarray(pose))
    ref = jax.tree.map(np.asarray,
                       jmodel.apply(params, jnp.asarray(imgs),
                                    jnp.asarray(pose)))
    port = UnsupervisedPart(image_size=H, num_points=NPTS, num_candidates=K)
    port.load_state_dict(unsupervised_part_state_dict(
        jax.tree.map(np.asarray, params), K))
    with torch.no_grad():
        out = port(torch.from_numpy(imgs), torch.from_numpy(pose))
    return ref, out


@pytest.mark.parametrize("key", ["point_cloud", "scale", "ensemble_q",
                                 "student_q"])
def test_forward_matches_flax(models, key):
    ref, out = models
    assert tuple(out[key].shape) == ref[key].shape
    assert out[key].dtype == torch.float32
    np.testing.assert_allclose(out[key].numpy(), ref[key], **TOL)


def test_converter_covers_every_param():
    jmodel = JPart(num_points=NPTS, num_candidates=K, num_views=V)
    x = jnp.zeros((1, H, H, 3))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), x, x))
    sd = unsupervised_part_state_dict(params, K)
    port = UnsupervisedPart(image_size=H, num_points=NPTS, num_candidates=K)
    assert set(sd) == set(port.state_dict())
    n_jax = sum(a.size for a in jax.tree.leaves(params))
    assert n_jax == sum(t.numel() for t in sd.values())


def test_bf16_trunks_keep_float32_heads():
    port = UnsupervisedPart(image_size=H, num_points=NPTS, num_candidates=K,
                            compute_dtype=torch.bfloat16)
    x = torch.rand(2, H, H, 3)
    with torch.no_grad():
        out = port(x, x)
        feat = port.encoder(x)
    assert feat.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in out.values())


def test_kaiming_init_statistics():
    port = UnsupervisedPart(image_size=H, num_points=NPTS, num_candidates=K)
    kaiming_init_(port, torch.Generator().manual_seed(0))
    w = port.encoder.dense[0].weight.detach()  # fan_in = 2*2*16 = 64
    assert abs(float(w.std()) - (2.0 / 64) ** 0.5) < 0.02
    assert all(float(m.bias.abs().max()) == 0.0 for m in port.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)))
    again = UnsupervisedPart(image_size=H, num_points=NPTS, num_candidates=K)
    kaiming_init_(again, torch.Generator().manual_seed(0))
    torch.testing.assert_close(port.state_dict(), again.state_dict())
