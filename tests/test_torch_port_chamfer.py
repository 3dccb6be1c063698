"""Chamfer (kernel K3's module) and 3D IoU of the PyTorch port against JAX.

On the CPU ``nn_dist2`` runs the plain ``nn_dist2_torch``: held to a float64
brute force (rtol 1e-5: same formula in float32) and to the JAX
``nn_dist2_xla`` (atol 1e-5: the XLA form x² + y² - 2xy cancels to ~1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.metrics.chamfer import chamfer_distance as j_chamfer
from im23d_tpu.metrics.chamfer import nn_dist2_xla
from im23d_tpu.metrics.iou import iou_3d as j_iou
from im23d_tpu_torch.metrics.chamfer import chamfer_distance, nn_dist2
from im23d_tpu_torch.metrics.iou import iou_3d


def _clouds(seed, b, n, m):
    rng = np.random.RandomState(seed)
    x = ((rng.rand(b, n, 3) - 0.5) * 0.8).astype(np.float32)
    y = ((rng.rand(b, m, 3) - 0.5) * 0.8).astype(np.float32)
    return x, y


def _brute(x, y):
    d = ((x[:, :, None, :].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    return d.min(-1)


# M around the kernel's 256-point tile and the plain version's chunk, and a
# single y point
@pytest.mark.parametrize("n,m", [(100, 37), (300, 256), (129, 513), (64, 1)])
def test_nn_dist2_matches_brute_force_and_xla(n, m):
    x, y = _clouds(0, 2, n, m)
    got = nn_dist2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, _brute(x, y), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got, np.asarray(nn_dist2_xla(jnp.asarray(x), jnp.asarray(y))),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,m", [(200, 120), (512, 300)])
def test_chamfer_distance_matches_jax(n, m):
    x, y = _clouds(2, 3, n, m)
    port = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y))
    ref = j_chamfer(jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)


def test_iou_3d_matches_jax():
    x, y = _clouds(3, 2, 400, 400)
    y[1] = x[1]  # identical pair: IoU 1
    port = iou_3d(torch.from_numpy(x), torch.from_numpy(y), voxel_size=16)
    ref = j_iou(jnp.asarray(x), jnp.asarray(y), voxel_size=16)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-6)
    assert float(port[1]) == 1.0


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("n,m", [(200, 120), (64, 300)])
def test_chamfer_distance_sqrt_flag_matches_jax(n, m, sqrt):
    """``sqrt`` takes sqrt(max(d², 1e-12)) per direction before the means,
    as the JAX function (``im23d_tpu/metrics/chamfer.py:116-124``); one
    pair of identical points checks the floor.  Tolerances as
    ``test_chamfer_distance_matches_jax`` (read ~4e-7 relative with the
    square root)."""
    x, y = _clouds(4, 2, n, m)
    y[0, 0] = x[0, 0]
    port = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y),
                            sqrt=sqrt)
    ref = j_chamfer(jnp.asarray(x), jnp.asarray(y), sqrt=sqrt)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)
