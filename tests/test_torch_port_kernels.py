"""CUDA kernels K1 and K3 of the PyTorch port against their plain versions.

Needs a CUDA device: every test here is marked ``cuda`` and skips without
one.  Imports no JAX, so it runs where JAX is not installed; the repository's
``tests/conftest.py`` imports JAX, hence the command on a GPU machine, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tolerances: K1 sums with atomicAdd (order changes between runs) and blurs in
another order than the plain band matmul, atol 1e-5 on silhouettes <= ~1;
K3 computes the plain formula, up to FMA contraction, rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from im23d_tpu_torch.metrics.chamfer import (
    nn_dist2,
    nn_dist2_kernel,
    nn_dist2_torch,
)
from im23d_tpu_torch.ops.projection import (
    projection_kernel,
    projection_silhouette,
    projection_silhouette_torch,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _points(seed, b, n, spread=1.1, dev="cpu"):
    rng = np.random.RandomState(seed)
    pts = ((rng.rand(b, n, 3) - 0.5) * spread).astype(np.float32)
    w = (rng.rand(b, n) > 0.3).astype(np.float32)
    scale = (0.2 + 1.3 * rng.rand(b)).astype(np.float32)
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(w).to(dev),
            torch.from_numpy(scale).to(dev))


@pytest.mark.parametrize("S,ks,sigma", [(16, 9, 0.8), (32, 21, 3.0),
                                        (64, 21, 0.2), (20, 7, 1.3)])
def test_k1_matches_plain(dev, S, ks, sigma):
    pts, w, scale = _points(0, 3, 1000, dev=dev)
    sig = torch.tensor(sigma, device=dev)
    n0 = projection_kernel.launches
    got = projection_silhouette(pts, S, sig, scale, weights=w, kernel_size=ks)
    ref = projection_silhouette_torch(pts, S, sig, scale, weights=w,
                                      kernel_size=ks)
    torch.cuda.synchronize()
    assert projection_kernel.launches == n0 + 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_k1_dropped_and_culled_clouds(dev):
    pts, w, scale = _points(1, 2, 500, dev=dev)
    w[0] = 0.0          # every point dropped
    pts[1, :, 0] = 0.6  # every point culled
    sig = torch.tensor(1.0, device=dev)
    got = projection_silhouette(pts, 32, sig, scale, weights=w)
    ref = projection_silhouette_torch(pts, 32, sig, scale, weights=w)
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_k1_rejects_bad_operands(dev):
    pts, w, scale = _points(2, 2, 64, dev=dev)
    planes = [pts[..., i].contiguous() for i in range(3)]
    taps = torch.ones(5, device=dev) / 5
    with pytest.raises(TypeError):
        projection_kernel(*[p.double() for p in planes], w, taps, scale, 16)
    with pytest.raises(ValueError):
        projection_kernel(*planes, w, taps, scale, 65)
    with pytest.raises(ValueError):
        projection_kernel(pts[..., 0], *planes[1:], w, taps, scale, 16)
    with pytest.raises(RuntimeError, match="forward-only"):
        projection_silhouette(pts.requires_grad_(), 16,
                              torch.tensor(1.0, device=dev), scale)


@pytest.mark.parametrize("n,m", [(1, 1), (255, 257), (1000, 256),
                                 (8000, 2048)])
def test_k3_matches_plain(dev, n, m):
    x = _points(3, 2, n, 0.8, dev)[0]
    y = _points(4, 2, m, 0.8, dev)[0]
    n0 = nn_dist2_kernel.launches
    got = nn_dist2(x, y)
    torch.cuda.synchronize()
    assert nn_dist2_kernel.launches == n0 + 1
    torch.testing.assert_close(got, nn_dist2_torch(x, y), rtol=1e-5,
                               atol=1e-7)
