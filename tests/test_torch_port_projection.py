"""Projection (kernel K1's module) of the PyTorch port against the JAX chain.

On the CPU ``projection_silhouette`` runs its plain chain; it is held to the
JAX XLA chain and to the Pallas kernel ``projection_silhouette_pallas``
(interpret mode, ``dot_bf16=False``) at B=2, N=160, S=16, kernel_size=9, with
dropout weights, to atol 1e-5 (the tolerance the JAX tests hold the Pallas
kernel to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.ops.splat_pallas import (
    _prep_projection as j_prep,
    projection_silhouette_pallas,
)
from im23d_tpu.ops.voxel import (
    gaussian_blur_3d,
    project_silhouette,
    termination_probs,
    trilinear_splat,
)
from im23d_tpu_torch.ops.projection import (
    _prep_projection,
    projection_silhouette,
    projection_silhouette_torch,
)

B, N, S, KS = 2, 160, 16, 9
ATOL = 1e-5


def _inputs(seed=7):
    rng = np.random.RandomState(seed)
    pts = ((rng.rand(B, N, 3) - 0.5) * 1.1).astype(np.float32)  # some culled
    w = (rng.rand(B, N) > 0.3).astype(np.float32)
    scale = (0.5 + rng.rand(B) * 1.5).astype(np.float32)
    return pts, w, scale


def _jax_chain(pts, w, scale, sigma):
    v = gaussian_blur_3d(trilinear_splat(jnp.asarray(pts), S,
                                         weights=jnp.asarray(w)),
                         jnp.float32(sigma), kernel_size=KS,
                         scale=jnp.asarray(scale))
    return np.asarray(project_silhouette(termination_probs(v)))


def _port(points, w, scale, sigma):
    return projection_silhouette(points, S, torch.tensor(sigma),
                                 torch.from_numpy(scale),
                                 weights=torch.from_numpy(w),
                                 kernel_size=KS).numpy()


@pytest.mark.parametrize("sigma", [0.8, 3.0])
def test_plain_chain_matches_jax_xla_chain(sigma):
    pts, w, scale = _inputs()
    ref = _jax_chain(pts, w, scale, sigma)
    np.testing.assert_allclose(_port(torch.from_numpy(pts), w, scale, sigma),
                               ref, atol=ATOL, rtol=0)
    # planar (z, y, x) input, as the loss passes it
    planes = tuple(torch.from_numpy(pts[..., i].copy()) for i in range(3))
    np.testing.assert_allclose(_port(planes, w, scale, sigma), ref,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("sorted_blocks", [False, True])
def test_plain_chain_matches_pallas_kernel(sorted_blocks):
    pts, w, scale = _inputs()
    ref = np.asarray(projection_silhouette_pallas(
        jnp.asarray(pts), S, jnp.float32(0.8), jnp.asarray(scale),
        weights=jnp.asarray(w), kernel_size=KS, dot_bf16=False,
        sorted_blocks=sorted_blocks))
    np.testing.assert_allclose(_port(torch.from_numpy(pts), w, scale, 0.8),
                               ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("sigma", [0.8, 3.0])
def test_mixed_sign_weights_match_pallas_kernel(sigma):
    """Weights of either sign: both versions pin a point with c <= 0 to
    grid coordinate 0 (the corner voxel, empty here), where the port adds
    its signed weight and clamps the grid to [0, 1] and the sorted Pallas
    kernel sorts it past every block window; with no positive weight at
    that voxel both give the same silhouettes."""
    pts, _, scale = _inputs(11)
    w = np.random.RandomState(12).uniform(-1.0, 1.0, (B, N)).astype(
        np.float32)
    ref = np.asarray(projection_silhouette_pallas(
        jnp.asarray(pts), S, jnp.float32(sigma), jnp.asarray(scale),
        weights=jnp.asarray(w), kernel_size=KS, dot_bf16=False))
    got = projection_silhouette_torch(
        torch.from_numpy(pts), S, torch.tensor(sigma), torch.from_numpy(scale),
        weights=torch.from_numpy(w), kernel_size=KS).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_prep_pins_mixed_sign_weights_as_jax():
    """The cull, the signed weights c and the coordinates of points with
    c <= 0 pinned to 0, as the JAX prep pins them."""
    pts, _, _ = _inputs(4)
    w = np.random.RandomState(5).uniform(-1.0, 1.0, (B, N)).astype(
        np.float32)
    port = _prep_projection(torch.from_numpy(pts), S, torch.from_numpy(w),
                            1e-6)
    ref = j_prep(jnp.asarray(pts), S, jnp.asarray(w), 1e-6)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :N], atol=ATOL,
                                   rtol=0)
    c = port[3]
    assert bool((c < 0).any()) and bool((port[0][c < 0] == 0).all())


def test_prep_matches_jax():
    """Cull, weights, grid coords, zeroed coords of culled points (the JAX
    prep additionally lane-pads N; the port does not)."""
    pts, w, _ = _inputs(3)
    port = _prep_projection(torch.from_numpy(pts), S, torch.from_numpy(w),
                            1e-6)
    ref = j_prep(jnp.asarray(pts), S, jnp.asarray(w), 1e-6)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b)[:, :N], atol=ATOL,
                                   rtol=0)
    assert (port[3] == 0).any() and (port[3] == 1).any()


def test_no_points_gives_background_silhouette():
    """A cloud with every point culled projects to the eps-only ray sum."""
    pts = np.full((1, 8, 3), 0.7, np.float32)
    got = _port(torch.from_numpy(pts), np.ones((1, 8), np.float32),
                np.ones(1, np.float32), 1.0)
    ref = _jax_chain(pts, np.ones((1, 8), np.float32), np.ones(1, np.float32),
                     1.0)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
