"""PyTorch port ops (``im23d_tpu_torch.ops``) against the JAX reference.

Same numpy inputs (``np.random.RandomState``) through both; atol 1e-5 in
float32 on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.ops import camera as jcam
from im23d_tpu.ops import quaternion as jq
from im23d_tpu.ops import sampling as jsamp
from im23d_tpu.ops import voxel as jvox
from im23d_tpu_torch.ops import camera as tcam
from im23d_tpu_torch.ops import pointcloud as tpc
from im23d_tpu_torch.ops import quaternion as tq
from im23d_tpu_torch.ops import sampling as tsamp
from im23d_tpu_torch.ops import voxel as tvox

ATOL = 1e-5


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _quats(rng, *shape):
    return rng.randn(*shape, 4).astype(np.float32)


@pytest.mark.parametrize("name", ["qnormalize", "qconj"])
def test_quaternion_unary(name):
    q = _quats(np.random.RandomState(0), 5, 3)
    _close(getattr(tq, name)(torch.from_numpy(q)),
           getattr(jq, name)(jnp.asarray(q)))


@pytest.mark.parametrize("name", ["qmul", "quaternion_angle_loss"])
def test_quaternion_binary(name):
    rng = np.random.RandomState(1)
    a, b = _quats(rng, 6), _quats(rng, 6)
    _close(getattr(tq, name)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jq, name)(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("inverse", [False, True])
def test_qrot_points(inverse):
    rng = np.random.RandomState(2)
    pts = rng.randn(3, 50, 3).astype(np.float32)
    q = _quats(rng, 3)
    _close(tq.qrot_points(torch.from_numpy(pts), torch.from_numpy(q), inverse),
           jq.qrot_points(jnp.asarray(pts), jnp.asarray(q), inverse))


def test_qrot_broadcasts_candidates():
    """(B, 1, N, 3) clouds under (B, C, 4) poses, the candidate layout."""
    rng = np.random.RandomState(3)
    pts = rng.randn(2, 1, 40, 3).astype(np.float32)
    q = jq.qnormalize(jnp.asarray(_quats(rng, 2, 3)))
    _close(tq.qrot(torch.from_numpy(np.asarray(q)), torch.from_numpy(pts)),
           jq.qrot(q, jnp.asarray(pts)))


def test_world_to_camera():
    rng = np.random.RandomState(4)
    pts = (rng.rand(3, 64, 3).astype(np.float32) - 0.5) * 0.8
    q = _quats(rng, 3)
    for port, ref in zip(
        tcam.world_to_camera_zyx(torch.from_numpy(pts), torch.from_numpy(q)),
        jcam.world_to_camera_zyx(jnp.asarray(pts), jnp.asarray(q)),
    ):
        _close(port, ref)
    _close(tcam.world_to_camera(torch.from_numpy(pts), torch.from_numpy(q)),
           jcam.world_to_camera(jnp.asarray(pts), jnp.asarray(q)))


@pytest.mark.parametrize("p", [0.07, 0.5, 1.0])
def test_keep_mask_counts(p):
    gen = torch.Generator().manual_seed(0)
    m = tpc.keep_mask(gen, 4, 1000, torch.tensor(p))
    assert m.shape == (4, 1000) and m.dtype == torch.float32
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(m.sum(-1).numpy(), np.ceil(1000 * p))


@pytest.mark.parametrize("shape", [(2, 32, 24), (2, 32, 24, 3)])
def test_resize_bilinear(shape):
    img = np.random.RandomState(5).rand(*shape).astype(np.float32)
    _close(tsamp.resize_bilinear(torch.from_numpy(img), 16, 12),
           jsamp.resize_bilinear(jnp.asarray(img), 16, 12))


def test_trilinear_splat_with_weights_and_cull():
    rng = np.random.RandomState(6)
    pts = (rng.rand(2, 300, 3).astype(np.float32) - 0.5) * 1.1
    w = (rng.rand(2, 300) > 0.3).astype(np.float32)
    _close(tvox.trilinear_splat(torch.from_numpy(pts), 16, torch.from_numpy(w)),
           jvox.trilinear_splat(jnp.asarray(pts), 16, jnp.asarray(w)))


@pytest.mark.parametrize("kernel_size", [9, 21])
def test_gaussian_kernel_and_band(kernel_size):
    k_t = tvox.gaussian_kernel_1d(torch.tensor(1.3), kernel_size)
    k_j = jvox.gaussian_kernel_1d(jnp.float32(1.3), kernel_size)
    _close(k_t, k_j)
    _close(tvox._band_matrix(k_t, 16), jvox._band_matrix(k_j, 16))


def test_gaussian_blur_3d_scaled():
    rng = np.random.RandomState(7)
    v = rng.rand(2, 12, 12, 12).astype(np.float32)
    scale = (0.5 + rng.rand(2)).astype(np.float32)
    _close(tvox.gaussian_blur_3d(torch.from_numpy(v), torch.tensor(0.9), 9,
                                 torch.from_numpy(scale)),
           jvox.gaussian_blur_3d(jnp.asarray(v), jnp.float32(0.9), 9,
                                 jnp.asarray(scale)))


def test_termination_and_silhouette():
    v = np.random.RandomState(8).rand(2, 10, 8, 8).astype(np.float32)
    probs_t = tvox.termination_probs(torch.from_numpy(v))
    probs_j = jvox.termination_probs(jnp.asarray(v))
    _close(probs_t, probs_j)
    _close(tvox.project_silhouette(probs_t), jvox.project_silhouette(probs_j))


def test_point_cloud_to_silhouette():
    rng = np.random.RandomState(9)
    pts = (rng.rand(2, 200, 3).astype(np.float32) - 0.5) * 0.7
    q = _quats(rng, 2)
    scale = np.array([0.6, 1.3], np.float32)
    w = (rng.rand(2, 200) > 0.4).astype(np.float32)
    port = tvox.point_cloud_to_silhouette(
        torch.from_numpy(pts), torch.from_numpy(q), torch.tensor(0.8),
        torch.from_numpy(scale), torch.from_numpy(w), voxel_size=16,
        kernel_size=9)
    ref = jvox.point_cloud_to_silhouette(
        jnp.asarray(pts), jnp.asarray(q), jnp.float32(0.8), jnp.asarray(scale),
        jnp.asarray(w), voxel_size=16, kernel_size=9)
    _close(port, ref)
