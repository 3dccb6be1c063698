"""The host-side plans of K5 backward and K6 forward, and plain twins of
their orders of sums, on the CPU.

K5 backward (``ops/sampling.py:grid_sample_backward_plan``) and K6 forward
(``ops/splat.py:splat_plan``) choose a kernel by shape alone.  K5
backward: a thread a run of neighbouring samples with one corner cell's
sums in registers, added into d texture only when the cell moves on (any
texture size, up to 4 channels), or a thread a sample.  K6 forward: a
cluster of CTAs a cloud, each holding a whole copy of the grid in shared
memory, the copies added in rank order; or, for a grid that does not fit
a block's shared memory, atomics into device memory.  The plans read
their limits from the kernel library (``k5b_limits``, ``splat_limits``);
here they are the kernels' constants and, for K6, an H100 SXM's 232,448
bytes of shared memory a block and 132 multiprocessors, which
``test_k5b_limits_are_the_plans`` and ``test_k6_limits_are_the_plans`` in
``tests/test_torch_port_kernels.py`` hold against the library on a card.

The plain twins sum as the kernels do: ``grid_sample_backward_runs_torch``
each run's products on their own, then the runs' sums (short runs split
even these small inputs); ``splat_grid_shared_torch`` each CTA's share of
the points into its own copy, then the copies in rank order (with a warp
a CTA, the small clouds here split over the cluster).  Tolerances: against the plain
versions relative L2 1e-6 on d texture and the exact set of texels with
d texture > 0 under a non-negative upstream (pseudo-GT visibility tests
> 0); splat values atol 1e-6.  Against the JAX package's Pallas kernels
in interpret mode, the tolerances of ``tests/test_torch_port_render.py``
(sampling, atol 1e-5) and ``tests/test_torch_port_splat.py`` (splat
values, atol 1e-5).  JAX is imported inside those tests only, so that
the card tests, where there is no JAX, can import this file's limits.
"""

import itertools

import numpy as np
import pytest
import torch

from im23d_tpu_torch.metrics.iou import iou_3d
from im23d_tpu_torch.ops import sampling as ts
from im23d_tpu_torch.ops import splat as sp

K5B_LIMITS = ts.K5bLimits(max_c=4, threads=256, spt=4, max_run=1024)
SPLAT_H100 = sp.SplatLimits(smem_optin=232448, sms=132, max_cluster=8,
                            threads=1024)
# limits that split a few hundred points over a cluster: one warp a CTA
SPLAT_SMALL = SPLAT_H100._replace(threads=32)


def _rel_l2(got, ref) -> float:
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.mark.parametrize("R,run,blocks", [(1024, 64, 3200), (256, 8, 1600)])
def test_k5b_main_path_takes_the_runs(R, run, blocks):
    """The renderer's 50 textures of 128 x 130 x 3: at the visibility
    render's 50 x 1024² samples (63 a texel) runs of 64, at the recon train
    step's 50 x 256² (3.9 a texel) runs of 8; a thread a run, blocks of
    256."""
    plan = ts.grid_sample_backward_plan(50, 128, 130, 3, R * R, True,
                                        K5B_LIMITS)
    assert plan == dict(path="runs", run=run, blocks=blocks)


@pytest.mark.parametrize("H,C", list(itertools.product(
    (1, 16, 128, 256, 1024), (1, 2, 3, 4, 5))))
def test_k5b_plans(H, C):
    """Up to 4 channels every texture size takes the runs: a power of two
    of samples from 8 to 64, the least not below P / (H W) (or 64), one
    thread for every run of an image (the last one partial); more
    channels, or no d texture wanted, take a thread a sample."""
    W = H + 2
    for B, P in itertools.product((1, 8, 50), (1, 7, 33, 4096, 1 << 20)):
        plan = ts.grid_sample_backward_plan(B, H, W, C, P, True, K5B_LIMITS)
        generic = dict(path="generic", run=0, blocks=-(-B * P // 256))
        if C <= 4:
            run = plan["run"]
            assert plan["path"] == "runs" and run in (8, 16, 32, 64)
            assert run == 8 or (run // 2) * H * W < P
            assert run == 64 or run * H * W >= P
            runs = B * -(-P // run)
            assert (plan["blocks"] - 1) * 256 < runs <= plan["blocks"] * 256
        else:
            assert plan == generic
        assert ts.grid_sample_backward_plan(B, H, W, C, P, False,
                                            K5B_LIMITS) == generic


def _k5_inputs(seed, B, H, W, C, Hg, Wg, mask=False):
    rng = np.random.RandomState(seed)
    img = rng.rand(B, H, W, C).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (B, Hg, Wg, 2)).astype(np.float32)
    if mask:  # a 0/1 upstream on every channel, as the visibility render's
        dout = np.repeat((rng.rand(B, Hg, Wg, 1) > 0.5).astype(np.float32),
                         C, axis=-1)
    else:
        dout = rng.randn(B, Hg, Wg, C).astype(np.float32)
    return [torch.from_numpy(a) for a in (img, grid, dout)]


@pytest.mark.parametrize("shape,run,mask", [
    ((2, 9, 13, 3, 16, 24), 8, False), ((2, 9, 13, 3, 16, 24), 32, True),
    ((1, 16, 16, 1, 20, 20), 32, True), ((3, 5, 7, 4, 11, 13), 5, False),
])
def test_k5b_runs_twin_matches_plain(shape, run, mask):
    img, grid, dout = _k5_inputs(1, *shape, mask=mask)
    got = ts.grid_sample_backward_runs_torch(img, grid, dout, run)
    ref = ts.grid_sample_bilinear_backward_torch(img, grid, dout)[0]
    assert _rel_l2(got, ref) <= 1e-6
    if mask:
        assert torch.equal(got > 0, ref > 0)
        assert 0 < float((ref > 0).float().mean()) < 1


def test_k5b_runs_twin_matches_jax():
    """The twin's d texture (runs of 32 samples) and the plain d grid
    against the VJP of the Pallas sampler, at
    ``test_grid_sample_matches_pallas_interpret``'s shape and
    tolerance."""
    import jax
    import jax.numpy as jnp

    from im23d_tpu.ops.sampling_pallas import grid_sample_bilinear_pallas

    rng = np.random.RandomState(0)
    img = rng.rand(1, 16, 16, 3).astype(np.float32)
    grid = rng.uniform(-1, 1, (1, 8, 8, 2)).astype(np.float32)
    dout = rng.randn(1, 8, 8, 3).astype(np.float32)
    _, vjp = jax.vjp(grid_sample_bilinear_pallas, jnp.asarray(img),
                     jnp.asarray(grid))
    j_dimg, j_dgrid = (np.asarray(a) for a in vjp(jnp.asarray(dout)))
    t = [torch.from_numpy(a) for a in (img, grid, dout)]
    dimg = ts.grid_sample_backward_runs_torch(*t, 32)
    dgrid = ts.grid_sample_bilinear_backward_torch(*t)[1]
    np.testing.assert_allclose(dimg.numpy(), j_dimg, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dgrid.numpy(), j_dgrid, atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,want", [
    (24, 32, ("shared", 4)),    # the eval CLI's 3D IoU: 96 CTAs
    (480, 64, ("generic", 0)),  # the candidate sweep's shape
    (1, 38, ("shared", 8)), (1, 39, ("generic", 0)),
    (200, 32, ("shared", 1)), (66, 16, ("shared", 2)), (67, 16, ("shared", 1)),
])
def test_splat_plan(B, S, want):
    plan = sp.splat_plan(B, S, SPLAT_H100)
    assert (plan["path"], plan["cluster"]) == want
    if plan["path"] == "shared":
        assert plan["smem"] == S ** 3 * 4 <= SPLAT_H100.smem_optin
        assert plan["cluster"] == 1 or B * plan["cluster"] <= SPLAT_H100.sms


@pytest.mark.parametrize("S", range(1, 65))
def test_splat_plan_sweep(S):
    """Every shared plan's grid fits a block and its clusters one wave;
    the grids that do not fit (S >= 39) take the generic path."""
    for B in (1, 24, 200):
        plan = sp.splat_plan(B, S, SPLAT_H100)
        assert plan["path"] == ("shared" if S <= 38 else "generic")
        k = plan["cluster"]
        assert k in ((1, 2, 4, 8) if S <= 38 else (0,))
        assert k <= 1 or B * k <= SPLAT_H100.sms


def _splat_inputs(seed, B=2, N=256, S=16):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    pts[:, :8] = rng.uniform(-0.7, 0.7, (B, 8, 3))  # a few culled
    w = rng.uniform(0.2, 1.5, (B, N)).astype(np.float32)
    w[:, ::3] = 0.0
    return pts, w


@pytest.fixture(scope="module")
def k6_ref():
    """The twin's grid, the plain splat's and JAX's Pallas splat's."""
    import jax.numpy as jnp

    from im23d_tpu.ops.splat_pallas import trilinear_splat_pallas

    pts, w = _splat_inputs(0)
    ops = sp._prep_splat(torch.from_numpy(pts), 16, torch.from_numpy(w),
                         1e-6)
    plan = sp.splat_plan(2, 16, SPLAT_SMALL)
    return dict(
        plan=plan,
        twin=sp.splat_grid_shared_torch(*ops, 16, plan, SPLAT_SMALL),
        plain=sp.splat_grid_torch(*ops, 16),
        jax=np.asarray(trilinear_splat_pallas(
            jnp.asarray(pts), 16, jnp.asarray(w), dot_bf16=False)))


@pytest.mark.parametrize("against", ["plain", "jax"])
def test_k6_shared_twin_matches(k6_ref, against):
    assert k6_ref["plan"] == dict(path="shared", cluster=8, smem=16 ** 3 * 4)
    got, ref = k6_ref["twin"].numpy(), k6_ref[against]
    ref = ref.numpy() if against == "plain" else ref
    np.testing.assert_allclose(got, ref, atol=1e-6 if against == "plain"
                               else 1e-5, rtol=0)
    assert got.max() == 1.0 and got.min() == 0.0  # the clamp binds


def test_k6_shared_twin_keeps_the_iou():
    """The 3D IoU from the twin's grids equals ``iou_3d`` (the plain splat)
    and the JAX package's."""
    import jax.numpy as jnp

    from im23d_tpu.metrics.iou import iou_3d as j_iou_3d

    rng = np.random.RandomState(3)
    a = rng.uniform(-0.45, 0.45, (2, 300, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.03, a.shape)).astype(np.float32)
    plan = sp.splat_plan(2, 32, SPLAT_SMALL)
    grids = [sp.splat_grid_shared_torch(
        *sp._prep_splat(torch.from_numpy(pts), 32, None, 1e-6), 32, plan,
        SPLAT_SMALL) > 0.1 for pts in (a, b)]
    inter = (grids[0] & grids[1]).float().sum(dim=(1, 2, 3))
    union = (grids[0] | grids[1]).float().sum(dim=(1, 2, 3))
    twin = inter / union.clamp(min=1.0)
    port = iou_3d(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(twin, port)
    np.testing.assert_allclose(port.numpy(), np.asarray(
        j_iou_3d(jnp.asarray(a), jnp.asarray(b))), atol=1e-6, rtol=0)
