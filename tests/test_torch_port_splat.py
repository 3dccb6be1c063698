"""The port's standalone splat (K6's function) and fused splat + blur (K7's)
on the CPU against the JAX package's ``trilinear_splat_pallas`` and
``splat_blur_pallas`` (Pallas interpret mode, ``dot_bf16=False``), and
``iou_3d`` against the JAX ``iou_3d``.

Inputs from numpy seeds: B = 2 clouds of N = 256 points, S = 16, half of
the weights 0, a few points outside the border cull, one point exactly on
grid coordinates, two scales for the blur.  Tolerances: values 1e-5, point
gradients 1e-4 absolute, weight gradients 1e-5 on points of weight > 0, the
scale gradient 1e-5 relative.

Two kinds of point are held otherwise, because the JAX package is not the
reference there:

* Zero-weight points.  The JAX wrappers pin their coordinates to voxel
  (0, 0, 0) before the kernel (``im23d_tpu/ops/splat_pallas.py:487-488``,
  ``:538-539``), so their weight gradient is taken there, not at the point
  (off by up to ~2 at this size).  The port takes it at the point: it is
  held to JAX's gradient at the same points given a weight of 1e-6, where
  JAX does not pin them, and to a numpy gather of the cotangent at each
  point's own corners.
* The point on grid coordinates.  There the trilinear weight has a kink:
  the Pallas kernel's hat derivative reads 0 at it, and ``jnp.clip``'s VJP
  passes half the gradient at a voxel whose raw value is exactly 0, which
  the kink's zero-weight corners are.  The port takes the one-sided
  derivative of the floor form, with ``torch.clamp``'s tie rule (the
  gradient passes at 0 and 1); it is held to the numpy gather, which
  states that rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.metrics.iou import iou_3d as j_iou_3d
from im23d_tpu.ops.splat_pallas import (
    splat_blur_pallas,
    trilinear_splat_pallas,
)
from im23d_tpu_torch.metrics.iou import iou_3d
from im23d_tpu_torch.ops import splat as ps

B, N, S, SIGMA = 2, 256, 16, 1.3
SCALES = (0.8, 10.0)
ON_GRID = (0, 11)  # (S - 1)(0.1 + 0.5) is 9 exactly in float32
EPS_WEIGHT = 1e-6


def _inputs():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    pts[:, :8] = rng.uniform(-0.7, 0.7, (B, 8, 3))
    pts[ON_GRID] = 0.1
    w = rng.uniform(0.2, 1.5, (B, N)).astype(np.float32)
    w[:, ::2] = 0.0
    g = rng.randn(B, S, S, S).astype(np.float32)
    return pts, w, g


def _culled(pts):
    return ~np.all(np.abs(pts) < 0.5 - 1e-6, axis=-1)


def _jax_vjp(fn, pts, w, g, *extra):
    out, vjp = jax.vjp(fn, jnp.asarray(pts), jnp.asarray(w),
                       *map(jnp.asarray, extra))
    return (np.asarray(out), *map(np.asarray, vjp(jnp.asarray(g))))


def _k6_jax(p, wt):
    return trilinear_splat_pallas(p, S, wt, dot_bf16=False)


def _k7_jax(p, wt, scale):
    return splat_blur_pallas(p, S, jnp.float32(SIGMA), scale, wt,
                             dot_bf16=False)


@pytest.fixture(scope="module")
def ref():
    """JAX values and VJPs: K6, K7 at each scale, and both with the zero
    weights raised to EPS_WEIGHT (K7 at the first scale)."""
    pts, w, g = _inputs()
    w_eps = np.where(w == 0, np.float32(EPS_WEIGHT), w)
    scales = [np.full((B,), s, np.float32) for s in SCALES]
    return dict(
        k6=_jax_vjp(_k6_jax, pts, w, g),
        k6_eps=_jax_vjp(_k6_jax, pts, w_eps, g),
        k7={s: _jax_vjp(_k7_jax, pts, w, g, sc)
            for s, sc in zip(SCALES, scales)},
        k7_eps=_jax_vjp(_k7_jax, pts, w_eps, g, scales[0]),
    )


def _port(fn, pts, w, g, *extra):
    """Value and gradients of ``fn`` on the CPU (the plain path)."""
    ts = [torch.tensor(a, requires_grad=True) for a in (pts, w, *extra)]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return (out.detach().numpy(), *(t.grad.numpy() for t in ts))


def _check_against_jax(got, want, w):
    """Values, point gradients (not the on-grid point's) and positive-weight
    weight gradients."""
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    keep = np.ones((B, N), bool)
    keep[ON_GRID] = False
    np.testing.assert_allclose(got[1][keep], want[1][keep], rtol=0,
                               atol=1e-4)
    pos = w > 0
    np.testing.assert_allclose(got[2][pos], want[2][pos], rtol=0, atol=1e-5)


def test_inputs_cover_the_cases():
    pts, w, _ = _inputs()
    grid = np.float32(S - 1) * (pts[ON_GRID] + np.float32(0.5))
    assert np.array_equal(grid, np.round(grid))
    culled = _culled(pts)
    assert 2 <= culled.sum() <= 16 and (w[culled] > 0).any()
    assert (w == 0).mean() == 0.5 and w[ON_GRID] > 0


def test_trilinear_splat_matches_jax(ref):
    pts, w, g = _inputs()
    got = _port(lambda p, wt: ps.trilinear_splat(p, S, wt), pts, w, g)
    _check_against_jax(got, ref["k6"], w)
    assert got[0].min() >= 0 and got[0].max() == 1.0  # the clamp binds


@pytest.mark.parametrize("scale", SCALES)
def test_splat_blur_matches_jax(ref, scale):
    pts, w, g = _inputs()
    sc = np.full((B,), scale, np.float32)
    got = _port(lambda p, wt, s: ps.splat_blur(p, S, SIGMA, s, wt), pts, w, g,
                sc)
    want = ref["k7"][scale]
    _check_against_jax(got, want, w)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=0)
    if scale > 1:
        assert got[0].max() == 1.0  # the final clip binds


@pytest.mark.parametrize("which", ["k6", "k7"])
def test_zero_weight_gradients_are_taken_at_the_point(ref, which):
    """JAX pins zero-weight points (see the module docstring); at weight
    EPS_WEIGHT it does not, and its weight gradient there is the port's at
    weight 0."""
    pts, w, g = _inputs()
    if which == "k6":
        got = _port(lambda p, wt: ps.trilinear_splat(p, S, wt), pts, w, g)
    else:
        sc = np.full((B,), SCALES[0], np.float32)
        got = _port(lambda p, wt, s: ps.splat_blur(p, S, SIGMA, s, wt), pts,
                    w, g, sc)
    zero = w == 0
    eps = ref[f"{which}_eps"]
    np.testing.assert_allclose(got[2][zero], eps[2][zero], rtol=0, atol=1e-5)
    at_zero = ref["k6"] if which == "k6" else ref["k7"][SCALES[0]]
    pinned = at_zero[2][zero & ~_culled(pts)]
    assert np.abs(pinned - got[2][zero & ~_culled(pts)]).max() > 0.1


def _gather(pts, w, g):
    """numpy reference of the splat's VJP at each point's own corners: the
    cotangent where the raw splat is <= 1 (the clamp passes ties), times the
    trilinear weights (for d c) or their one-sided derivatives (floor form,
    for the points)."""
    culled = _culled(pts)
    c = np.where(culled, 0.0, w)
    grid = np.float32(S - 1) * (pts + np.float32(0.5))
    base = np.floor(grid)
    frac = (grid - base).astype(np.float64)
    base = base.astype(np.int64)
    raw = np.zeros((B, S, S, S))
    corners = [(i, j, k) for i in range(2) for j in range(2) for k in range(2)]

    def weights(t, o):
        return t * o + (1 - t) * (1 - o)

    for b in range(B):
        for n in range(N):
            for o in corners:
                idx = tuple(np.clip(base[b, n] + o, 0, S - 1))
                raw[(b, *idx)] += c[b, n] * np.prod(
                    [weights(frac[b, n, a], o[a]) for a in range(3)])
    gm = np.where(raw <= 1.0, g, 0.0)
    dc = np.zeros((B, N))
    dp = np.zeros((B, N, 3))
    for b in range(B):
        for n in range(N):
            for o in corners:
                idx = tuple(np.clip(base[b, n] + o, 0, S - 1))
                v = gm[(b, *idx)]
                ws = [weights(frac[b, n, a], o[a]) for a in range(3)]
                dc[b, n] += v * np.prod(ws)
                for a in range(3):
                    d = [2 * o[k] - 1 if k == a else ws[k] for k in range(3)]
                    dp[b, n, a] += c[b, n] * (S - 1) * v * np.prod(d)
    return dp, np.where(culled, 0.0, dc)


def test_trilinear_splat_gradients_are_the_gather():
    """Every point, the zero-weight ones and the on-grid one included."""
    pts, w, g = _inputs()
    _, dp, dw = _port(lambda p, wt: ps.trilinear_splat(p, S, wt), pts, w, g)
    want_dp, want_dw = _gather(pts, w, g)
    np.testing.assert_allclose(dp, want_dp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dw, want_dw, rtol=0, atol=1e-5)
    assert np.abs(want_dp[ON_GRID]).max() > 1  # the kink has a gradient


def test_grid_level_plain_versions_are_the_public_ones():
    """``splat_backward_torch`` / ``splat_blur_backward_torch`` (what the
    card holds K6 and K7 backward to) give the public functions'
    gradients through ``_prep_splat``."""
    pts, w, g = _inputs()
    gz, gy, gx, c = ps._prep_splat(torch.from_numpy(pts), S,
                                   torch.from_numpy(w), 1e-6)
    tg = torch.from_numpy(g)
    d6 = ps.splat_backward_torch(gz, gy, gx, c, tg)
    _, dp, _ = _port(lambda p, wt: ps.trilinear_splat(p, S, wt), pts, w, g)
    np.testing.assert_allclose(torch.stack(d6[:3], -1).numpy() * (S - 1), dp,
                               rtol=1e-6, atol=1e-6)
    taps, _ = ps._taps_and_scale(SIGMA, 1.0, 21, B, "cpu")
    v7 = ps.splat_blur_grid_torch(gz, gy, gx, c, taps, S)
    full = ps.splat_blur_torch(torch.from_numpy(pts), S, SIGMA, 1.0,
                               torch.from_numpy(w))
    np.testing.assert_allclose(
        ps.blur_3d(v7, taps, torch.ones(B), axes=(1,)).numpy(),
        full.numpy(), rtol=0, atol=1e-6)
    d7 = ps.splat_blur_backward_torch(gz, gy, gx, c, taps, tg)
    assert all(d.shape == (B, N) and torch.isfinite(d).all() for d in d7)


def test_kernel_wrappers_refuse_cpu_tensors_and_large_grids():
    pts, w, g = _inputs()
    planes = ps._prep_splat(torch.from_numpy(pts), S, torch.from_numpy(w),
                            1e-6)
    taps = torch.ones(5) / 5
    tg = torch.from_numpy(g)
    for call in (lambda: ps.splat_kernel(*planes, S),
                 lambda: ps.splat_backward_kernel(*planes, tg),
                 lambda: ps.splat_blur_kernel(*planes, taps, S),
                 lambda: ps.splat_blur_backward_kernel(*planes, taps, tg)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="170"):
        ps.splat_blur_kernel(*planes, taps, 171)


def test_iou_3d_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.uniform(-0.4, 0.4, (3, 500, 3)).astype(np.float32)
    b = (a + rng.normal(0, 0.03, a.shape)).astype(np.float32)
    b[2] = rng.uniform(-0.4, 0.4, (500, 3))
    got = iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_iou_3d(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert got[0] > got[2] > 0
