"""The host-side plans of K3 (the Chamfer pair) and K7 forward (splat +
clamp + Y/X blur, a CTA a slab of z-planes), the plain twins of their
partitions, and the plain splat + blur with weights of either sign, on the
CPU.

K3 (``metrics/chamfer.py:chamfer_plan``): a warp holds 256 x points and
walks a group of blocks of 128 y points; rows split over groups and
columns over x warps are combined by atomic minima.  K7
(``ops/splat.py:splat_blur_plan``): a CTA holds a slab of planes and a
temporary in shared memory and splats the corners whose clamped z index
lies in its slab.  The plans read their limits from the kernel library
(``chamfer_limits``, ``splat_blur_limits``); here they are an H100 SXM's
132 multiprocessors and 232,448 bytes of shared memory a block and the
kernels' constants, which ``test_k3_limits_are_the_plans`` and
``test_k7_limits_are_the_plans`` in ``tests/test_torch_port_kernels.py``
hold against the library on a card.

Tolerances: ``nn_dist2_pair_torch`` against a float64 brute force rtol 1e-5
(the same formula in float32) and against the JAX Pallas ``_nn_kernel`` in
interpret mode rtol 1e-5 (the same direct form; the JAX test of that
kernel, ``tests/test_metrics.py:25``, allows rtol 1e-3 against a brute
force).  The slab twin against the plain splat + blur atol 1e-6 (the
splat's sums in another order, values <= 1), and through the Z blur,
scale and clip against JAX's ``splat_blur_pallas`` in interpret mode atol
1e-5 (``tests/test_torch_port_splat.py``'s value tolerance).  The plain
``splat_blur_torch`` against the JAX XLA composition (``trilinear_splat``,
clamped to [0, 1], then ``gaussian_blur_3d`` with the scale and clip):
values atol 1e-5, point gradients atol 1e-4 and weight gradients atol 1e-5
away from the clamp's ties (JAX's clip passes half a gradient at a tie,
torch's all of it), as that file holds them.  JAX is imported inside the
tests that use it, so that the card tests, where there is no JAX, can
import this file's limits.
"""

import itertools

import numpy as np
import pytest
import torch

from im23d_tpu_torch.metrics import chamfer as ch
from im23d_tpu_torch.ops import splat as sp

CHAMFER_H100 = ch.ChamferLimits(sms=132, warps=8, rows=256, cols=128)
BLUR_H100 = sp.SplatBlurLimits(smem_optin=232448, sms=132, list_min=4096)
SMEM = 232448
# limits that split a few hundred points over many warps and groups
CHAMFER_SMALL = CHAMFER_H100._replace(rows=16, cols=8, warps=2, sms=4)


def _clouds(seed, b, n, m, spread=0.8):
    rng = np.random.RandomState(seed)
    x = ((rng.rand(b, n, 3) - 0.5) * spread).astype(np.float32)
    y = ((rng.rand(b, m, 3) - 0.5) * spread).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


# -- K3 -----------------------------------------------------------------------


@pytest.mark.parametrize("B,N,M,ny,groups,ctas", [
    (24, 8000, 512, 1, 4, 384),     # the eval CLI's pair, 3 CTAs an SM
    (24, 8000, 2048, 4, 4, 384),    # the real-data eval's pair
    (24, 512, 8000, 1, 63, 378),    # the gt -> pred role alone
    (24, 2048, 8000, 6, 11, 264),
])
def test_k3_main_shapes_fill_the_card(B, N, M, ny, groups, ctas):
    plan = ch.chamfer_plan(B, N, M, CHAMFER_H100)
    assert (plan["ny"], plan["groups"], plan["ctas"]) == (ny, groups, ctas)
    assert plan["ctas"] >= CHAMFER_H100.sms and "note" not in plan
    assert plan["smem"] == 16384


def _k3_plan_invariants(B, N, M, lim):
    plan = ch.chamfer_plan(B, N, M, lim)
    blocks = -(-M // lim.cols)
    assert plan["xwarps"] == -(-N // lim.rows)
    assert (plan["groups"] - 1) * plan["ny"] < blocks <= (plan["groups"]
                                                          * plan["ny"])
    assert plan["ctas"] == -(-B * plan["xwarps"] * plan["groups"]
                             // lim.warps)
    assert plan["smem"] <= SMEM
    assert (plan["ctas"] >= lim.sms) != ("note" in plan)
    assert plan["row_red"] == (plan["groups"] > 1)
    assert plan["col_red"] == (plan["xwarps"] > 1)
    return plan


@pytest.mark.parametrize("B,N,M", list(itertools.product(
    (1, 24, 480), (1, 7, 512, 2048, 8000), (1, 7, 512, 2048, 8000))))
def test_k3_plans(B, N, M):
    """Every plan's groups cover the y blocks, its CTAs hold its warps and
    fit a block's shared memory, and a plan with fewer CTAs than
    multiprocessors says why; it is never slower, by the plan's own
    measure, than a group of every block or a block a group."""
    plan = _k3_plan_invariants(B, N, M, CHAMFER_H100)
    blocks = -(-M // CHAMFER_H100.cols)

    def cost(ny):
        groups = -(-blocks // ny)
        ctas = -(-B * plan["xwarps"] * groups // CHAMFER_H100.warps)
        return -(-ctas // CHAMFER_H100.sms) * -(-blocks // groups)

    assert cost(plan["ny"]) <= min(cost(1), cost(blocks))


@pytest.mark.parametrize("N,M", list(itertools.product(
    (1, 7, 17, 100, 300), (1, 5, 8, 9, 60, 200))))
def test_k3_tiles_cover_each_pair_once(N, M):
    """The warps' tiles of two clouds cover every (n, m) pair exactly once,
    at limits small enough to split these clouds many ways."""
    B = 2
    plan = _k3_plan_invariants(B, N, M, CHAMFER_SMALL)
    count = np.zeros((B, N, M), np.int64)
    for b, n0, n1, m0, m1 in ch.chamfer_tiles(B, N, M, plan, CHAMFER_SMALL):
        assert 0 <= n0 < n1 <= N and 0 <= m0 < m1 <= M
        count[b, n0:n1, m0:m1] += 1
    assert (count == 1).all()


def _brute(x, y):
    d = ((x[:, :, None, :].astype(np.float64) - y[:, None]) ** 2).sum(-1)
    return d.min(-1)


@pytest.mark.parametrize("n,m", [(100, 37), (257, 255), (64, 1), (1, 130)])
def test_nn_dist2_pair_matches_brute_force_and_pallas(n, m):
    import jax.numpy as jnp

    from im23d_tpu.metrics.chamfer import nn_dist2_pallas

    x, y = _clouds(6, 2, n, m)
    got = ch.nn_dist2_pair_torch(x, y)
    xs, ys = x.numpy(), y.numpy()
    for d, (a, b) in zip(got, ((xs, ys), (ys, xs))):
        np.testing.assert_allclose(d.numpy(), _brute(a, b), rtol=1e-5,
                                   atol=1e-7)
        ref = np.asarray(nn_dist2_pallas(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(d.numpy(), ref, rtol=1e-5, atol=1e-7)


# -- K7 -----------------------------------------------------------------------


@pytest.mark.parametrize("B,S,planes,slabs,ctas,note", [
    (1, 96, 1, 96, 96, True),       # meshing: a plane a CTA, 96 < 132
    (1, 128, 1, 128, 128, True),
    (1, 170, 1, 170, 170, False),
    (480, 64, 5, 13, 6240, False),  # the chairs sweep: slabs of 5
])
def test_k7_main_shapes(B, S, planes, slabs, ctas, note):
    plan = sp.splat_blur_plan(B, S, 21, BLUR_H100)
    assert (plan["planes"], plan["slabs"], plan["ctas"]) == (planes, slabs,
                                                             ctas)
    assert ("note" in plan) == note
    assert plan["smem"] <= SMEM


def _slabs(S, plan):
    return [(j * plan["planes"], min(S, (j + 1) * plan["planes"]))
            for j in range(plan["slabs"])]


@pytest.mark.parametrize("K", [1, 8, 9, 21, 22, 33, 64])
def test_k7_plans(K):
    """Over 1 <= S <= 170 and B in {1, 24, 480}: the slabs partition
    [0, S) without an empty one, the bytes fit a block (and two CTAs an
    SM where a slab has more than one plane), the row stride is odd or S,
    and a plan with fewer CTAs than multiprocessors says why."""
    for S, B in itertools.product(range(1, 171), (1, 24, 480)):
        plan = sp.splat_blur_plan(B, S, K, BLUR_H100)
        slabs = _slabs(S, plan)
        assert slabs[0][0] == 0 and slabs[-1][1] == S
        assert all(a < b for a, b in slabs)
        assert all(b == a2 for (_, b), (a2, _) in zip(slabs, slabs[1:]))
        plane = S * plan["stride"] * 4
        assert plan["smem"] == (plan["planes"] * plane
                                + max(plane, 4 * BLUR_H100.list_min))
        assert plan["smem"] <= SMEM
        if plan["planes"] > 1:
            assert 2 * plan["smem"] <= SMEM
        assert plan["stride"] in (S, S | 1)
        assert plan["stride"] % 2 == 1 or S == 170
        assert plan["ctas"] == B * plan["slabs"]
        assert (plan["ctas"] < BLUR_H100.sms) == ("note" in plan)


def test_k7_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        sp.splat_blur_plan(1, 171, 21, BLUR_H100)
    with pytest.raises(ValueError):
        sp.splat_blur_plan(1, 96, 65, BLUR_H100)


def _edge_points(S, n, seed):
    """Points in [-0.55, 0.55] (some culled), a quarter of them exactly on
    z-planes (some on slab boundaries), a few at z within rounding of
    S - 1 and of 0."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.55, 0.55, (2, n, 3)).astype(np.float32)
    k = n // 4
    planes = rng.randint(0, S, (2, k))
    pts[:, :k, 0] = (planes / np.float32(S - 1) - 0.5).astype(np.float32)
    pts[:, k:k + 4, 0] = np.float32(0.5 - 2e-6)
    pts[:, k + 4:k + 8, 0] = np.float32(-0.5 + 2e-6)
    return pts


def _blur_operands(S, n, seed, signed, K=9, sigma=1.3):
    from im23d_tpu_torch.ops.projection import _taps_and_scale

    pts = torch.from_numpy(_edge_points(S, n, seed))
    rng = np.random.RandomState(seed + 1)
    w = rng.uniform(-1.5, 1.5, (2, n)) if signed else rng.uniform(0, 1.5,
                                                                  (2, n))
    w = torch.from_numpy(w.astype(np.float32))
    gz, gy, gx, c = sp._prep_splat(pts, S, w, 1e-6)
    taps, _ = _taps_and_scale(sigma, 1.0, K, 2, torch.device("cpu"))
    return pts, w, (gz, gy, gx, c), taps


@pytest.mark.parametrize("S,B_plan,signed", list(itertools.product(
    (5, 16, 23), (1, 480), (False, True))))
def test_k7_slab_twin_matches_plain(S, B_plan, signed):
    """The slab twin, at the plan of a meshing run (a plane a slab) and of
    a large batch (slabs of several planes), against the plain splat +
    clamp + Y/X blur; with weights of either sign the clamp binds at both
    ends."""
    _, _, ops, taps = _blur_operands(S, 600, S, signed)
    plan = sp.splat_blur_plan(B_plan, S, taps.numel(), BLUR_H100)
    got = sp.splat_blur_slabs_torch(*ops, taps, S, plan)
    ref = sp.splat_blur_grid_torch(*ops, taps, S)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)
    raw = sp.splat_sum(torch.stack(ops[:3], -1), ops[3], S)
    assert float(raw.max()) > 1.0
    if signed:
        assert float(raw.min()) < 0.0


def test_k7_slab_twin_takes_the_clamped_corners():
    """A point at z within rounding of S - 1 puts both z corners in the
    last plane; on a slab boundary its corners go to two slabs; a slab
    that only its upper corner reaches gets that corner alone."""
    S = 8
    plan = dict(planes=3, slabs=3)
    gz = torch.tensor([[S - 1.0 - 1e-6, 2.0, 2.5]])
    gy = torch.full_like(gz, 3.25)
    gx = torch.full_like(gz, 4.5)
    taps = torch.tensor([1.0])
    for i in range(3):
        c = torch.zeros_like(gz)
        c[0, i] = 0.5
        got = sp.splat_blur_slabs_torch(gz, gy, gx, c, taps, S, plan)
        ref = sp.splat_blur_grid_torch(gz, gy, gx, c, taps, S)
        assert torch.allclose(got, ref, atol=1e-7, rtol=0)
        assert float(got.sum()) == pytest.approx(0.5, abs=1e-6)


@pytest.mark.parametrize("S", [12, 16])
def test_k7_slab_twin_matches_pallas(S):
    """The twin, blurred along Z and scaled and clipped as ``splat_blur``
    does, against JAX ``splat_blur_pallas`` in interpret mode, weights
    >= 0 (the Pallas kernel clamps only the top, see below)."""
    import jax.numpy as jnp

    from im23d_tpu.ops.splat_pallas import splat_blur_pallas
    from im23d_tpu_torch.ops.voxel import blur_3d

    pts, w, ops, taps = _blur_operands(S, 400, S + 1, False, K=21,
                                       sigma=1.5)
    scale = torch.tensor([0.8, 3.0])
    plan = sp.splat_blur_plan(480, S, 21, BLUR_H100)
    assert plan["slabs"] < S  # slabs of several planes
    twin = sp.splat_blur_slabs_torch(*ops, taps, S, plan)
    got = blur_3d(twin, taps, scale, axes=(1,))
    ref = splat_blur_pallas(jnp.asarray(pts.numpy()), S, jnp.float32(1.5),
                            jnp.asarray(scale.numpy()),
                            jnp.asarray(w.numpy()), dot_bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def _xla_splat_blur(pts, w, scale, S, sigma, K):
    """The JAX XLA composition: the XLA splat (clamped to [0, 1]), then the
    3-D blur, the scale and the clip."""
    from im23d_tpu.ops.voxel import gaussian_blur_3d, trilinear_splat

    return gaussian_blur_3d(trilinear_splat(pts, S, w), sigma, K, scale)


def test_splat_blur_torch_mixed_sign_matches_xla():
    """The plain ``splat_blur_torch`` and its gradients (points, weights,
    scale) with weights of either sign against the JAX XLA composition and
    ``jax.grad``; the clamp binds at 0 and at 1."""
    import jax
    import jax.numpy as jnp

    S, K, sigma = 16, 9, 1.3
    pts, w, ops, _ = _blur_operands(S, 300, 3, True, K=K, sigma=sigma)
    raw = sp.splat_sum(torch.stack(ops[:3], -1), ops[3], S)
    assert float(raw.min()) < 0.0 < 1.0 < float(raw.max())
    scale = np.array([0.9, 2.5], np.float32)
    g = np.random.RandomState(4).randn(2, S, S, S).astype(np.float32)

    ts = [t.clone().requires_grad_() for t in (pts, w,
                                               torch.from_numpy(scale))]
    out = sp.splat_blur_torch(ts[0], S, sigma, ts[2], ts[1], kernel_size=K)
    (out * torch.from_numpy(g)).sum().backward()

    def fn(p, wt, sc):
        return _xla_splat_blur(p, wt, sc, S, jnp.float32(sigma), K)

    ref, vjp = jax.vjp(fn, jnp.asarray(pts.numpy()), jnp.asarray(w.numpy()),
                       jnp.asarray(scale))
    d_pts, d_w, d_sc = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    # away from the clamp's ties (raw exactly 0 or 1), where the two
    # frameworks' clip rules differ by design
    grid = (S - 1) * (pts + 0.5)
    on_grid = (grid == torch.floor(grid)).any(-1).numpy()
    keep = ~on_grid
    np.testing.assert_allclose(ts[0].grad.numpy()[keep], d_pts[keep],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts[1].grad.numpy()[keep], d_w[keep],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts[2].grad.numpy(), d_sc, rtol=1e-5, atol=0)


def test_pallas_splat_blur_clamps_only_the_top():
    """A fault of the JAX reference, not copied by the port: the Pallas
    fused kernel takes min(splat, 1) (``splat_pallas.py:230``, "splat
    output is >= 0 by construction"), so with negative weights it differs
    from the XLA composition, which clamps to [0, 1], while the port's
    plain version agrees with the latter."""
    import jax.numpy as jnp

    from im23d_tpu.ops.splat_pallas import splat_blur_pallas

    S, K, sigma = 12, 21, 1.5
    pts, w, _, _ = _blur_operands(S, 300, 7, True, K=K, sigma=sigma)
    scale = jnp.asarray(np.array([1.0, 1.0], np.float32))
    p, wt = jnp.asarray(pts.numpy()), jnp.asarray(w.numpy())
    xla = np.asarray(_xla_splat_blur(p, wt, scale, S, jnp.float32(sigma), K))
    pallas = np.asarray(splat_blur_pallas(p, S, jnp.float32(sigma), scale, wt,
                                          dot_bf16=False))
    port = sp.splat_blur_torch(pts, S, sigma, torch.ones(2), w).numpy()
    assert np.abs(pallas - xla).max() > 1e-3
    np.testing.assert_allclose(port, xla, atol=1e-5, rtol=0)
