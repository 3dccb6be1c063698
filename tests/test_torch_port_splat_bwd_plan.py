"""The host-side plan of K6 and K7 backward (``ops/splat.py:
splat_backward_plan``: a CTA a tile of z-planes, or of one plane's band of
rows where a plane does not fit, that rebuilds its raw splat with a halo
plane and row and gathers the points whose clamped lower corner it owns)
and the plain twin of that partition, ``splat_backward_slabs_torch``, on
the CPU.

The plan reads its limits from the kernel library (``splat_blur_limits``,
K7 forward's); here they are an H100 SXM's 132 multiprocessors and
232,448 bytes of shared memory a block and the kernels' 4,096-entry point
list (``BLUR_H100``, which ``test_k7_limits_are_the_plans`` in
``tests/test_torch_port_kernels.py`` holds against the library on a card).

Tolerances: the twin against ``splat_backward_torch`` /
``splat_blur_backward_torch`` (autograd of the plain forwards) atol 1e-5 on
every output, on operands of size ~1: the same sums in another order and
the explicit derivative of the trilinear weights instead of autograd's
product rule; the raw splat of a tile adds the same corners in the same
order as the plain splat, so the clamp's mask is the same.  Through
``_prep_splat`` and, for K7, the Z blur, scale and clip of ``splat_blur``,
against the JAX ``trilinear_splat_pallas`` / ``splat_blur_pallas`` VJP in
Pallas interpret mode at weights >= 0, with the tolerances of
``tests/test_torch_port_splat.py``: point gradients 1e-4 absolute (the
point on grid coordinates left out: the Pallas hat derivative reads 0 at
its kink), weight gradients 1e-5 on points of weight > 0 (the JAX wrappers
pin zero-weight points to voxel 0).  JAX is imported inside the tests that
use it, so that the card tests, where there is no JAX, can import this
file.  Torch runs on one thread.
"""

import itertools

import numpy as np
import pytest
import torch

from im23d_tpu_torch.ops import splat as sp
from im23d_tpu_torch.ops.projection import _taps_and_scale
from im23d_tpu_torch.ops.voxel import blur_3d

BLUR_H100 = sp.SplatBlurLimits(smem_optin=232448, sms=132, list_min=4096)
SMEM = 232448


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("B,S,K,planes,rows,ctas,note", [
    (120, 64, 0, 8, 64, 960, False),     # K6 at the winners' shape
    (24, 32, 0, 8, 32, 96, True),        # K6 at the 3D IoU's shape
    (1, 96, 21, 1, 96, 96, True),        # K7 at the meshing shape
    (1, 128, 21, 1, 128, 128, True),
    (480, 64, 21, 3, 64, 10560, False),  # K7 at the chairs sweep
    (1, 170, 21, 1, 85, 340, False),     # two bands of rows
    (1, 1024, 0, 1, 25, 41984, False),   # K6 at its largest grid
])
def test_main_shapes(B, S, K, planes, rows, ctas, note):
    plan = sp.splat_backward_plan(B, S, K, BLUR_H100)
    assert (plan["planes"], plan["rows"], plan["ctas"]) == (planes, rows,
                                                            ctas)
    assert ("note" in plan) == note
    assert plan["smem"] <= SMEM
    assert plan["list"] == BLUR_H100.list_min


def test_plan_at_170_and_the_halo():
    """S = 170 keeps the odd stride 171 (K7 forward's plan falls back to
    170) and bands its rows; the halo's share is largest at one plane a
    slab."""
    plan = sp.splat_backward_plan(1, 170, 21, BLUR_H100)
    fwd = sp.splat_blur_plan(1, 170, 21, BLUR_H100)
    assert (plan["stride"], fwd["stride"]) == (171, 170)
    assert plan["bands"] == 2 and plan["rows"] * 2 == 170
    assert plan["halo"] == pytest.approx((170 + 169) * 171 / 170 ** 2 - 1)
    mesh = sp.splat_backward_plan(1, 96, 21, BLUR_H100)
    sweep = sp.splat_backward_plan(480, 64, 21, BLUR_H100)
    assert mesh["halo"] == pytest.approx(95 / 96)
    assert sweep["halo"] == pytest.approx((sweep["slabs"] - 1) / 64)
    assert sweep["halo"] < mesh["halo"]


def _owned(S, step):
    return [(a, min(S, a + step)) for a in range(0, S, step)]


@pytest.mark.parametrize("K", [0, 8, 21, 64])
def test_plans(K):
    """Over 1 <= S <= 170 and B in {1, 24, 120, 480}: the slabs and bands
    partition [0, S), a tile and its halo fit a block (for K7 two CTAs a
    multiprocessor, each with its 1 KB reserve and static variables, where
    a slab has more than one plane; for K6 K6_PLANES planes or as many as
    fit), the stride is odd, bands only where one plane does not fit, and
    a plan with fewer CTAs than multiprocessors says why."""
    for S, B in itertools.product(range(1, 171), (1, 24, 120, 480)):
        plan = sp.splat_backward_plan(B, S, K, BLUR_H100)
        for step, count in ((plan["planes"], plan["slabs"]),
                            (plan["rows"], plan["bands"])):
            parts = _owned(S, step)
            assert len(parts) == count
            assert parts[0][0] == 0 and parts[-1][1] == S
            assert all(a < b for a, b in parts)
        stride = plan["stride"]
        assert stride == S | 1 and stride % 2 == 1
        rows_h = min(plan["rows"] + 1, S)
        assert plan["smem"] == 4 * (min(plan["planes"] + 1, S) * rows_h
                                    * stride + (rows_h * stride if K else 0)
                                    + BLUR_H100.list_min)
        assert plan["smem"] <= SMEM
        if K and plan["planes"] > 1:
            assert 2 * (plan["smem"] + 256 + 1024) <= SMEM + 1024
        m = min(S, sp.K6_PLANES)
        if not K and 4 * (min(m + 1, S) * S * stride
                          + BLUR_H100.list_min) <= SMEM:
            assert plan["slabs"] == -(-S // m)  # then evened out
        if plan["bands"] > 1:
            assert plan["planes"] == 1
            whole = dict(plan, rows=S)
            assert 4 * (2 * S * stride + (S * stride if K else 0)
                        + BLUR_H100.list_min) > SMEM, whole
        assert plan["ctas"] == B * plan["slabs"] * plan["bands"]
        assert (plan["ctas"] < BLUR_H100.sms) == ("note" in plan)


def test_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError):
        sp.splat_backward_plan(1, 96, 65, BLUR_H100)
    with pytest.raises(ValueError):
        sp.splat_backward_plan(1, 0, 21, BLUR_H100)
    small = BLUR_H100._replace(smem_optin=30000)
    with pytest.raises(ValueError, match="does not fit"):
        sp.splat_backward_plan(1, 1024, 0, small)
    assert sp.splat_backward_plan(1, 170, 21, small)["bands"] > 2


def _edge_operands(S, n, seed, signed, plan, b=3):
    """b clouds of n points in [-0.55, 0.55] (some culled), a quarter of
    them exactly on the z-planes where a tile or its halo begins (on band
    rows too where the plan has bands), a few at z within rounding of
    S - 1 and 0; weights of either sign or >= 0, a third of them 0, the
    last cloud's all 0."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.55, 0.55, (b, n, 3)).astype(np.float32)
    k = n // 4
    for axis, step in ((0, plan["planes"]), (1, plan["rows"])):
        if axis == 1 and plan["bands"] == 1:
            break
        edges = np.arange(0, S, step)
        # tile starts and the planes before them: the halo plane
        picks = np.concatenate((edges, np.maximum(edges - 1, 0)))
        pts[:, :k, axis] = (rng.choice(picks, (b, k)) / np.float32(S - 1)
                            - 0.5).astype(np.float32)
    pts[:, k:k + 4, 0] = np.float32(0.5 - 2e-6)
    pts[:, k + 4:k + 8, 0] = np.float32(-0.5 + 2e-6)
    w = rng.uniform(-1.5, 1.5, (b, n)) if signed else rng.uniform(0, 1.5,
                                                                  (b, n))
    w[:, ::3] = 0.0
    w[-1] = 0.0
    w = torch.from_numpy(w.astype(np.float32))
    gz, gy, gx, c = sp._prep_splat(torch.from_numpy(pts), S, w, 1e-6)
    g = torch.from_numpy(rng.randn(b, S, S, S).astype(np.float32))
    return (gz, gy, gx, c), g


# limits that split a small grid into several planes a tile, or into bands
# of rows
TILES = BLUR_H100._replace(smem_optin=40000, sms=2, list_min=64)
BANDS = BLUR_H100._replace(smem_optin=1000, sms=2, list_min=64)


@pytest.mark.parametrize("S,K,lim,signed", [
    (8, 0, BLUR_H100, True), (16, 0, TILES, True), (13, 0, BANDS, True),
    (16, 21, BLUR_H100, True), (16, 9, TILES, True), (16, 8, TILES, True),
    (12, 16, BANDS, True), (16, 21, TILES, False), (5, 8, BLUR_H100, False),
])
def test_twin_matches_plain(S, K, lim, signed):
    """The twin at plans of one plane a tile, of several (a halo plane
    inside the grid and at its end) and of bands of rows, against the
    plain backward: weights of either sign (the clamp binds at 0 and 1),
    points on tiles' edges and past the grid's edge, zero-weight points'
    dc, K = 21, 9, 8 and 16."""
    plan = sp.splat_backward_plan(480, S, K, lim)
    ops, g = _edge_operands(S, 500, S + K, signed, plan)
    if lim is TILES:
        assert plan["planes"] > 1 and plan["bands"] == 1
    if lim is BANDS:
        assert plan["bands"] > 1
    if K:
        taps, _ = _taps_and_scale(1.3, 1.0, K, 3, torch.device("cpu"))
        ref = sp.splat_blur_backward_torch(*ops, taps, g)
    else:
        taps = None
        ref = sp.splat_backward_torch(*ops, g)
    got = sp.splat_backward_slabs_torch(*ops, g, plan, taps)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5, rtol=0)
    raw = sp.splat_sum(torch.stack(ops[:3], -1), ops[3], S)
    assert float(raw.max()) > 1.0
    if signed:
        assert float(raw.min()) < 0.0
    c = ops[3]
    assert float(got[3][c == 0].abs().max()) > 0  # zero weights' dc
    assert not got[0][-1].any()  # the cloud of zero weights


@pytest.mark.parametrize("K", [0, 21])
def test_twin_without_dc(K):
    """need_dc=False: dc None, the other three outputs as with dc, bit for
    bit (the zero-weight points' coordinate gradients are 0 either way)."""
    plan = sp.splat_backward_plan(480, 16, K, TILES)
    ops, g = _edge_operands(16, 400, 7, True, plan)
    taps = (None if not K else
            _taps_and_scale(1.3, 1.0, K, 3, torch.device("cpu"))[0])
    full = sp.splat_backward_slabs_torch(*ops, g, plan, taps)
    part = sp.splat_backward_slabs_torch(*ops, g, plan, taps, need_dc=False)
    assert part[3] is None
    assert all(torch.equal(a, b) for a, b in zip(part[:3], full[:3]))


def test_twin_takes_the_clamped_corners():
    """A point at z within rounding of S - 1 has both z corners in the last
    plane (owned by the last tile, no halo); one at z = -1 + 1e-6 clamps
    both into plane 0; one on a tile's last plane reads the next tile's
    first plane as its halo."""
    S = 8
    plan = dict(planes=3, rows=S, slabs=3, bands=1)
    gz = torch.tensor([[S - 1.0 - 1e-6, 1e-6 - 1.0, 2.5, 2.0]])
    gy = torch.full_like(gz, 3.25)
    gx = torch.full_like(gz, 4.5)
    c = torch.tensor([[0.5, 0.25, 0.75, 1.0]])
    g = torch.from_numpy(np.random.RandomState(0).randn(1, S, S, S)
                         .astype(np.float32))
    got = sp.splat_backward_slabs_torch(gz, gy, gx, c, g, plan)
    ref = sp.splat_backward_torch(gz, gy, gx, c, g)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-6, rtol=0)


B, N, S_JAX, SIGMA = 2, 256, 16, 1.3


def _jax_inputs():
    """test_torch_port_splat.py's inputs: a few points outside the cull,
    half of the weights 0, one point on grid coordinates."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.45, 0.45, (B, N, 3)).astype(np.float32)
    pts[:, :8] = rng.uniform(-0.7, 0.7, (B, 8, 3))
    pts[0, 11] = 0.1
    w = rng.uniform(0.2, 1.5, (B, N)).astype(np.float32)
    w[:, ::2] = 0.0
    g = rng.randn(B, S_JAX, S_JAX, S_JAX).astype(np.float32)
    return pts, w, g


def _through_twin(pts, w, g, plan, taps=None, scale=None):
    """d points and d weights of ``trilinear_splat`` (taps None) or
    ``splat_blur`` at cotangent ``g``, with the twin in place of the
    kernel's backward: autograd of the plain chain around it."""
    p = torch.tensor(pts, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    gz, gy, gx, c = sp._prep_splat(p, S_JAX, wt, 1e-6)
    planes = [t.detach() for t in (gz, gy, gx, c)]
    tg = torch.from_numpy(g)
    if taps is None:
        cot = tg
    else:
        yx = sp.splat_blur_grid_torch(*planes, taps, S_JAX).requires_grad_()
        out = blur_3d(yx, taps, scale, axes=(1,))
        (cot,) = torch.autograd.grad(out, yx, tg)
    grads = sp.splat_backward_slabs_torch(*planes, cot, plan, taps)
    torch.autograd.backward((gz, gy, gx, c), grads)
    return p.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("which", ["k6", "k7"])
def test_twin_matches_pallas_vjp(which):
    """The twin, through ``_prep_splat`` (and for K7 the Z blur, scale and
    clip), against the JAX Pallas kernels' VJP in interpret mode, weights
    >= 0 (the Pallas kernels clamp only the top), at a plan of several
    planes a tile."""
    import jax
    import jax.numpy as jnp

    from im23d_tpu.ops.splat_pallas import (
        splat_blur_pallas,
        trilinear_splat_pallas,
    )

    pts, w, g = _jax_inputs()
    K = 0 if which == "k6" else 21
    plan = sp.splat_backward_plan(480, S_JAX, K, TILES)
    assert plan["planes"] > 1
    scale = np.full((B,), 0.8, np.float32)
    if which == "k6":
        fn = lambda p, wt: trilinear_splat_pallas(p, S_JAX, wt,  # noqa: E731
                                                  dot_bf16=False)
        got = _through_twin(pts, w, g, plan)
    else:
        fn = lambda p, wt: splat_blur_pallas(  # noqa: E731
            p, S_JAX, jnp.float32(SIGMA), jnp.asarray(scale), wt,
            dot_bf16=False)
        taps, _ = _taps_and_scale(SIGMA, 1.0, 21, B, torch.device("cpu"))
        got = _through_twin(pts, w, g, plan, taps, torch.from_numpy(scale))
    _, vjp = jax.vjp(fn, jnp.asarray(pts), jnp.asarray(w))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    keep = np.ones((B, N), bool)
    keep[0, 11] = False
    np.testing.assert_allclose(got[0][keep], want[0][keep], rtol=0,
                               atol=1e-4)
    pos = w > 0
    np.testing.assert_allclose(got[1][pos], want[1][pos], rtol=0, atol=1e-5)
    assert np.abs(got[0]).max() > 0.1
