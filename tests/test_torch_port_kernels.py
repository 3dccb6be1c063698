"""CUDA kernels K1–K9 of the PyTorch port against their plain versions.

Needs a CUDA device: every test here is marked ``cuda`` and skips without
one.  Imports no JAX, so it runs where JAX is not installed; the repository's
``tests/conftest.py`` imports JAX, hence the command on a GPU machine, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tolerances: K1 splats in signed 64-bit 2^-40 fixed point (weights of
either sign, as the plain chain sums them) and blurs in another order than
the plain band matmul, atol 1e-5 on silhouettes <= ~1; K2 is held by
relative L2 error per output,
||kernel - plain|| / ||plain|| <= 1e-4, because a clamp mask within
rounding of its bound can flip and move a few gradients by O(1) of their
value.  Both add the splat with integer atomics, so their launches are
bit-equal; the edge cases of their cluster layout (points on the planes
between two CTAs' slabs, at z = S - 1, dropped, culled or absent clouds)
come from ``chip_smoke.py``'s ``_edge_operands``; K3 computes the plain formula, up to
FMA contraction, rtol 1e-5, in both of its modes (rows only, and the
pair, both directions from one launch), its minima exact, so launches are
bit-equal and the pair's outputs are the rows-only mode's bits; K4 computes the plain rasterizer's
arithmetic with FMA contraction ruled out: feat by the 0.999 quantile of
|kernel - plain| <= 1e-5 (an edge function rounded to the other side would
move a boundary pixel to the other face), soft atol 1e-5 (its log1p terms
are summed in another order, its segment parameters and d2 / sigma taken
by products with reciprocals); its winner cache (win, wz) bit-equal to the
plain winner rule ``rasterize_winners_torch``; K5 is bit-equal to the
plain gather.

The backward kernels are held to the autograd of the plain forwards.  K5's
backward by relative L2 per output (d img sums each run of samples in
registers, then by atomicAdd in another order; d grid differs from
autograd in the order of its additions): 1e-5, and the set of texels with
d img > 0 exactly (pseudo-GT visibility tests > 0); both of its kernels
(runs of samples, a thread a sample) at the shapes that take them.  K4's backward by the limits of the JAX package's rasterizer gradient
test (``tests/test_rasterizer_pallas.py:76-80``): max |d verts| error
< 1e-3 x max(max |d verts|, 1), max |d attrs| error < 1e-4 x
max(max |d attrs|, 1), read on the per-corner gradients d fv: per-face
sums in another order, the segment-parameter chain that
vanishes at the nearest point dropped, and d log_miss taken from 1 − soft.
It sums each face's gradients in registers and one warp reduction, so its
launches are bit-equal.

K6 (the standalone splat: a cluster of CTAs a cloud with a copy of the
grid each in shared memory, or atomics into device memory for a grid too
large) and K7 (splat, clamp, Y/X blur: a CTA a slab of z-planes) add with
atomicAdd (order changes between runs) and K7 blurs in another order than
the plain band matmul: values atol 1e-5.  Their backward kernels (a CTA a
tile of z-planes with a halo plane, ``splat_backward_plan``) rebuild the
splat in 32-bit fixed point for the clamp's mask (0 <= raw <= 1), so a
voxel within rounding of 0 or 1 can flip it: relative L2 per output <=
1e-4, as K2; weights of either sign bind the clamp at both ends.  Their
integer sums make launches bit-equal, and ``need_dc=False`` leaves dgz,
dgy and dgx as they are with dc, bit for bit.

K8 (the GAN head conv) sums 25·C products per output in another order than
cuDNN (in bfloat16 on the tensor cores): forward atol 1e-5 in float32 and
1e-2 in bfloat16 (one bfloat16 ulp near 1); dW by relative L2 <= 1e-4
against the float64 plain version of the upstream rounded to x's type,
bit-equal between launches (a two-pass reduction with no atomics); the
autograd Function's dx, dW and db against autograd of the plain forward.

K9 (the ResBlockUp's folded affine + leaky ReLU + 3×3 conv) sums 9·C
products per output in another order than cuDNN, and its plain version
rounds the activation to x's type as the kernel does: max |kernel -
plain| <= 1e-5 × max(1, max |y|) in float32 and 1e-2 × in bfloat16 (y's
own rounding); its autograd Function (the JAX VJP's formula in PyTorch)
against autograd of the plain forward, relative L2 <= 1e-4 on dx, da, db
and dW in float32; in bfloat16 (its two convs take bf16 operands and
round their outputs to bf16) against float64 autograd of the plain
forward, relative L2 <= 6e-3 (2.7e-3 to 3.5e-3 on the CPU; a dropped
W-pad fold reads 1.4e-1, the slope at pre = 0 9.0e-2).
"""

import functools
import math


import numpy as np
import pytest
import torch

from im23d_tpu_torch.metrics.chamfer import (
    chamfer_distance,
    chamfer_kernel,
    chamfer_limits,
    chamfer_plan,
    nn_dist2,
    nn_dist2_kernel,
    nn_dist2_pair_torch,
    nn_dist2_torch,
)
from im23d_tpu_torch.ops.conv import (
    fused_affine_conv3x3,
    fused_affine_conv3x3_kernel,
    fused_affine_conv3x3_torch,
    head_conv_dw_kernel,
    head_conv_dw_torch,
    head_conv_kernel,
    head_conv_tanh,
    head_conv_tanh_torch,
    k9_limits,
)
from im23d_tpu_torch.ops.projection import (
    _prep_projection,
    projection_grid_torch,
    projection_limits,
    projection_occupancy,
    projection_plan,
    _taps_and_scale,
    projection_backward_kernel,
    projection_backward_torch,
    projection_kernel,
    projection_silhouette,
    projection_silhouette_reuse,
    projection_silhouette_torch,
)
from im23d_tpu_torch.ops.sampling import (
    grid_sample_backward_plan,
    grid_sample_bilinear,
    grid_sample_bilinear_backward_kernel,
    grid_sample_bilinear_backward_torch,
    grid_sample_bilinear_kernel,
    grid_sample_bilinear_torch,
    k5b_limits,
)
from im23d_tpu_torch.ops.splat import (
    _prep_splat,
    splat_limits,
    splat_plan,
    splat_backward_kernel,
    splat_backward_torch,
    splat_blur,
    splat_blur_backward_kernel,
    splat_blur_backward_torch,
    splat_blur_grid_torch,
    splat_blur_kernel,
    splat_blur_limits,
    splat_blur_plan,
    splat_backward_plan,
    splat_grid_torch,
    splat_kernel,
    trilinear_splat,
)
from im23d_tpu_torch.ops.voxel import splat_sum
from im23d_tpu_torch.render.rasterizer import (
    _gather_corners,
    _launch_forward,
    rasterize,
    rasterize_backward_kernel,
    rasterize_backward_torch,
    rasterize_kernel,
    rasterize_torch,
    rasterize_winners_torch,
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


def _rel_l2(got, ref):
    return float((got - ref).norm() / ref.norm())


def _grid_operands(dev, S, ks, sigma, b=3, n=1000, seed=0):
    pts, w, scale = _points(seed, b, n, dev=dev)
    gz, gy, gx, c = _prep_projection(pts, S, w, 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale, ks, b,
                               dev)
    gsil = torch.randn((b, S, S), device=dev,
                       generator=torch.Generator(dev).manual_seed(seed))
    return [t.contiguous() for t in (gz, gy, gx, c, taps, sc, gsil)]


@pytest.mark.parametrize("S,ks,sigma", [(16, 9, 0.8), (32, 21, 3.0),
                                        (64, 21, 0.2), (20, 8, 1.3)])
def test_k2_matches_plain(dev, S, ks, sigma):
    ops = _grid_operands(dev, S, ks, sigma)
    n0 = projection_backward_kernel.launches
    got = projection_backward_kernel(*ops)
    ref = projection_backward_torch(*ops)
    torch.cuda.synchronize()
    assert projection_backward_kernel.launches == n0 + 1
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert _rel_l2(g, r) <= 1e-4, (_rel_l2(g, r), float((g - r).abs().max()))


def test_projection_autograd_runs_k1_and_k2(dev):
    """projection_silhouette with grad on the card: K1 forward, K2 backward,
    against the plain chain's autograd on the CPU."""
    pts, w, scale = _points(5, 3, 1000, dev=dev)
    cot = torch.randn((3, 32, 32), device=dev)

    def run(device):
        p = pts.detach().to(device).clone().requires_grad_()
        s = scale.detach().to(device).clone().requires_grad_()
        out = projection_silhouette(p, 32, torch.tensor(1.1, device=device),
                                    s, weights=w.to(device))
        (out * cot.to(device)).sum().backward()
        return out.detach().cpu(), p.grad.cpu(), s.grad.cpu()

    k1, k2 = projection_kernel.launches, projection_backward_kernel.launches
    got = run(dev)
    torch.cuda.synchronize()
    assert projection_kernel.launches == k1 + 1
    assert projection_backward_kernel.launches == k2 + 1
    ref = run("cpu")
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
    for g, r in zip(got[1:], ref[1:]):
        assert _rel_l2(g, r) <= 1e-4


def test_reuse_runs_k2_only(dev):
    pts, w, scale = _points(6, 4, 1000, dev=dev)
    sig = torch.tensor(0.7, device=dev)
    with torch.no_grad():
        sweep = projection_silhouette(pts, 32, sig, scale, weights=w)
    cot = torch.randn_like(sweep)

    def grads(reuse):
        p, s = pts.clone().requires_grad_(), scale.clone().requires_grad_()
        out = (projection_silhouette_reuse(p, 32, sig, s, sweep, weights=w)
               if reuse else projection_silhouette(p, 32, sig, s, weights=w))
        (out * cot).sum().backward()
        return out.detach(), p.grad, s.grad

    k1, k2 = projection_kernel.launches, projection_backward_kernel.launches
    out, gp, gs = grads(True)
    torch.cuda.synchronize()
    assert projection_kernel.launches == k1
    assert projection_backward_kernel.launches == k2 + 1
    assert torch.equal(out, sweep)
    _, fp, fs = grads(False)
    assert _rel_l2(gp, fp) <= 1e-4 and _rel_l2(gs, fs) <= 1e-4


def test_k2_rejects_bad_operands(dev):
    gz, gy, gx, c, taps, sc, gsil = _grid_operands(dev, 16, 9, 1.0, b=2,
                                                   n=64)
    with pytest.raises(TypeError):
        projection_backward_kernel(gz.double(), gy, gx, c, taps, sc, gsil)
    with pytest.raises(ValueError):
        projection_backward_kernel(gz, gy, gx, c, taps, sc, gsil[:1])
    with pytest.raises(ValueError):
        projection_backward_kernel(gz.cpu(), gy, gx, c, taps, sc, gsil)


def test_projection_limits_are_the_plans(dev):
    """The kernel library's constants are those that the CPU tests of
    ``projection_plan`` assume (``tests/test_torch_port_projection_plan.py``),
    and a cluster of each plan the card tests use fits the card."""
    from test_torch_port_projection_plan import H100 as PLAN_H100

    lim = projection_limits(dev)
    assert lim._replace(smem_optin=0) == PLAN_H100._replace(smem_optin=0)
    for S, K in ((64, 21), (32, 21), (16, 9), (20, 7), (20, 8)):
        plan = projection_plan(S, K, lim)
        assert plan["smem_bwd"] <= lim.smem_optin
        for backward in (False, True):
            assert projection_occupancy(plan, S, K, backward) >= 1


@pytest.mark.parametrize("S,ks,sigma", [(64, 21, 3.0), (64, 21, 0.2),
                                        (20, 7, 1.3)])
def test_k1_k2_edge_clouds(dev, S, ks, sigma):
    """Points on the planes between two CTAs' slabs and at z = S - 1, a
    blob whose splat passes the clamp, dropped and culled clouds."""
    from chip_smoke import _edge_operands

    planes = projection_plan(S, ks, projection_limits(dev))["planes"]
    ops = _edge_operands(S, ks, sigma, planes, dev)
    got = projection_kernel(*ops[:6], S)
    ref = projection_grid_torch(*ops[:6], S)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    for g, r in zip(projection_backward_kernel(*ops),
                    projection_backward_torch(*ops)):
        assert torch.isfinite(g).all()
        assert _rel_l2(g, r) <= 1e-4, (_rel_l2(g, r),
                                       float((g - r).abs().max()))


@pytest.mark.parametrize("S,ks,sigma", [(1, 1, 1.0), (9, 64, 2.0),
                                        (60, 5, 1.0), (64, 9, 1.0)])
def test_k1_k2_generic_shapes(dev, S, ks, sigma):
    """The generic instance at the ends of its range: one plane, 64 taps,
    a splat in two passes (S = 60), and S = 64 with other taps."""
    ops = _grid_operands(dev, S, ks, sigma)
    got = projection_kernel(*ops[:6], S)
    torch.testing.assert_close(got, projection_grid_torch(*ops[:6], S),
                               atol=1e-5, rtol=0)
    for g, r in zip(projection_backward_kernel(*ops),
                    projection_backward_torch(*ops)):
        assert torch.isfinite(g).all()
        err = float((g - r).abs().max())
        assert err == 0.0 or _rel_l2(g, r) <= 1e-4, (_rel_l2(g, r), err)


def test_k1_k2_empty_clouds(dev):
    """Clouds without points: the silhouettes of an empty grid (every
    occupancy at eps), empty coordinate gradients and dscale 0."""
    ops = _grid_operands(dev, 64, 21, 3.0, b=2, n=0)
    got = projection_kernel(*ops[:6], 64)
    torch.testing.assert_close(got, projection_grid_torch(*ops[:6], 64),
                               atol=1e-5, rtol=0)
    dgz, dgy, dgx, dscale = projection_backward_kernel(*ops)
    assert dgz.shape == dgy.shape == dgx.shape == (2, 0)
    assert torch.equal(dscale, projection_backward_torch(*ops)[3])


@pytest.mark.parametrize("S,ks,sigma", [(64, 21, 3.0), (16, 9, 0.8)])
def test_k1_k2_mixed_sign_weights(dev, S, ks, sigma):
    """Weights of either sign: points of weight <= 0 are pinned to grid
    coordinate 0 (``_prep_projection``), where positive points also sit,
    so the signed sum before the clamp to [0, 1] decides the corner voxels
    (a kernel that dropped the negative weights reads ~0.1 off there)."""
    pts, _, scale = _points(21, 3, 1000, dev=dev)
    gen = torch.Generator(dev).manual_seed(22)
    w = torch.rand((3, 1000), device=dev, generator=gen) * 2.0 - 1.0
    pts[:, :100] = -0.5 + torch.rand((3, 100, 3), device=dev,
                                     generator=gen) * 0.03
    w[:, :100] = w[:, :100].abs() + 0.5
    gz, gy, gx, c = _prep_projection(pts, S, w, 1e-6)
    assert bool((c < 0).any())
    taps, sc = _taps_and_scale(torch.tensor(sigma, device=dev), scale, ks, 3,
                               dev)
    gsil = torch.randn((3, S, S), device=dev, generator=gen)
    ops = [t.contiguous() for t in (gz, gy, gx, c, taps, sc, gsil)]
    got = projection_kernel(*ops[:6], S)
    ref = projection_grid_torch(*ops[:6], S)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    for g, r in zip(projection_backward_kernel(*ops),
                    projection_backward_torch(*ops)):
        assert torch.isfinite(g).all()
        assert _rel_l2(g, r) <= 1e-4, (_rel_l2(g, r),
                                       float((g - r).abs().max()))


def test_k1_k2_launches_are_bit_equal(dev):
    """The splat's integer atomics commute and dscale is a fixed-order
    reduction: three launches give the same bits."""
    ops = _grid_operands(dev, 64, 21, 3.0, b=8, n=4000, seed=7)
    sils = [projection_kernel(*ops[:6], 64) for _ in range(3)]
    assert all(torch.equal(s, sils[0]) for s in sils)
    grads = [projection_backward_kernel(*ops) for _ in range(3)]
    for g in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0]))


@pytest.mark.parametrize("n,m", [(1, 1), (255, 257), (1000, 256),
                                 (8000, 512), (8000, 2048)])
def test_k3_matches_plain(dev, n, m):
    """Both modes: rows only (``nn_dist2``) and the pair
    (``chamfer_distance``: one launch for both directions, held to the
    plain version in both; its outputs the rows-only mode's bits, 3
    launches bit-equal)."""
    x = _points(3, 2, n, 0.8, dev)[0]
    y = _points(4, 2, m, 0.8, dev)[0]
    n0 = nn_dist2_kernel.launches
    got = nn_dist2(x, y)
    torch.cuda.synchronize()
    assert nn_dist2_kernel.launches == n0 + 1
    torch.testing.assert_close(got, nn_dist2_torch(x, y), rtol=1e-5,
                               atol=1e-7)
    p0, r0 = chamfer_kernel.launches, nn_dist2_kernel.launches
    total, t1, t2 = chamfer_distance(x, y)
    torch.cuda.synchronize()
    assert (chamfer_kernel.launches, nn_dist2_kernel.launches) == (p0 + 1,
                                                                  r0)
    ref = nn_dist2_pair_torch(x, y)
    pairs = [chamfer_kernel(x, y) for _ in range(3)]
    for d, r in zip(pairs[0], ref):
        torch.testing.assert_close(d, r, rtol=1e-5, atol=1e-7)
    assert all(torch.equal(a, b) for p in pairs[1:]
               for a, b in zip(p, pairs[0]))
    assert torch.equal(pairs[0][0], got)
    assert torch.equal(pairs[0][1], nn_dist2(y, x))
    torch.testing.assert_close(t1, ref[0].mean(-1), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(t2, ref[1].mean(-1), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(total, t1 + t2)


def test_k3_limits_are_the_plans(dev):
    """The kernel library's constants are those that the CPU tests of
    ``chamfer_plan`` assume (``tests/test_torch_port_k3_k7_plan.py``), and
    the eval CLI's pair fills the card."""
    from test_torch_port_k3_k7_plan import CHAMFER_H100

    lim = chamfer_limits(dev)
    assert lim._replace(sms=0) == CHAMFER_H100._replace(sms=0)
    assert chamfer_plan(24, 8000, 512, lim)["ctas"] >= lim.sms


def _scene(seed, dev, B=2, V=40, F=60, A=3, spread=0.9):
    rng = np.random.RandomState(seed)
    verts = rng.uniform(-spread, spread, (B, V, 3)).astype(np.float32)
    faces = np.stack([rng.choice(V, 3, replace=False)
                      for _ in range(F)]).astype(np.int64)
    attrs = rng.rand(B, F, 3, A).astype(np.float32)
    return (torch.from_numpy(verts).to(dev), torch.from_numpy(faces).to(dev),
            torch.from_numpy(attrs).to(dev))


def _check_k4(got, ref, soft_atol=1e-5):
    d = (got[0] - ref[0]).abs().flatten().cpu().numpy()
    assert np.quantile(d, 0.999) <= 1e-5, np.quantile(d, 0.999)
    assert float((got[1] - ref[1]).abs().max()) <= soft_atol


@pytest.mark.parametrize("cull,h,w,sigma,A", [
    (True, 64, 64, 1e-3, 3), (False, 64, 64, 1e-3, 3),
    (True, 70, 45, 1e-4, 1), (False, 33, 97, 1e-4, 8),
])
def test_k4_matches_plain(dev, cull, h, w, sigma, A):
    """Random overlapping faces (both windings), tiles cut by odd sizes,
    one to eight attributes."""
    verts, faces, attrs = _scene(7, dev, A=A)
    n0 = rasterize_kernel.launches
    got = rasterize(verts, faces, attrs, h, w, sigma, cull)
    ref = rasterize_torch(verts, faces, attrs, h, w, sigma, cull)
    torch.cuda.synchronize()
    assert rasterize_kernel.launches == n0 + 1
    _check_k4(got, ref)


@pytest.mark.parametrize("cull,h,w,sigma,A", [
    (True, 64, 64, 1e-3, 3), (False, 64, 64, 1e-3, 3),
    (True, 70, 45, 1e-4, 1), (False, 33, 97, 1e-4, 8),
    (True, 48, 48, 1e-2, 3),
])
def test_k4_winners_match_plain_rule(dev, cull, h, w, sigma, A):
    """The winner cache K4 writes for its backward (chunk << 6 | count,
    and z) is bit-equal to the plain winner rule, and so is feat where a
    face covers the pixel alone in its chunk."""
    verts, faces, attrs = _scene(7, dev, A=A)
    out = _launch_forward(_gather_corners(verts, faces), attrs, h, w, sigma,
                          cull, winners=True)
    win, wz = rasterize_winners_torch(verts, faces, h, w, cull)
    torch.cuda.synchronize()
    assert torch.equal(out[2], win)
    assert torch.equal(out[3], wz)
    assert bool((win >= 0).any()) and bool((win < 0).any())


def test_k4_sphere_ties_match_plain(dev):
    """A closed sphere: shared edges give depth ties within and across
    chunks of 32, the case the tie rules exist for."""
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate

    tpl = MeshTemplate(segments=32, rings=16)
    v = tpl.tensor("vertices", dev)[None] * 0.7
    v = torch.cat([v, v * v.new_tensor([1.0, -1.0, -1.0])])
    faces = tpl.tensor("faces", dev)
    attrs = torch.rand((2, faces.shape[0], 3, 3), device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    for cull in (True, False):
        got = rasterize(v, faces, attrs, 128, 128, 1e-4, cull)
        ref = rasterize_torch(v, faces, attrs, 128, 128, 1e-4, cull)
        out = _launch_forward(_gather_corners(v, faces), attrs, 128, 128,
                              1e-4, cull, winners=True)
        win, wz = rasterize_winners_torch(v, faces, 128, 128, cull)
        torch.cuda.synchronize()
        _check_k4(got, ref)
        assert torch.equal(got[0][..., 0] != 0, ref[0][..., 0] != 0)
        assert torch.equal(out[2], win) and torch.equal(out[3], wz)


def test_k4_empty_scene(dev):
    verts, faces, attrs = _scene(8, dev)
    verts[..., 0] += 5.0
    for f in (faces, faces[:0]):
        feat, soft = rasterize(verts, f, attrs[:, :len(f)], 16, 40)
        torch.cuda.synchronize()
        assert not feat.any() and not soft.any()


def test_k4_rejects_bad_operands(dev):
    verts, faces, attrs = _scene(9, dev, A=9)
    with pytest.raises(ValueError):
        rasterize_kernel(verts, faces, attrs, 16, 16)  # A > MAX_ATTRS
    with pytest.raises(TypeError):
        rasterize_kernel(verts.double(), faces, attrs[..., :3], 16, 16)
    with pytest.raises(ValueError):
        rasterize_kernel(verts.cpu(), faces, attrs[..., :3], 16, 16)


@pytest.mark.parametrize("shape,grid_hw", [
    ((2, 128, 130, 3), (256, 256)), ((3, 7, 5, 1), (9, 11)),
    ((1, 1024, 1024, 3), (64, 80)), ((2, 16, 16, 5), (1, 1)),
])
def test_k5_matches_plain(dev, shape, grid_hw):
    """Bit-equal to the plain gather at aligned, odd and photo-sized
    textures, coordinates beyond the edges included."""
    gen = torch.Generator(dev).manual_seed(1)
    img = torch.rand(shape, device=dev, generator=gen)
    grid = torch.rand((shape[0], *grid_hw, 2), device=dev,
                      generator=gen) * 2.4 - 1.2
    n0 = grid_sample_bilinear_kernel.launches
    got = grid_sample_bilinear(img, grid)
    torch.cuda.synchronize()
    assert grid_sample_bilinear_kernel.launches == n0 + 1
    torch.testing.assert_close(got, grid_sample_bilinear_torch(img, grid),
                               atol=0, rtol=0)


@pytest.mark.parametrize("C", [1, 3, 4, 2, 5])
def test_k5_edges_match_plain(dev, C):
    """Bit-equal at C in {1, 3, 4} (four samples a thread) and 2, 5 (a
    sample a thread), 35 samples an image (groups of four straddle two
    images, and the last group is partial), coordinates exactly on texel
    borders, at +-1 and beyond, and with a grid that is not 16-byte
    aligned (a sample a thread)."""
    gen = torch.Generator(dev).manual_seed(C)
    img = torch.rand((2, 9, 13, C), device=dev, generator=gen)
    xs = torch.tensor([-1.0 + 2.0 * k / 12 for k in range(-1, 14)]
                      + [-1.0, 1.0, -1.05, 1.05, 1.0000001, -1.0000001],
                      device=dev)
    ys = torch.tensor([-1.0 + 2.0 * k / 8 for k in range(-1, 10)]
                      + [1.0, -1.0, 1.3], device=dev)
    pick = torch.randint(0, len(xs), (2, 5, 7), device=dev, generator=gen)
    pick_y = torch.randint(0, len(ys), (2, 5, 7), device=dev, generator=gen)
    grid = torch.stack([xs[pick], ys[pick_y]], dim=-1).contiguous()
    ref = grid_sample_bilinear_torch(img, grid)
    n0 = grid_sample_bilinear_kernel.launches
    got = grid_sample_bilinear_kernel(img, grid)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    flat = torch.empty(grid.numel() + 2, device=dev)
    shifted = flat[2:].view(grid.shape)  # 8 bytes past an aligned start
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 == 8 and shifted.is_contiguous()
    torch.testing.assert_close(grid_sample_bilinear_kernel(img, shifted),
                               ref, atol=0, rtol=0)
    torch.cuda.synchronize()
    assert grid_sample_bilinear_kernel.launches == n0 + 2


def test_k5_rejects_bad_operands(dev):
    img = torch.rand((2, 8, 8, 3), device=dev)
    grid = torch.rand((2, 4, 4, 2), device=dev)
    with pytest.raises(TypeError):
        grid_sample_bilinear_kernel(img.double(), grid)
    with pytest.raises(ValueError):
        grid_sample_bilinear_kernel(img, grid[:1])
    with pytest.raises(ValueError):
        grid_sample_bilinear_kernel(img.cpu(), grid)


def test_render_mesh_on_the_card_matches_the_cpu(dev):
    """render_mesh through K4 and K5 against the plain path on the CPU."""
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.renderer import render_mesh

    tpl = MeshTemplate(segments=16, rings=8)
    rng = np.random.RandomState(10)
    dmap = torch.from_numpy((rng.randn(2, 16, 16, 3) * 0.05).astype(
        np.float32))
    tex = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))

    def run(device):
        v = tpl.get_vertex_positions(dmap.to(device)) * 0.7
        uvs, t = tpl.adjust_uv_and_texture(tex.to(device))
        out = render_mesh(v, tpl.tensor("faces", device), uvs,
                          tpl.tensor("face_uvs", device), t, 64, 64)
        return [o.cpu() for o in out]

    k4, k5 = rasterize_kernel.launches, grid_sample_bilinear_kernel.launches
    got = run(dev)
    assert rasterize_kernel.launches == k4 + 1
    assert grid_sample_bilinear_kernel.launches == k5 + 1
    ref = run("cpu")
    _check_k4(got[:2], ref[:2])
    torch.testing.assert_close(got[2], ref[2], atol=1e-5, rtol=1e-5)


def _rel_l2(got, ref):
    return float((got - ref).norm() / ref.norm().clamp(min=1e-30))


@pytest.mark.parametrize("shape,grid_hw,integer", [
    ((2, 128, 130, 3), (256, 256), False), ((3, 7, 5, 1), (9, 11), True),
    ((1, 64, 64, 3), (300, 200), False),
])
def test_k5_backward_matches_plain(dev, shape, grid_hw, integer):
    """d img and d grid against autograd of the plain gather, coordinates
    beyond the edges and on exact texel centres included; launched by the
    autograd Function."""
    gen = torch.Generator(dev).manual_seed(2)
    img = torch.rand(shape, device=dev, generator=gen)
    grid = torch.rand((shape[0], *grid_hw, 2), device=dev,
                      generator=gen) * 2.2 - 1.1
    if integer:  # texel centres: x = i exactly
        H, W = shape[1:3]
        ix = torch.randint(0, W, grid.shape[:3], device=dev, generator=gen)
        grid[..., 0] = ix.float() * 2.0 / (W - 1) - 1.0 if W > 1 else 0.0
    dout = torch.randn((shape[0], *grid_hw, shape[3]), device=dev,
                       generator=gen)
    ref = grid_sample_bilinear_backward_torch(img, grid, dout)
    n0 = grid_sample_bilinear_backward_kernel.launches
    i = img.clone().requires_grad_()
    g = grid.clone().requires_grad_()
    got = torch.autograd.grad(grid_sample_bilinear(i, g), (i, g), dout)
    torch.cuda.synchronize()
    assert grid_sample_bilinear_backward_kernel.launches == n0 + 1
    for a, b in zip(got, ref):
        assert _rel_l2(a, b) <= 1e-5


def test_k5_backward_visibility_zero_pattern(dev):
    """A 0/1 upstream mask (the visibility render's): the texels with
    d img > 0 are the plain version's, and d grid is not computed."""
    gen = torch.Generator(dev).manual_seed(3)
    img = torch.rand((2, 32, 34, 3), device=dev, generator=gen)
    grid = torch.rand((2, 200, 200, 2), device=dev, generator=gen) * 1.6 - 0.8
    dout = (torch.rand((2, 200, 200, 1), device=dev, generator=gen) > 0.6
            ).float().expand(-1, -1, -1, 3).contiguous()
    dimg, dgrid = grid_sample_bilinear_backward_kernel(img, grid, dout,
                                                       need_grid=False)
    ref, _ = grid_sample_bilinear_backward_torch(img, grid, dout)
    torch.cuda.synchronize()
    assert dgrid is None
    assert torch.equal(dimg > 0, ref > 0)
    assert 0 < float((ref > 0).float().mean()) < 1


def test_k5b_limits_are_the_plans(dev):
    """The kernel library's constants are those that the CPU tests of
    ``grid_sample_backward_plan`` assume
    (``tests/test_torch_port_scatter_plan.py``)."""
    from test_torch_port_scatter_plan import K5B_LIMITS

    assert k5b_limits() == K5B_LIMITS


@pytest.mark.parametrize("shape,grid_hw,path,mask", [
    ((2, 128, 130, 3), (256, 256), "runs", False),
    ((2, 128, 130, 3), (256, 256), "runs", True),
    ((3, 9, 13, 1), (35, 7), "runs", True),   # P % 4 != 0: scalar loads
    ((1, 16, 16, 2), (64, 64), "runs", False),
    ((2, 40, 40, 4), (100, 128), "runs", False),
    ((2, 64, 66, 3), (40, 300), "runs", False),
    ((2, 256, 258, 3), (128, 128), "runs", False),  # 792,576 bytes
    ((2, 256, 258, 3), (128, 128), "runs", True),
    ((2, 16, 16, 5), (32, 32), "generic", False),   # C > 4
    ((2, 16, 16, 5), (32, 32), "generic", True),
])
def test_k5_backward_paths(dev, shape, grid_hw, path, mask):
    """d img and d grid of both kernels against autograd of the plain
    gather, the kernel the plan's; under a 0/1 upstream the texels with
    d img > 0 exactly the plain version's."""
    gen = torch.Generator(dev).manual_seed(4)
    B, H, W, C = shape
    img = torch.rand(shape, device=dev, generator=gen)
    grid = torch.rand((B, *grid_hw, 2), device=dev, generator=gen) * 2.2 - 1.1
    if mask:
        dout = (torch.rand((B, *grid_hw, 1), device=dev, generator=gen) > 0.5
                ).float().expand(-1, -1, -1, C).contiguous()
    else:
        dout = torch.randn((B, *grid_hw, C), device=dev, generator=gen)
    plan = grid_sample_backward_plan(B, H, W, C, grid_hw[0] * grid_hw[1],
                                     True, k5b_limits())
    assert plan["path"] == path
    ref = grid_sample_bilinear_backward_torch(img, grid, dout)
    got = grid_sample_bilinear_backward_kernel(img, grid, dout)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) <= 1e-5, _rel_l2(a, b)
    if mask:
        assert torch.equal(got[0] > 0, ref[0] > 0)
    # d grid has no atomics: bit-equal between launches, and d img alone
    # gives the same d img
    again = grid_sample_bilinear_backward_kernel(img, grid, dout)
    assert torch.equal(again[1], got[1])
    only = grid_sample_bilinear_backward_kernel(img, grid, dout,
                                                need_grid=False)
    assert only[1] is None and _rel_l2(only[0], ref[0]) <= 1e-5


def test_k5_backward_unaligned_grid(dev):
    """A grid and upstream 8 bytes past an aligned start: the shared path's
    scalar loads."""
    gen = torch.Generator(dev).manual_seed(5)
    img = torch.rand((2, 32, 34, 3), device=dev, generator=gen)
    grid = torch.rand((2, 64, 64, 2), device=dev, generator=gen) * 2 - 1
    dout = torch.randn((2, 64, 64, 3), device=dev, generator=gen)
    flat = torch.empty(grid.numel() + 2, device=dev)
    shifted = flat[2:].view(grid.shape)
    shifted.copy_(grid)
    assert shifted.data_ptr() % 16 == 8
    ref = grid_sample_bilinear_backward_torch(img, grid, dout)
    got = grid_sample_bilinear_backward_kernel(img, shifted, dout)
    for a, b in zip(got, ref):
        assert _rel_l2(a, b) <= 1e-5


def _k4_grad_check(got, ref):
    for g, r, k in zip(got, ref, (1e-3, 1e-4)):
        scale = max(float(r.abs().max()), 1.0)
        assert float((g - r).abs().max()) < k * scale, (k, scale)


@pytest.mark.parametrize("cull", [True, False])
def test_k4_backward_matches_plain_sphere(dev, cull):
    """The JAX rasterizer gradient test's scene: a jittered uv_sphere(8, 4)
    at 48² with sigma 1e-3, random upstream gradients of feat and soft."""
    from im23d_tpu_torch.geometry.objio import uv_sphere

    tpl = uv_sphere(8, 4)
    rng = np.random.RandomState(11)
    B, F = 2, tpl.faces.shape[0]
    verts = torch.from_numpy((tpl.vertices[None].repeat(B, 0) * 1.5
                              + 0.05 * rng.randn(B, len(tpl.vertices), 3))
                             .astype(np.float32)).to(dev)
    faces = torch.from_numpy(tpl.faces.astype(np.int64)).to(dev)
    attrs = torch.from_numpy(rng.rand(B, F, 3, 3).astype(np.float32)).to(dev)
    dfeat = torch.from_numpy(rng.randn(B, 48, 48, 3).astype(np.float32)
                             ).to(dev)
    dsoft = torch.from_numpy(rng.randn(B, 48, 48, 1).astype(np.float32)
                             ).to(dev)
    fv = verts[:, faces]
    ref = rasterize_backward_torch(fv, attrs, dfeat, dsoft, 48, 48, 1e-3, cull)
    v = verts.clone().requires_grad_()
    a = attrs.clone().requires_grad_()
    n0 = rasterize_backward_kernel.launches
    feat, soft = rasterize(v, faces, a, 48, 48, 1e-3, cull)
    dv, da = torch.autograd.grad((feat, soft), (v, a), (dfeat, dsoft))
    torch.cuda.synchronize()
    assert rasterize_backward_kernel.launches == n0 + 1
    ref_v = torch.zeros_like(verts).index_add_(
        1, faces.reshape(-1), ref[0].reshape(B, -1, 3))
    _k4_grad_check((dv, da), (ref_v, ref[1]))


@pytest.mark.parametrize("cull,h,w,sigma,A,which", [
    (True, 64, 64, 1e-3, 3, "both"), (False, 70, 45, 1e-4, 1, "soft"),
    (False, 33, 97, 1e-4, 8, "feat"),
])
def test_k4_backward_matches_plain(dev, cull, h, w, sigma, A, which):
    """Random overlapping faces of both windings, odd tile cuts, one to
    eight attributes, one or both upstream gradients."""
    verts, faces, attrs = _scene(12, dev, A=A)
    gen = torch.Generator(dev).manual_seed(4)
    dfeat = (torch.randn((2, h, w, A), device=dev, generator=gen)
             if which != "soft" else None)
    dsoft = (torch.randn((2, h, w, 1), device=dev, generator=gen)
             if which != "feat" else None)
    fv = verts[:, faces].contiguous()
    from im23d_tpu_torch.render.rasterizer import _launch_forward

    _, soft, win, wz = _launch_forward(fv, attrs, h, w, sigma, cull, True)
    got = rasterize_backward_kernel(fv, attrs, dfeat, dsoft, soft, win, wz,
                                    h, w, sigma, cull)
    ref = rasterize_backward_torch(fv, attrs, dfeat, dsoft, h, w, sigma, cull)
    torch.cuda.synchronize()
    _k4_grad_check(got, ref)
    assert not got[0][..., 2].any()  # z only selects winners


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("kind", ["empty", "no_faces", "whole_image",
                                  "off_screen"])
def test_k4_backward_edge_scenes(dev, kind, cull):
    """Faces all off-screen, no faces, one face covering the whole image
    over random faces, faces reaching past two edges; both windings drawn
    or culled; every output written (no zeroed buffer), bit-equal between
    launches."""
    rng = np.random.RandomState(14)
    B, F, A, h, w = 2, 40, 3, 48, 40
    fv = rng.uniform(-0.9, 0.9, (B, F, 3, 3)).astype(np.float32)
    if kind == "empty":
        fv[..., 0] += 5.0
    elif kind == "no_faces":
        fv = fv[:, :0]
    elif kind == "whole_image":
        fv[:, 7, :, :2] = [[-4.0, -4.0], [4.0, -4.0], [0.0, 5.0]]
        fv[:, 7, :, 2] = -0.95
    else:
        fv[:, :20, :, 0] += 0.9
        fv[:, 20:, :, 1] -= 0.9
    fv = torch.from_numpy(fv).to(dev)
    attrs = torch.from_numpy(rng.rand(B, fv.shape[1], 3, A).astype(
        np.float32)).to(dev)
    gen = torch.Generator(dev).manual_seed(5)
    dfeat = torch.randn((B, h, w, A), device=dev, generator=gen)
    dsoft = torch.randn((B, h, w, 1), device=dev, generator=gen)
    from im23d_tpu_torch.render.rasterizer import _launch_forward

    _, soft, win, wz = _launch_forward(fv, attrs, h, w, 1e-3, cull, True)
    got = [rasterize_backward_kernel(fv, attrs, dfeat, dsoft, soft, win, wz,
                                     h, w, 1e-3, cull) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*got))
    if kind in ("empty", "no_faces"):
        assert got[0][0].shape == fv.shape and got[0][1].shape == attrs.shape
        assert not got[0][0].any() and not got[0][1].any()
    if kind == "no_faces":  # autograd of the plain version needs a face
        return
    ref = rasterize_backward_torch(fv, attrs, dfeat, dsoft, h, w, 1e-3, cull)
    _k4_grad_check(got[0], ref)
    assert _rel_l2(got[0][0], ref[0]) <= 1e-4 or not ref[0].any()
    assert _rel_l2(got[0][1], ref[1]) <= 1e-4 or not ref[1].any()


def test_render_mesh_gradients_on_the_card_match_the_cpu(dev):
    """d verts and d texture of a rendered image and soft alpha: K4 and K5
    backward against the plain path on the CPU."""
    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.render.renderer import render_mesh

    tpl = MeshTemplate(segments=16, rings=8)
    rng = np.random.RandomState(13)
    dmap = torch.from_numpy((rng.randn(2, 16, 16, 3) * 0.05).astype(
        np.float32))
    tex = torch.from_numpy(rng.rand(2, 16, 16, 3).astype(np.float32))
    w_img = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    w_a = torch.from_numpy(rng.randn(2, 64, 64, 1).astype(np.float32))

    def run(device):
        d = dmap.to(device).requires_grad_()
        t = tex.to(device).requires_grad_()
        v = tpl.get_vertex_positions(d) * 0.7
        uvs, ta = tpl.adjust_uv_and_texture(t)
        img, alpha, _ = render_mesh(v, tpl.tensor("faces", device), uvs,
                                    tpl.tensor("face_uvs", device), ta, 64, 64)
        loss = (img * w_img.to(device)).sum() + (alpha * w_a.to(device)).sum()
        return [g.cpu() for g in torch.autograd.grad(loss, (d, t))]

    got, ref = run(dev), run("cpu")
    for g, r in zip(got, ref):
        assert _rel_l2(g, r) <= 1e-4


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("shape", [(2, 64, 64, 48), (3, 8, 17, 5),
                                   (1, 64, 33, 70), (2, 16, 40, 96),
                                   (1, 128, 19, 72), (2, 8, 35, 40)])
def test_k8_matches_plain(dev, shape, pad_mode, dtype, atol):
    """Forward and dW at tile-aligned and ragged sizes, 8 to 128 input
    channels; in bfloat16 the tensor-core kernel by TMA boxes (W a
    multiple of 8) and by plain loads (W = 5, 33)."""
    gen = torch.Generator(dev).manual_seed(8)
    x = torch.randn(shape, device=dev, generator=gen).to(dtype)
    w = (torch.randn((3, shape[1], 5, 5), device=dev, generator=gen)
         * 0.05).to(dtype).float()
    b = torch.randn(3, device=dev, generator=gen) * 0.1
    n0 = head_conv_kernel.launches
    y = head_conv_kernel(x, w, b, pad_mode)
    ref = head_conv_tanh_torch(x, w, b, pad_mode)
    g = torch.randn((shape[0], 3, *shape[2:]), device=dev, generator=gen)
    d1 = head_conv_dw_kernel(x, g, pad_mode)
    d2 = head_conv_dw_kernel(x, g, pad_mode)
    dref = head_conv_dw_torch(x, g, pad_mode)
    torch.cuda.synchronize()
    assert head_conv_kernel.launches == n0 + 1
    assert y.dtype == dtype and y.shape == (shape[0], 3, *shape[2:])
    torch.testing.assert_close(y.float(), ref.float(), atol=atol, rtol=0)
    assert torch.equal(d1, d2)
    assert _rel_l2(d1, dref) <= 1e-4


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
def test_k8_bf16_unaligned_matches_plain(dev, pad_mode):
    """An x 2 bytes past a 16-byte boundary takes the plain loads; the
    kernel rounds a float32 weight to bf16 itself."""
    gen = torch.Generator(dev).manual_seed(10)
    shape = (2, 24, 30, 64)
    x = torch.empty(math.prod(shape) + 1, dtype=torch.bfloat16,
                    device=dev)[1:].view(shape)
    x.copy_(torch.randn(shape, device=dev, generator=gen))
    w = torch.randn((3, 24, 5, 5), device=dev, generator=gen) * 0.05
    b = torch.randn(3, device=dev, generator=gen) * 0.1
    assert x.data_ptr() % 16
    y = head_conv_kernel(x, w, b, pad_mode)
    ref = head_conv_tanh_torch(x, w, b, pad_mode)
    torch.testing.assert_close(y.float(), ref.float(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("shape", [(2, 64, 24, 64), (1, 64, 9, 256),
                                   (2, 32, 30, 136)])
def test_k8_dw_unaligned_matches_plain(dev, shape, pad_mode):
    """bf16 x or g 2 bytes / 4 bytes past a 16-byte boundary (the plain
    loads), and W of two and three column tiles with TMA boxes: dW
    bit-equal between launches and within relative L2 1e-4 of the float64
    plain version of the bf16-rounded upstream."""
    gen = torch.Generator(dev).manual_seed(11)
    n = math.prod(shape)
    g_shape = (shape[0], 3, *shape[2:])
    for x_off, g_off in ((0, 0), (1, 0), (0, 1)):
        x = torch.empty(n + x_off, dtype=torch.bfloat16,
                        device=dev)[x_off:].view(shape)
        x.copy_(torch.randn(shape, device=dev, generator=gen))
        g = torch.empty(math.prod(g_shape) + g_off,
                        device=dev)[g_off:].view(g_shape)
        g.copy_(torch.randn(g_shape, device=dev, generator=gen))
        d1 = head_conv_dw_kernel(x, g, pad_mode)
        d2 = head_conv_dw_kernel(x, g, pad_mode)
        ref = head_conv_dw_torch(x, g, pad_mode)
        torch.cuda.synchronize()
        assert torch.equal(d1, d2)
        assert _rel_l2(d1, ref) <= 1e-4, (x_off, g_off, _rel_l2(d1, ref))


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
def test_k8_autograd_matches_plain(dev, pad_mode):
    gen = torch.Generator(dev).manual_seed(9)
    x = torch.randn((2, 16, 24, 40), device=dev, generator=gen)
    w = torch.randn((3, 16, 5, 5), device=dev, generator=gen) * 0.1
    b = torch.randn(3, device=dev, generator=gen) * 0.1
    co = torch.randn((2, 3, 24, 40), device=dev, generator=gen)

    def grads(fn):
        args = [t.clone().requires_grad_() for t in (x, w, b)]
        return torch.autograd.grad((fn(*args, pad_mode) * co).sum(), args)

    n0 = head_conv_dw_kernel.launches
    got, ref = grads(head_conv_tanh), grads(head_conv_tanh_torch)
    assert head_conv_dw_kernel.launches == n0 + 1
    # dW against the float64 plain version (cuDNN's float32 weight
    # gradient is the less precise of the two)
    y = head_conv_tanh_torch(x, w, b, pad_mode)
    dw = head_conv_dw_torch(x, (co * (1 - y * y)).contiguous(), pad_mode)
    assert _rel_l2(got[0], ref[0]) <= 1e-5
    assert _rel_l2(got[1], dw) <= 1e-5
    assert _rel_l2(got[2], ref[2]) <= 1e-5


def test_k8_rejects_bad_operands(dev):
    x = torch.randn((1, 8, 8, 8), device=dev)
    w = torch.zeros((3, 8, 5, 5), device=dev)
    b = torch.zeros(3, device=dev)
    with pytest.raises(TypeError):
        head_conv_kernel(x.half(), w, b)
    with pytest.raises(ValueError):
        head_conv_kernel(x, w[:, :4].contiguous(), b)
    with pytest.raises(ValueError):
        head_conv_kernel(x, w, b, "reflect")
    with pytest.raises(ValueError):
        head_conv_kernel(x.cpu(), w, b)



def _k9_operands(dev, shape, affine, dtype, seed):
    B, C, H, W, cout = shape
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((B, C, H, W), device=dev, generator=gen).to(dtype)
    w = torch.randn((cout, C, 3, 3), device=dev, generator=gen) / math.sqrt(
        9 * C)
    a = b = None
    if affine:
        a = 1.0 + 0.3 * torch.randn((B, C), device=dev, generator=gen)
        b = 0.3 * torch.randn((B, C), device=dev, generator=gen)
    return x, a, b, w


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(2, 48, 16, 24, 48), (3, 64, 9, 70, 80),
                                   (4, 32, 8, 4, 64)])
def test_k9_matches_plain(dev, shape, affine, pad_mode, dtype, rtol):
    """(B, Cin, H, W, Cout): a 16-channel last stage and a partial output
    tile; W past one 64-column tile and H past its rows; blk1's 8 × 4."""
    x, a, b, w = _k9_operands(dev, shape, affine, dtype, 9)
    n0 = fused_affine_conv3x3_kernel.launches
    y = fused_affine_conv3x3_kernel(x, a, b, w, pad_mode)
    ref = fused_affine_conv3x3_torch(x, a, b, w, pad_mode)
    torch.cuda.synchronize()
    assert fused_affine_conv3x3_kernel.launches == n0 + 1
    B, _, H, W, cout = shape
    assert y.dtype == dtype and y.shape == (B, cout, H, W)
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((y.float() - ref.float()).abs().max()) <= rtol * scale


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [
    (2, 48, 20, 32, 80),    # H past its 8-row tiles, Cout 80, 16-ch stage
    (3, 32, 9, 24, 48),     # W < 64 in one 24-column tile, 10-row tiles
    (2, 32, 11, 7, 32),     # odd W: a thread per padded pixel
    (8, 16, 64, 128, 16),   # 256 tiles, more than persistent blocks
    (602, 16, 4, 8, 16),    # whole images side by side, the last tile part
    (2, 176, 16, 32, 64),   # weights streamed: 6 stages, the last of 16
    (2, 256, 8, 16, 144),   # streamed, a 16-channel last output slice
    (2, 32, 12, 40, 48),    # boxes, a last column tile of 8 of 32
    (2, 32, 20, 56, 16),    # boxes, a last column tile of 24, H partial
    (2, 32, 8, 96, 32),     # boxes, three whole column tiles
])
def test_k9_tilings_match_plain(dev, shape, affine, pad_mode, dtype, rtol):
    """(B, Cin, H, W, Cout) at the edges of the persistent kernel's plan
    (``fused_conv_plan``): partial tiles, both x loaders, resident and
    streamed weights, multi-image tiles."""
    x, a, b, w = _k9_operands(dev, shape, affine, dtype, 14)
    n0 = fused_affine_conv3x3_kernel.launches
    y = fused_affine_conv3x3_kernel(x, a, b, w, pad_mode)
    ref = fused_affine_conv3x3_torch(x, a, b, w, pad_mode)
    torch.cuda.synchronize()
    assert fused_affine_conv3x3_kernel.launches == n0 + 1
    B, _, H, W, cout = shape
    assert y.dtype == dtype and y.shape == (B, cout, H, W)
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((y.float() - ref.float()).abs().max()) <= rtol * scale


def test_k9_limits_are_the_plans(dev):
    """The kernel library's tiling constants are those that the CPU tests
    of ``fused_conv_plan`` assume (``tests/test_torch_port_k9_plan.py``)."""
    from test_torch_port_k9_plan import H100

    lim = k9_limits(dev)
    assert lim._replace(sms=0, smem_optin=0) == H100._replace(sms=0,
                                                              smem_optin=0)
    assert lim.sms >= 1 and lim.smem_optin >= 48 * 1024


@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float64])
def test_k9_takes_other_weight_types(dev, wdtype):
    """A weight that is not float32 is rounded to x's type first, as the
    plain version rounds it."""
    x, a, b, w = _k9_operands(dev, (2, 32, 16, 32, 32), True,
                              torch.bfloat16, 15)
    w = w.to(wdtype)
    y = fused_affine_conv3x3_kernel(x, a, b, w)
    ref = fused_affine_conv3x3_torch(x, a, b, w)
    scale = max(1.0, float(ref.float().abs().max()))
    assert float((y.float() - ref.float()).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
def test_k9_autograd_matches_plain(dev, pad_mode, affine):
    shape = (2, 32, 12, 40, 48)
    x, a, b, w = _k9_operands(dev, shape, affine, torch.float32, 10)
    co = torch.randn((2, 48, 12, 40), device=dev,
                     generator=torch.Generator(dev).manual_seed(11))
    inputs = [x, a, b, w] if affine else [x, w]

    def grads(fn):
        args = [t.clone().requires_grad_() for t in inputs]
        ta, tb = (args[1], args[2]) if affine else (None, None)
        y = fn(args[0], ta, tb, args[-1], pad_mode)
        return torch.autograd.grad((y * co).sum(), args)

    n0 = fused_affine_conv3x3_kernel.launches
    got = grads(fused_affine_conv3x3)
    assert fused_affine_conv3x3_kernel.launches == n0 + 1
    ref = grads(fused_affine_conv3x3_torch)
    for g, r in zip(got, ref):
        assert _rel_l2(g, r) <= 1e-4


@pytest.mark.parametrize("pad_mode", ["replicate", "circular"])
@pytest.mark.parametrize("shape", [(2, 32, 12, 40, 48), (4, 512, 8, 4, 512)])
def test_k9_bf16_autograd_matches_float64(dev, shape, pad_mode):
    """The bf16 backward, with pre exactly 0 on a quarter of channel 0's
    pixels (JAX's rule passes the gradient whole there)."""
    x, a, b, w = _k9_operands(dev, shape, True, torch.bfloat16, 12)
    b[:, 0] = 0.0
    x[:, 0, ::2, ::2] = 0.0
    B, _, H, W, cout = shape
    co = torch.randn((B, cout, H, W), device=dev,
                     generator=torch.Generator(dev).manual_seed(13))
    args = [t.clone().requires_grad_() for t in (x, a, b, w)]
    n0 = fused_affine_conv3x3_kernel.launches
    got = torch.autograd.grad(
        (fused_affine_conv3x3(*args, pad_mode).float() * co).sum(), args)
    assert fused_affine_conv3x3_kernel.launches == n0 + 1
    assert [g.dtype for g in got] == [torch.bfloat16] + [torch.float32] * 3
    args = [t.double().requires_grad_() for t in (x, a, b, w)]
    ref = torch.autograd.grad((fused_affine_conv3x3_torch(*args, pad_mode)
                               * co.double()).sum(), args)
    for g, r in zip(got, ref):
        assert _rel_l2(g.double(), r) <= 6e-3


def test_k9_rejects_bad_operands(dev):
    x, a, b, w = _k9_operands(dev, (1, 16, 8, 8, 16), True, torch.float32, 0)
    with pytest.raises(ValueError):  # dtype
        fused_affine_conv3x3_kernel(x.half(), a, b, w)
    with pytest.raises(ValueError):  # channels not a multiple of 16
        fused_affine_conv3x3_kernel(*(t[:, :8].contiguous()
                                      for t in (x, a, b, w)))
    with pytest.raises(ValueError):  # a CPU affine row with a CUDA x
        fused_affine_conv3x3(x, a.cpu(), b, w)
    with pytest.raises(ValueError):  # contiguity
        fused_affine_conv3x3_kernel(x.transpose(2, 3), a, b, w)
    with pytest.raises(ValueError):
        fused_affine_conv3x3_kernel(x, a, b, w, "reflect")


def _splat_operands(dev, S, ks=21, sigma=1.5, b=3, n=2000, seed=0):
    """Grid-coordinate planes of points partly outside the cull, keep
    weights scaled to (0, 1.5), the taps and a cotangent."""
    pts, w, _ = _points(seed, b, n, dev=dev)
    w = w * torch.rand(w.shape, device=dev,
                       generator=torch.Generator(dev).manual_seed(seed)) * 1.5
    gz, gy, gx, c = _prep_splat(pts, S, w, 1e-6)
    taps, _ = _taps_and_scale(torch.tensor(sigma, device=dev), 1.0, ks, b,
                              dev)
    g = torch.randn((b, S, S, S), device=dev,
                    generator=torch.Generator(dev).manual_seed(seed + 1))
    return gz, gy, gx, c, taps.contiguous(), g


@pytest.mark.parametrize("S", [13, 16, 32, 64])
def test_k6_matches_plain(dev, S):
    gz, gy, gx, c, _, g = _splat_operands(dev, S)
    n0, b0 = splat_kernel.launches, splat_backward_kernel.launches
    got = splat_kernel(gz, gy, gx, c, S)
    ref = splat_grid_torch(gz, gy, gx, c, S)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if S <= 16:
        assert float(ref.max()) == 1.0  # the clamp binds
    for d, r in zip(splat_backward_kernel(gz, gy, gx, c, g),
                    splat_backward_torch(gz, gy, gx, c, g)):
        assert torch.isfinite(d).all()
        assert _rel_l2(d, r) <= 1e-4, (_rel_l2(d, r), float((d - r).abs().max()))
    assert (splat_kernel.launches, splat_backward_kernel.launches) == (
        n0 + 1, b0 + 1)


def test_k6_limits_are_the_plans(dev):
    """The kernel library's constants are those that the CPU tests of
    ``splat_plan`` assume (``tests/test_torch_port_scatter_plan.py``), and
    the 3D IoU's 32³ grid fits the card's shared memory a block."""
    from test_torch_port_scatter_plan import SPLAT_H100

    lim = splat_limits(dev)
    assert lim._replace(sms=0, smem_optin=0) == SPLAT_H100._replace(
        sms=0, smem_optin=0)
    assert splat_plan(24, 32, lim)["path"] == "shared"
    assert splat_plan(480, 64, lim)["path"] == "generic"


@pytest.mark.parametrize("B,n,S,path", [
    (24, 8000, 32, "shared"),   # the eval CLI's 3D IoU, 4 CTAs a cloud
    (1, 3000, 38, "shared"),    # 8 CTAs
    (200, 500, 32, "shared"),   # 1 CTA a cloud, two waves
    (3, 2000, 13, "shared"),    # S^3 % 4 != 0: scalar stores
    (2, 0, 16, "shared"),       # no points
    (2, 4000, 39, "generic"), (4, 4000, 64, "generic"),
])
def test_k6_paths(dev, B, n, S, path):
    """K6 forward on both paths against the plain splat, weights of either
    sign (the clamp to [0, 1] binds at both ends)."""
    gen = torch.Generator(dev).manual_seed(S)
    pts = torch.rand((B, n, 3), device=dev, generator=gen) * 0.9 - 0.45
    w = torch.rand((B, n), device=dev, generator=gen) * 3.0 - 0.5
    gz, gy, gx, c = _prep_splat(pts, S, w, 1e-6)
    assert splat_plan(B, S, splat_limits(dev))["path"] == path
    n0 = splat_kernel.launches
    got = splat_kernel(gz, gy, gx, c, S)
    ref = splat_grid_torch(gz, gy, gx, c, S)
    torch.cuda.synchronize()
    assert splat_kernel.launches == n0 + 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    if n:
        assert float(ref.max()) == 1.0 and float(ref.min()) == 0.0


@pytest.mark.parametrize("S,ks,sigma,b,n", [
    (16, 9, 0.8, 3, 4000), (64, 21, 3.0, 3, 4000), (96, 21, 1.5, 3, 4000),
    (170, 21, 0.2, 3, 4000),
    (96, 21, 1.5, 1, 8000),    # the meshing CLI's shape: a plane a CTA
    (128, 21, 1.5, 1, 8000),
    (96, 21, 1.5, 0, 8000),    # no cloud
    (64, 21, 3.0, 24, 4000),   # slabs of several planes
    (64, 8, 1.0, 24, 4000),    # even K: the transpose's offset K - 1 - K/2
    (96, 16, 1.5, 1, 8000),
])
def test_k7_matches_plain(dev, S, ks, sigma, b, n):
    """K7 forward (one launch, the output written whole: no memset) and
    backward against the plain versions; the backward without dc (None)
    gives the other three outputs bit for bit."""
    gz, gy, gx, c, taps, g = _splat_operands(dev, S, ks, sigma, b=b, n=n)
    n0, b0 = splat_blur_kernel.launches, splat_blur_backward_kernel.launches
    got = splat_blur_kernel(gz, gy, gx, c, taps, S)
    ref = splat_blur_grid_torch(gz, gy, gx, c, taps, S)
    torch.cuda.synchronize()
    assert got.shape == (b, S, S, S)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    full = splat_blur_backward_kernel(gz, gy, gx, c, taps, g)
    for d, r in zip(full, splat_blur_backward_torch(gz, gy, gx, c, taps, g)):
        assert torch.isfinite(d).all()
        assert _rel_l2(d, r) <= 1e-4, (_rel_l2(d, r), float((d - r).abs().max()))
    part = splat_blur_backward_kernel(gz, gy, gx, c, taps, g, need_dc=False)
    assert part[3] is None
    assert all(torch.equal(a, f) for a, f in zip(part[:3], full[:3]))
    assert (splat_blur_kernel.launches,
            splat_blur_backward_kernel.launches) == (n0 + 1, b0 + 2)


def test_k7_limits_are_the_plans(dev):
    """The kernel library's constants are those that the CPU tests of
    ``splat_blur_plan`` assume (``tests/test_torch_port_k3_k7_plan.py``),
    and every plan up to SPLAT_BLUR_MAX_SIZE fits the card."""
    from test_torch_port_k3_k7_plan import BLUR_H100

    lim = splat_blur_limits(dev)
    assert lim._replace(sms=0, smem_optin=0) == BLUR_H100._replace(
        sms=0, smem_optin=0)
    for S in (1, 96, 128, 169, 170):
        assert splat_blur_plan(1, S, 64, lim)["smem"] <= lim.smem_optin


def _check_backward(got, ref, launches):
    """got against the plain ``ref`` (relative L2 <= 1e-4 per output), the
    same call's later ``launches`` bit-equal to it."""
    for d, r in zip(got, ref):
        assert torch.isfinite(d).all()
        assert _rel_l2(d, r) <= 1e-4, (_rel_l2(d, r),
                                       float((d - r).abs().max()))
    for again in launches:
        assert all(torch.equal(a, d) for a, d in zip(again, got))


def _tile_edge_clouds(dev, S, b, n, plan, seed, signed=True):
    """b clouds of n points: weights uniform in (-1.5, 1.5) (or (0, 1.5):
    the backward's fixed-point splat; a negative weight makes a tile add
    floats), a quarter of
    the points exactly on the z-planes where a tile or its halo begins
    (and on the rows where a band begins), a few past the grid's edges
    (culled: weight 0, gathered with dc at their clamped corners); the
    last cloud's weights all 0."""
    gen = torch.Generator(dev).manual_seed(seed)
    pts = torch.rand((b, n, 3), device=dev, generator=gen) * 1.1 - 0.55
    edges = torch.arange(0, S, plan["planes"], device=dev)
    k = n // 4
    pick = torch.randint(0, edges.numel(), (b, k), device=dev, generator=gen)
    pts[:, :k, 0] = edges[pick] / (S - 1) - 0.5
    if plan["bands"] > 1:
        rows = torch.arange(0, S, plan["rows"], device=dev)
        pick = torch.randint(0, rows.numel(), (b, k), device=dev,
                             generator=gen)
        pts[:, :k, 1] = rows[pick] / (S - 1) - 0.5
    w = torch.rand((b, n), device=dev, generator=gen) * 3.0 - 1.5
    if not signed:
        w = w.abs()
    w[-1] = 0.0
    return _prep_splat(pts, S, w, 1e-6)


@pytest.mark.parametrize("S", [16, 40, 96])
def test_k6_k7_mixed_sign_weights(dev, S):
    """Weights uniform in (-1.5, 1.5): the splat's clamp binds at both 0
    and 1.  K7 forward against the plain version, K6 and K7 backward
    against autograd of the plain versions (the clamp's mask
    0 <= raw <= 1), K7's at K = 21, 8 and 16, on clouds with points on
    the backward tiles' edges and a cloud of zero weights (the tiles with
    a negative weight add floats, in an order that varies); each backward
    also without dc (None)."""
    gen = torch.Generator(dev).manual_seed(100 + S)
    pts = torch.rand((2, 3000, 3), device=dev, generator=gen) * 0.9 - 0.45
    w = torch.rand((2, 3000), device=dev, generator=gen) * 3.0 - 1.5
    gz, gy, gx, c = _prep_splat(pts, S, w, 1e-6)
    taps, _ = _taps_and_scale(torch.tensor(1.5, device=dev), 1.0, 21, 2, dev)
    taps = taps.contiguous()
    g = torch.randn((2, S, S, S), device=dev, generator=gen)
    raw = splat_sum(torch.stack((gz, gy, gx), -1), c, S)
    assert float(raw.min()) < 0.0 < 1.0 < float(raw.max())
    got = splat_blur_kernel(gz, gy, gx, c, taps, S)
    ref = splat_blur_grid_torch(gz, gy, gx, c, taps, S)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    for kernel, plain in (
            (splat_blur_backward_kernel(gz, gy, gx, c, taps, g),
             splat_blur_backward_torch(gz, gy, gx, c, taps, g)),
            (splat_backward_kernel(gz, gy, gx, c, g),
             splat_backward_torch(gz, gy, gx, c, g))):
        for d, r in zip(kernel, plain):
            assert torch.isfinite(d).all()
            assert _rel_l2(d, r) <= 1e-4, (_rel_l2(d, r),
                                           float((d - r).abs().max()))
    lim = splat_blur_limits(dev)
    for ks in (0, 21, 8, 16):
        plan = splat_backward_plan(3, S, ks, lim)
        ops = _tile_edge_clouds(dev, S, 3, 3000, plan, S + ks)
        g3 = torch.randn((3, S, S, S), device=dev, generator=gen)
        if ks:
            taps, _ = _taps_and_scale(torch.tensor(1.5, device=dev), 1.0, ks,
                                      3, dev)
            taps = taps.contiguous()
            run = functools.partial(splat_blur_backward_kernel, *ops, taps,
                                    g3)
            ref = splat_blur_backward_torch(*ops, taps, g3)
        else:
            run = functools.partial(splat_backward_kernel, *ops, g3)
            ref = splat_backward_torch(*ops, g3)
        got = run()
        _check_backward(got, ref, [])
        part = run(need_dc=False)
        assert part[3] is None
        _check_backward(part[:3], ref[:3], [])
        assert not got[0][-1].any() and got[3][-1].abs().sum() > 0


@pytest.mark.parametrize("S,ks,b,n,signed", [
    (16, 0, 1, 40000, False),  # 7,500 listed points a tile: the list
    (16, 21, 1, 40000, True),  # overflows, the tile scans by chunks
    (200, 0, 2, 4000, False),  # K6 at 200^3: bands of rows
    (170, 21, 1, 8000, True),  # K7 at 170^3: two bands
    (170, 8, 1, 8000, False),
    (16, 0, 3, 3000, False),   # the fixed-point splat on the tiles' edges
    (40, 16, 3, 3000, False),
    (96, 21, 2, 8000, False),
])
def test_k6_k7_backward_tiles(dev, S, ks, b, n, signed):
    """K6 / K7 backward where the plan or the data leave the common path:
    bands of rows (a halo row), a point list past its capacity (chunked
    rescans), points on the tiles' edges with weights >= 0 (fixed point)
    or of either sign (floats), with and without dc, bit-equal launches."""
    lim = splat_blur_limits(dev)
    plan = splat_backward_plan(b, S, ks, lim)
    assert plan["smem"] <= lim.smem_optin
    if S > 128:
        assert plan["bands"] > 1
    ops = _tile_edge_clouds(dev, S, b + 1, n, plan, S + ks, signed)
    g = torch.randn((b + 1, S, S, S), device=dev,
                    generator=torch.Generator(dev).manual_seed(S))
    if ks:
        taps, _ = _taps_and_scale(torch.tensor(1.5, device=dev), 1.0, ks,
                                  b + 1, dev)
        taps = taps.contiguous()
        run = functools.partial(splat_blur_backward_kernel, *ops, taps, g)
        ref = splat_blur_backward_torch(*ops, taps, g)
    else:
        run = functools.partial(splat_backward_kernel, *ops, g)
        ref = splat_backward_torch(*ops, g)
    got = run()
    _check_backward(got, ref, [] if signed else [run()])
    part = run(need_dc=False)
    assert part[3] is None
    assert all(torch.equal(a, f) for a, f in zip(part[:3], got[:3]))


def test_k6_k7_backward_float_range(dev):
    """Weights past the fixed point's range (n max|w| >= 2^15 in a tile):
    the tile sums in float, against the plain version."""
    gen = torch.Generator(dev).manual_seed(3)
    pts = torch.rand((2, 2000, 3), device=dev, generator=gen) * 0.9 - 0.45
    w = torch.rand((2, 2000), device=dev, generator=gen) * 3.0 - 1.5
    w[:, :10] = 3.0e4
    gz, gy, gx, c = _prep_splat(pts, 24, w, 1e-6)
    g = torch.randn((2, 24, 24, 24), device=dev, generator=gen)
    taps, _ = _taps_and_scale(torch.tensor(1.5, device=dev), 1.0, 21, 2, dev)
    taps = taps.contiguous()
    _check_backward(splat_backward_kernel(gz, gy, gx, c, g),
                    splat_backward_torch(gz, gy, gx, c, g), [])
    _check_backward(splat_blur_backward_kernel(gz, gy, gx, c, taps, g),
                    splat_blur_backward_torch(gz, gy, gx, c, taps, g), [])


def test_splat_autograd_runs_k6_and_k7(dev):
    """trilinear_splat and splat_blur with grad on the card (K6, K7 and
    their backward) against the plain paths' autograd on the CPU: values,
    and the gradients of the points, the weights and the scale."""
    pts, w, scale = _points(7, 2, 1500, dev=dev)
    w = w * 0.8
    g6 = torch.randn((2, 24, 24, 24), device=dev)
    g7 = torch.randn((2, 40, 40, 40), device=dev)
    runs = {}
    for where in (dev, torch.device("cpu")):
        p, wt, sc = (t.detach().to(where).requires_grad_()
                     for t in (pts, w, scale))
        v6 = trilinear_splat(p, 24, wt)
        v7 = splat_blur(p, 40, 1.1, sc, wt)
        ((v6 * g6.to(where)).sum() + (v7 * g7.to(where)).sum()).backward()
        runs[where.type] = [t.detach().cpu() for t in
                            (v6, v7, p.grad, wt.grad, sc.grad)]
    for got, ref in zip(runs["cuda"], runs["cpu"]):
        assert _rel_l2(got, ref) <= 1e-4, _rel_l2(got, ref)


def test_splat_autograd_skips_dc_for_constant_weights(dev, monkeypatch):
    """With weights that need no gradient, autograd of trilinear_splat and
    splat_blur asks K6 and K7 backward for no dc; the points' gradients
    are those of a run that does need the weights' (bit for bit)."""
    from im23d_tpu_torch.ops import splat as sp

    asked = []
    for name in ("splat_backward_kernel", "splat_blur_backward_kernel"):
        real = getattr(sp, name)

        def spy(*args, need_dc=True, _real=real):
            asked.append(need_dc)
            return _real(*args, need_dc=need_dc)

        spy.launches = 0  # the wrapper counts on the module's name
        monkeypatch.setattr(sp, name, spy)
    pts, w, _ = _points(9, 2, 1500, dev=dev)
    scale = torch.full((2,), 0.5, device=dev)  # the last clip never binds
    g6 = torch.randn((2, 24, 24, 24), device=dev)
    g7 = torch.randn((2, 40, 40, 40), device=dev)
    grads = []
    for weights_grad in (True, False):
        p = pts.detach().clone().requires_grad_()
        wt = w.detach().clone().requires_grad_(weights_grad)
        v = ((trilinear_splat(p, 24, wt) * g6).sum()
             + (splat_blur(p, 40, 1.1, scale, wt) * g7).sum())
        v.backward()
        grads.append(p.grad)
    assert asked == [True, True, False, False]
    assert torch.equal(grads[0], grads[1])


def test_k6_k7_reject_bad_operands(dev):
    gz, gy, gx, c, taps, g = _splat_operands(dev, 16, b=2, n=64)
    with pytest.raises(TypeError):
        splat_kernel(gz.double(), gy, gx, c, 16)
    with pytest.raises(ValueError):
        splat_blur_kernel(gz, gy, gx, c, taps, 171)
    with pytest.raises(ValueError):
        splat_blur(torch.zeros((1, 8, 3), device=dev), 171, 1.0, 1.0)
    with pytest.raises(ValueError):
        splat_backward_kernel(gz, gy, gx, c, g[:, :8].contiguous())
    with pytest.raises(ValueError):
        splat_blur_kernel(gz.cpu(), gy, gx, c, taps, 16)
