"""CUDA kernels K1, K2, K3, K4 and K5 of the PyTorch port against their
plain versions.

Needs a CUDA device: every test here is marked ``cuda`` and skips without
one.  Imports no JAX, so it runs where JAX is not installed; the repository's
``tests/conftest.py`` imports JAX, hence the command on a GPU machine, from
the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_kernels.py

Tolerances: K1 sums with atomicAdd (order changes between runs) and blurs in
another order than the plain band matmul, atol 1e-5 on silhouettes <= ~1;
K2 is held by relative L2 error per output, ||kernel - plain|| / ||plain||
<= 1e-4, because a clamp mask within rounding of its bound can flip and move
a few gradients by O(1) of their value; K3 computes the plain formula, up to
FMA contraction, rtol 1e-5; K4 computes the plain rasterizer's
arithmetic with FMA contraction ruled out: feat by the 0.999 quantile of
|kernel - plain| <= 1e-5 (an edge function rounded to the other side would
move a boundary pixel to the other face), soft atol 1e-5 (its log1p terms
are summed in another order); K5 is bit-equal to the plain gather.

The backward kernels are held to the autograd of the plain forwards.  K5's
backward by relative L2 per output (d img sums by atomicAdd in another
order; d grid differs from autograd in the order of its additions): 1e-5,
and the set of texels with d img > 0 exactly (pseudo-GT visibility tests
> 0).  K4's backward by the limits of the JAX package's rasterizer gradient
test (``tests/test_rasterizer_pallas.py:76-80``): max |d verts| error
< 1e-3 x max(max |d verts|, 1), max |d attrs| error < 1e-4 x
max(max |d attrs|, 1), read on the per-corner gradients d fv: per-face
sums by atomicAdd in another order, the segment-parameter chain that
vanishes at the nearest point dropped, and d log_miss taken from 1 − soft.
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
    _prep_projection,
    _taps_and_scale,
    projection_backward_kernel,
    projection_backward_torch,
    projection_kernel,
    projection_silhouette,
    projection_silhouette_reuse,
    projection_silhouette_torch,
)
from im23d_tpu_torch.ops.sampling import (
    grid_sample_bilinear,
    grid_sample_bilinear_backward_kernel,
    grid_sample_bilinear_backward_torch,
    grid_sample_bilinear_kernel,
    grid_sample_bilinear_torch,
)
from im23d_tpu_torch.render.rasterizer import (
    rasterize,
    rasterize_backward_kernel,
    rasterize_backward_torch,
    rasterize_kernel,
    rasterize_torch,
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
        torch.cuda.synchronize()
        _check_k4(got, ref)
        assert torch.equal(got[0][..., 0] != 0, ref[0][..., 0] != 0)


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
