"""Gradients of the projection (kernel K2's module) of the PyTorch port
against JAX.

On the CPU ``projection_silhouette`` differentiates its plain chain with
autograd, and ``projection_backward_torch`` (the plain version of K2) is the
VJP of that chain in grid coordinates.  They are held, at B=2, N=160 (256 in
grid coordinates), S=16, kernel_size 9, with dropout weights and culled
points, to ``jax.grad`` of the JAX XLA chain and of the Pallas kernels
``projection_silhouette_pallas`` / ``_proj_grid`` / ``_proj_sorted_grid``
(interpret mode, ``dot_bf16=False``).  Tolerance: atol 1e-4 * max|ref| and
rtol 1e-4 per output (read: at most 1.1e-6 of max|ref|), for float32 sums
over a few thousand voxels taken in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from im23d_tpu.ops.splat_pallas import (
    _proj_grid,
    _proj_sorted_grid,
    _projection_band,
    projection_silhouette_pallas,
    projection_silhouette_products,
    projection_silhouette_reuse as j_reuse,
)
from im23d_tpu.ops.voxel import (
    gaussian_blur_3d,
    project_silhouette,
    termination_probs,
    trilinear_splat,
)
from im23d_tpu_torch.ops.projection import (
    _prep_projection,
    _taps_and_scale,
    projection_backward_torch,
    projection_silhouette,
    projection_silhouette_reuse,
    projection_silhouette_torch,
)

B, N, S, KS = 2, 160, 16, 9
SIGMA = 0.8
EPS = 1e-5


def _inputs(seed=11, n=N):
    rng = np.random.RandomState(seed)
    pts = ((rng.rand(B, n, 3) - 0.5) * 1.1).astype(np.float32)  # some culled
    w = (rng.rand(B, n) > 0.3).astype(np.float32)
    scale = (0.5 + rng.rand(B) * 1.5).astype(np.float32)
    cot = rng.randn(B, S, S).astype(np.float32)
    return pts, w, scale, cot


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


def _jax_xla(p, s, w):
    v = gaussian_blur_3d(trilinear_splat(p, S, weights=w), jnp.float32(SIGMA),
                         kernel_size=KS, scale=s)
    return project_silhouette(termination_probs(v))


def _jax_pallas(sorted_blocks):
    def f(p, s, w):
        return projection_silhouette_pallas(
            p, S, jnp.float32(SIGMA), s, weights=w, kernel_size=KS,
            dot_bf16=False, sorted_blocks=sorted_blocks,
            need_weight_grad=False)
    return f


@pytest.mark.parametrize("reference", ["xla", "pallas_dense", "pallas_sorted"])
def test_projection_gradients_match_jax(reference):
    pts, w, scale, cot = _inputs()
    fn = {"xla": _jax_xla, "pallas_dense": _jax_pallas(False),
          "pallas_sorted": _jax_pallas(True)}[reference]
    jw = jnp.asarray(w)
    ref_p, ref_s = jax.grad(
        lambda p, s: jnp.sum(fn(p, s, jw) * cot), argnums=(0, 1)
    )(jnp.asarray(pts), jnp.asarray(scale))

    p = torch.from_numpy(pts).requires_grad_()
    s = torch.from_numpy(scale).requires_grad_()
    sil = projection_silhouette(p, S, torch.tensor(SIGMA), s,
                                weights=torch.from_numpy(w), kernel_size=KS)
    (sil * torch.from_numpy(cot)).sum().backward()
    _close(p.grad.numpy(), ref_p)
    _close(s.grad.numpy(), ref_s)
    assert np.abs(np.asarray(ref_p)).max() > 0


@pytest.mark.parametrize("sorted_blocks", [False, True])
def test_backward_plain_matches_pallas_k2(sorted_blocks):
    """The plain K2 against the TPU backward kernels on the same grid
    coordinates (N = 256: no lane padding on the JAX side)."""
    pts, w, scale, cot = _inputs(5, n=256)
    gz, gy, gx, c = _prep_projection(torch.from_numpy(pts), S,
                                     torch.from_numpy(w), 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(SIGMA), torch.from_numpy(scale),
                               KS, B, gz.device)
    got = projection_backward_torch(gz, gy, gx, c, taps, sc,
                                    torch.from_numpy(cot), EPS)

    band = _projection_band(jnp.float32(SIGMA), S, KS)
    cj = jnp.asarray(c.numpy())

    def f(gz_, gy_, gx_, s_):
        if sorted_blocks:
            return _proj_sorted_grid(gz_, gy_, gx_, cj, band, s_, S, False,
                                     EPS, False)
        return _proj_grid(gz_, gy_, gx_, cj, band, s_, S, False, EPS)

    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (gz, gy, gx)),
                     jnp.asarray(scale))
    ref = vjp(jnp.asarray(cot))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_backward_plain_matches_autograd_of_points():
    """d points = (S - 1) * safe * d(gz, gy, gx) through the prep."""
    pts, w, scale, cot = _inputs(3)
    p = torch.from_numpy(pts).requires_grad_()
    s = torch.from_numpy(scale).requires_grad_()
    wt = torch.from_numpy(w)
    sil = projection_silhouette_torch(p, S, torch.tensor(SIGMA), s,
                                      weights=wt, kernel_size=KS)
    (sil * torch.from_numpy(cot)).sum().backward()

    gz, gy, gx, c = _prep_projection(p.detach(), S, wt, 1e-6)
    taps, sc = _taps_and_scale(torch.tensor(SIGMA), s.detach(), KS, B,
                               gz.device)
    dgz, dgy, dgx, dscale = projection_backward_torch(
        gz, gy, gx, c, taps, sc, torch.from_numpy(cot))
    safe = (c > 0).float()
    want = torch.stack([dgz, dgy, dgx], dim=-1) * (S - 1) * safe[..., None]
    torch.testing.assert_close(p.grad, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(s.grad, dscale, rtol=1e-5, atol=1e-7)
    assert bool((want[c == 0] == 0).all())


def test_reuse_returns_sweep_value_with_fresh_gradient():
    """The winner reuse: value = the sweep's rows exactly, gradient = a fresh
    projection's; and both agree with the JAX reuse (interpret mode)."""
    rng = np.random.RandomState(7)
    n_sweep, rows = 4, [2, 0, 3]
    pts = ((rng.rand(n_sweep, N, 3) - 0.5) * 1.1).astype(np.float32)
    w = (rng.rand(n_sweep, N) > 0.3).astype(np.float32)
    scale = (rng.rand(n_sweep) * 0.5 + 0.5).astype(np.float32)
    cot = rng.rand(len(rows), S, S).astype(np.float32)
    sig = torch.tensor(0.6)
    with torch.no_grad():
        sweep = projection_silhouette(torch.from_numpy(pts), S, sig,
                                      torch.from_numpy(scale),
                                      weights=torch.from_numpy(w),
                                      kernel_size=KS)
    p_r, w_r, s_r = pts[rows], torch.from_numpy(w[rows]), scale[rows]

    def grads(reuse: bool):
        p = torch.from_numpy(p_r).requires_grad_()
        s = torch.from_numpy(s_r).requires_grad_()
        if reuse:
            out = projection_silhouette_reuse(p, S, sig, s, sweep[rows],
                                              weights=w_r, kernel_size=KS)
        else:
            out = projection_silhouette(p, S, sig, s, weights=w_r,
                                        kernel_size=KS)
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach(), p.grad, s.grad

    out_r, gp_r, gs_r = grads(True)
    out_f, gp_f, gs_f = grads(False)
    assert torch.equal(out_r, sweep[rows])
    torch.testing.assert_close(out_r, out_f, rtol=0, atol=1e-6)
    torch.testing.assert_close(gp_r, gp_f, rtol=0, atol=1e-6)
    torch.testing.assert_close(gs_r, gs_f, rtol=0, atol=1e-6)
    sel = sweep[rows]
    with torch.no_grad():  # no gradient wanted: the sweep's rows as they are
        assert projection_silhouette_reuse(
            torch.from_numpy(p_r), S, sig, torch.from_numpy(s_r), sel,
            weights=w_r, kernel_size=KS) is sel

    sil_j, prods = projection_silhouette_products(
        jnp.asarray(pts), S, jnp.float32(0.6), jnp.asarray(scale),
        weights=jnp.asarray(w), kernel_size=KS, dot_bf16=False)
    idx = jnp.asarray(rows)

    def f(p, s):
        out = j_reuse(p, S, jnp.float32(0.6), s,
                      jax.lax.stop_gradient(sil_j[idx]),
                      tuple(jax.lax.stop_gradient(a[idx]) for a in prods),
                      weights=jnp.asarray(w[rows]), kernel_size=KS,
                      dot_bf16=False)
        return jnp.sum(out * cot)

    ref_p, ref_s = jax.grad(f, argnums=(0, 1))(jnp.asarray(p_r),
                                               jnp.asarray(s_r))
    _close(out_r.numpy(), np.asarray(sil_j)[rows])
    _close(gp_r.numpy(), ref_p)
    _close(gs_r.numpy(), ref_s)
