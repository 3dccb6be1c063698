"""Rendering-free projection ops, plain PyTorch (counterpart of
``im23d_tpu/ops/voxel.py``).

Trilinear point splat into an S³ grid, separable Gaussian blur (band-matrix
matmuls), ray-termination probabilities and the depth-sum silhouette with its
vertical flip.  This chain is the plain version that the CUDA projection
kernel (``ops/projection.py``, ``csrc/projection.cu``) is held to.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops.camera import world_to_camera


def _corner_offsets(device) -> torch.Tensor:
    """(8, 3) binary corner offsets of the unit cube."""
    return torch.tensor(
        [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
        dtype=torch.int64, device=device,
    )


def splat_sum(coords: torch.Tensor, weights: torch.Tensor, size: int,
              z_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter (B, N, 3) grid coordinates (z, y, x) in [0, S-1] into a
    (B, S, S, S) grid by trilinear weights times ``weights`` (B, N), not
    clamped.  Corner indices are clamped to the grid: zero-weight points
    may lie anywhere.  ``z_keep`` (B, N, 2), where given, also multiplies
    each point's corners at z offset 0 and 1."""
    B = coords.shape[0]
    S = int(size)
    base = torch.floor(coords)
    frac = coords - base
    base_i = base.to(torch.int64)

    offs = _corner_offsets(coords.device)
    offs_f = offs.to(coords.dtype)
    f = frac[:, :, None, :]
    cw = torch.prod(f * offs_f + (1.0 - f) * (1.0 - offs_f), dim=-1)
    cw = cw * weights[:, :, None]  # (B, N, 8)
    if z_keep is not None:
        cw = cw * z_keep[:, :, offs[:, 0]]

    idx = (base_i[:, :, None, :] + offs).clamp(0, S - 1)
    flat = (idx[..., 0] * S + idx[..., 1]) * S + idx[..., 2]
    flat = flat + (torch.arange(B, device=coords.device) * S**3)[:, None, None]
    vox = torch.zeros(B * S**3, dtype=coords.dtype, device=coords.device)
    vox = vox.index_add(0, flat.reshape(-1), cw.reshape(-1))
    return vox.reshape(B, S, S, S)


def splat_grid(coords: torch.Tensor, weights: torch.Tensor,
               size: int) -> torch.Tensor:
    """``splat_sum`` clamped to [0, 1]."""
    return splat_sum(coords, weights, size).clamp(0.0, 1.0)


def trilinear_splat(
    points: torch.Tensor,
    size: int,
    weights: torch.Tensor | None = None,
    border_eps: float = 1e-6,
) -> torch.Tensor:
    """Scatter (B, N, 3) (z, y, x) points in [-0.5, 0.5] into a (B, S, S, S)
    grid by trilinear weights; points with any |coord| >= 0.5 - eps are
    culled, ``weights`` (B, N) multiply each point.  Clamped to [0, 1]."""
    in_bounds = torch.all(
        (points > -0.5 + border_eps) & (points < 0.5 - border_eps), dim=-1
    )
    w_point = in_bounds.to(points.dtype)
    if weights is not None:
        w_point = w_point * weights
    return splat_grid((int(size) - 1) * (points + 0.5), w_point, size)


def gaussian_kernel_1d(sigma, kernel_size: int = 21) -> torch.Tensor:
    """Normalized 1-D Gaussian taps of static length; ``sigma`` may be a
    device tensor (the taps then live on its device)."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    half = kernel_size // 2
    x = torch.arange(-(kernel_size - 1 - half), half + 1,
                     dtype=torch.float32, device=sigma.device)
    k = torch.exp(-(x**2) / (2.0 * sigma**2))
    return k / torch.sum(k)


def _band_matrix(kernel: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size) Toeplitz M with M[j, i] = kernel[j - i + half]: ``x @ M``
    is the zero-padded 'same' cross-correlation of each row with ``kernel``."""
    K = kernel.shape[0]
    half = K // 2
    ar = torch.arange(size, device=kernel.device)
    d = ar[:, None] - ar[None, :] + half
    valid = (d >= 0) & (d < K)
    taps = kernel[d.clamp(0, K - 1)]
    return torch.where(valid, taps, torch.zeros_like(taps))


def blur_3d(voxels: torch.Tensor, taps: torch.Tensor,
            scale: torch.Tensor | None = None,
            axes: tuple[int, ...] = (3, 2, 1)) -> torch.Tensor:
    """Separable blur of (B, Z, Y, X) by the 1-D ``taps`` along ``axes``
    (x, y, z by default; zero-padded 'same' correlation), then the optional
    per-cloud ``scale`` multiply and clamp to [0, 1]."""
    out = voxels
    for axis in axes:
        band = _band_matrix(taps, voxels.shape[axis]).to(out.dtype)
        out = torch.matmul(out.movedim(axis, -1), band).movedim(-1, axis)
    if scale is not None:
        out = (out * scale.reshape(-1, 1, 1, 1)).clamp(0.0, 1.0)
    return out


def gaussian_blur_3d(
    voxels: torch.Tensor,
    sigma,
    kernel_size: int = 21,
    scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Separable 3-D Gaussian blur along x, y, z of (B, Z, Y, X), then the
    optional per-cloud ``scale`` multiply and clamp to [0, 1]."""
    k = gaussian_kernel_1d(sigma, kernel_size).to(voxels.device)
    return blur_3d(voxels, k, scale)


def termination_probs(voxels: torch.Tensor,
                      epsilon: float = 1e-5) -> torch.Tensor:
    """(B, Z, Y, X) occupancies -> (B, Z+1, Y, X) ray termination
    probabilities, with the epsilon-filled (not zero) leading plane."""
    o = voxels.clamp(epsilon, 1.0 - epsilon)
    log_vac = torch.log1p(-o)
    log_occ = torch.log(o)
    cum = torch.cumsum(log_vac, dim=1)
    eps_plane = torch.full_like(o[:, :1], epsilon)
    r1 = torch.cat([eps_plane, cum], dim=1)
    r2 = torch.cat([log_occ, eps_plane], dim=1)
    return torch.exp(r1 + r2)


def project_silhouette(probs: torch.Tensor) -> torch.Tensor:
    """Depth-sum of termination probs (background cell dropped) + vertical
    flip of the (B, Y, X) result along Y."""
    return torch.flip(torch.sum(probs[:, :-1], dim=1), dims=(1,))


def point_cloud_to_silhouette(
    point_cloud: torch.Tensor,
    rotation: torch.Tensor,
    sigma,
    scale: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    voxel_size: int = 64,
    kernel_size: int = 21,
) -> torch.Tensor:
    """Camera transform -> splat -> blur -> termination -> (B, S, S)."""
    cam = world_to_camera(point_cloud, rotation)
    vox = trilinear_splat(cam, voxel_size, weights=weights)
    smooth = gaussian_blur_3d(vox, sigma, kernel_size=kernel_size, scale=scale)
    return project_silhouette(termination_probs(smooth))
