"""Synthetic multi-view silhouette data for smoke tests and benchmarks.

A NumPy-only copy of ``im23d_tpu/data/synthetic.py``: the port cannot
import the JAX package (its ``data`` package imports ``jax``), and the same
seed must give the same batches on both sides.

The real ShapeNet renders are large external assets; this generator produces
batches with identical shapes and statistics: random convex point clouds
(boxes/ellipsoids) projected to ground-truth silhouettes by a NumPy twin of
the rendering-free projection pipeline (``ops/voxel.py``), under random view
quaternions.
"""

from __future__ import annotations

import numpy as np


def _np_qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate (M, N, 3) points by unit wxyz quaternions (M, 4) — NumPy twin
    of ``ops.quaternion.qrot``."""
    u = q[:, None, 1:4]
    w = q[:, None, :1]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def _np_band_matrix(kernel: np.ndarray, size: int) -> np.ndarray:
    """(size, size) banded Toeplitz, twin of ``ops.voxel._band_matrix``."""
    K = kernel.shape[0]
    half = K // 2
    j, i = np.indices((size, size))
    d = j - i + half
    valid = (d >= 0) & (d < K)
    return np.where(valid, kernel[np.clip(d, 0, K - 1)], 0.0).astype(np.float32)


def render_silhouettes_np(
    pc: np.ndarray,
    quats: np.ndarray,
    sigma: float,
    voxel_size: int,
    kernel_size: int = 9,
    out_size: int | None = None,
) -> np.ndarray:
    """NumPy twin of ``ops.voxel.point_cloud_to_silhouette`` (+ optional
    bilinear upsample to ``out_size``), for host-side data generation.

    pc: (M, N, 3) points, (z, y, x) order in [-0.5, 0.5]^3; quats: (M, 4)
    wxyz (normalized internally).  Returns (M, S, S) silhouettes in [0, 1].
    """
    pc = np.asarray(pc, np.float32)
    q = np.asarray(quats, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    cam = _np_qrot(q, pc)
    z = cam[..., 0]
    persp = np.float32(1.875) / (z + np.float32(2.0))
    zyx = np.stack([z, cam[..., 1] * persp, cam[..., 2] * persp], -1)

    M, N, _ = zyx.shape
    S = int(voxel_size)
    grid = (S - 1) * (zyx + 0.5)
    base = np.floor(grid)
    frac = grid - base
    bi = base.astype(np.int64)
    in_b = np.all((zyx > -0.5 + 1e-6) & (zyx < 0.5 - 1e-6), axis=-1)
    offs = np.asarray(
        [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
        np.int64,
    )
    offs_f = offs.astype(np.float32)
    cw = np.prod(
        frac[:, :, None, :] * offs_f
        + (1.0 - frac[:, :, None, :]) * (1.0 - offs_f),
        axis=-1,
    ) * in_b.astype(np.float32)[:, :, None]
    idx = np.clip(bi[:, :, None, :] + offs[None, None], 0, S - 1)
    flat = (idx[..., 0] * S + idx[..., 1]) * S + idx[..., 2]
    flat = flat + (np.arange(M, dtype=np.int64) * S**3)[:, None, None]
    vox = np.zeros(M * S**3, np.float32)
    np.add.at(vox, flat.reshape(-1), cw.reshape(-1))
    vox = np.clip(vox.reshape(M, S, S, S), 0.0, 1.0)

    half = kernel_size // 2
    x = np.arange(-(kernel_size - 1 - half), half + 1, dtype=np.float32)
    k = np.exp(-(x**2) / (2.0 * np.float32(sigma) ** 2))
    k /= k.sum()
    band = _np_band_matrix(k, S)
    # Separable blur as three BLAS matmuls ((M,Z,Y,X) viewed with the blur
    # axis as a matrix dim); moveaxis copies of the 126 MB grid cost ~5x the
    # matmuls themselves.
    out = (vox.reshape(M * S * S, S) @ band).reshape(M, S, S, S)        # x
    out = np.matmul(band.T[None], out.reshape(M * S, S, S))             # y
    out = np.matmul(band.T[None], out.reshape(M, S, S * S))             # z
    out = out.reshape(M, S, S, S)

    # Termination probs via cumprod: sil = sum_z o_z * prod_{k<z}(1 - o_k)
    # (plus the reference's eps-plane factor e^eps on z=0) — algebraically
    # identical to ops.voxel.termination_probs' exp(log...) form but with
    # one cumprod pass instead of four transcendental passes (9.2 s -> 0.5 s
    # per chairs pool batch).
    eps = np.float32(1e-5)
    o = np.clip(out, eps, 1.0 - eps)
    c = np.cumprod(1.0 - o, axis=1)
    fac = np.concatenate(
        [np.full_like(o[:, :1], np.exp(eps)), c[:, :-1]], axis=1
    )
    sil = np.clip(np.flip((o * fac).sum(axis=1), axis=1), 0.0, 1.0)

    if out_size is not None and out_size != S:
        # bilinear upsample, align_corners=True (twin of resize_bilinear),
        # factored into two matmuls (the one-shot einsum contraction is
        # ~70x slower)
        pos = np.linspace(0.0, S - 1.0, out_size, dtype=np.float32)
        r = np.maximum(
            0.0, 1.0 - np.abs(pos[:, None] - np.arange(S, dtype=np.float32))
        )
        sil = (sil.reshape(M * S, S) @ r.T).reshape(M, S, out_size)
        sil = np.matmul(r[None], sil).astype(np.float32)
    return sil


def _random_unit_quats(rng: np.random.RandomState, n: int) -> np.ndarray:
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _random_shapes(rng: np.random.RandomState, batch: int, n_points: int) -> np.ndarray:
    """Random axis-aligned boxes or ellipsoid surfaces in [-0.35, 0.35]^3."""
    clouds = np.empty((batch, n_points, 3), np.float32)
    for b in range(batch):
        if rng.rand() < 0.5:
            half = rng.uniform(0.08, 0.3, size=3)
            pts = rng.uniform(-1, 1, size=(n_points, 3)) * half
            ax = rng.randint(3, size=n_points)
            pts[np.arange(n_points), ax] = (
                np.sign(pts[np.arange(n_points), ax] + 1e-9) * half[ax]
            )
        else:
            v = rng.randn(n_points, 3)
            v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9
            pts = v * rng.uniform(0.1, 0.3, size=3)
        clouds[b] = pts
    return clouds


class SyntheticSilhouettes:
    """Infinite generator of ShapeNet-shaped batches.

    Yields dict(images (B,H,W,3), pose_input (B*V,H,W,3), masks (B*V,H,W)):
    'images' are silhouettes rendered at the image resolution broadcast to 3
    channels (stand-ins for RGB renders), pose_input are the V view
    silhouettes (camera-less mode), masks the V ground-truth masks.
    """

    def __init__(self, batch_size: int, image_size: int = 128, num_views: int = 5,
                 n_points: int = 512, seed: int = 0, sigma: float = 1.2,
                 uint8: bool = True):
        self.uint8 = uint8
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_views = num_views
        self.n_points = n_points
        self.sigma = sigma
        self._rng = np.random.RandomState(seed)

        def render(pc, q):
            # kernel 9 covers +-4.5 cells: exact to ~1e-4 at sigma <= 1.2.
            # Pure NumPy (see module docstring): no XLA compile, no device
            # round trip — the projection runs at voxel S = image_size // 2
            # and is upsampled to the image resolution, mimicking renders.
            return render_silhouettes_np(
                pc, q, self.sigma, voxel_size=self.image_size // 2,
                kernel_size=9, out_size=self.image_size,
            )

        self._render = render

    def next_batch(self, return_gt: bool = False) -> dict:
        """One batch; ``return_gt`` adds the ground-truth clouds under
        'gt_cloud' (B, N, 3) for Chamfer evaluation (the synthetic generator
        knows the true geometry — real ShapeNet needs the model .obj files,
        which this environment lacks).  Callers must pop 'gt_cloud' before
        feeding the trainer."""
        rng = self._rng
        B, V = self.batch_size, self.num_views
        clouds = _random_shapes(rng, B, self.n_points)
        quats = _random_unit_quats(rng, B * V)
        pc = np.repeat(clouds, V, axis=0)
        masks = self._render(pc, quats)
        imgs3 = np.repeat(masks[..., None], 3, axis=-1).astype(
            np.float32
        )  # (B*V, H, W, 3)
        view_pick = self._rng.randint(V, size=B)
        images = imgs3.reshape(B, V, self.image_size, self.image_size, 3)[
            np.arange(B), view_pick
        ]
        masks = masks.astype(np.float32)
        if self.uint8:
            # PNG-native uint8: the trainer normalizes on device (4x less
            # host->device traffic)
            q = lambda a: np.clip(a * 255.0, 0, 255).astype(np.uint8)
            batch = dict(images=q(images), pose_input=q(imgs3), masks=q(masks))
        else:
            batch = dict(images=images, pose_input=imgs3, masks=masks)
        if return_gt:
            batch["gt_cloud"] = clouds
        return batch

    def __iter__(self):
        while True:
            yield self.next_batch()
