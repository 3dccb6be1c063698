"""Structured synthetic data for Pipeline B: procedural (texture, mesh)
pairs and photos rendered from them (counterpart of
``im23d_tpu/data/fabricate.py``).

``StructuredPseudoGT`` is a numpy copy of the JAX fabricator: per-class
palettes, stripe fields and blobs for the texture, a visibility band for the
alpha, low-order Fourier displacements for the mesh; every map is a pure
function of (seed, class, index).  ``StructuredReconSet`` is the in-memory
counterpart of the JAX ``build_structured_cmr_tree``: each photo is the
port's own render of a structured (texture, mesh) pair under a known
normalised pose, served with the item contract of the CMR loaders
(``data/cmr.py``), so the mesh-estimation trainer and ``batch_iterator``
take it unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from im23d_tpu_torch.ops.quaternion import qnormalize, qrot
from im23d_tpu_torch.render.renderer import render_mesh


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _smoothstep(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    t = np.clip((x - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


class StructuredPseudoGT:
    """Procedural (texture, alpha, mesh) maps with class-conditional structure.

    Texture family (all smooth, conv-learnable):
      * per-class 3-color palette, vertical gradient between the first two,
      * a class-frequency/orientation stripe field mixing in the third,
      * 2-4 soft blobs at per-image positions re-mixing the second.
    Alpha: a soft visibility band in v (UV-sphere poles unobserved, like a
    real inverse-rendered visibility map), per-image edge jitter.
    Mesh: per-class amplitude-enveloped low-order Fourier displacement of
    the template sphere (smooth, zero-mean, ~|0.05| like real exports).
    """

    def __init__(self, n_images: int, resolution: int = 512,
                 mesh_resolution: int = 32, n_classes: int = 8,
                 seed: int = 0):
        self.n = int(n_images)
        self.res = int(resolution)
        self.mesh_res = int(mesh_resolution)
        self.n_classes = int(n_classes)
        self.seed = int(seed)
        root = np.random.default_rng(np.random.SeedSequence([seed, 0xC1A55]))
        # per-class structure parameters
        hues = root.uniform(0.0, 1.0, (self.n_classes, 3))
        self.palette = np.stack(
            [self._hue_to_rgb(hues[:, j], 0.55 + 0.3 * j / 2) for j in range(3)],
            axis=1,
        )  # (n_classes, 3 colors, 3 rgb) in [0, 1]
        self.stripe_freq = root.uniform(2.0, 6.0, self.n_classes)
        self.stripe_theta = root.uniform(0.0, np.pi, self.n_classes)
        self.blob_count = root.integers(2, 5, self.n_classes)
        self.blob_sigma = root.uniform(0.06, 0.14, self.n_classes)
        self.mesh_amp = root.uniform(0.03, 0.08, self.n_classes)

    @staticmethod
    def _hue_to_rgb(h: np.ndarray, value: float) -> np.ndarray:
        """Saturated HSV->RGB at fixed s=0.8 (vectorized over h)."""
        i = np.floor(h * 6.0).astype(int) % 6
        f = h * 6.0 - np.floor(h * 6.0)
        s = 0.8
        p = np.full_like(f, value * (1 - s))
        q, t = value * (1 - s * f), value * (1 - s * (1 - f))
        v = np.full_like(f, value)
        table = np.stack([
            np.stack([v, t, p], -1), np.stack([q, v, p], -1),
            np.stack([p, v, t], -1), np.stack([p, q, v], -1),
            np.stack([t, p, v], -1), np.stack([v, p, q], -1),
        ], 0)  # (6, N, 3)
        return table[i, np.arange(len(h))]

    def class_of(self, idx: int) -> int:
        return int(idx) % self.n_classes

    def _rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, 1, int(idx)])
        )

    def maps(self, idx: int) -> dict:
        """NCHW fp16 cache maps for one index: texture (3,R,R) in [-1,1],
        texture_alpha (1,R,R) in [0,1], mesh (3,m,m)."""
        R = self.res
        k = self.class_of(idx)
        rng = self._rng(idx)
        u, v = np.meshgrid(
            (np.arange(R) + 0.5) / R, (np.arange(R) + 0.5) / R, indexing="xy"
        )  # (R, R); rows = v (texture row axis), cols = u

        c0, c1, c2 = self.palette[k]  # each (3,)
        tex = c0[:, None, None] * (1 - v) + c1[:, None, None] * v

        phase = rng.uniform(0, 2 * np.pi)
        th = self.stripe_theta[k] + rng.normal(0, 0.08)
        s = 0.5 + 0.5 * np.sin(
            2 * np.pi * self.stripe_freq[k] * (u * np.cos(th) + v * np.sin(th))
            + phase
        )
        tex = tex * (1 - 0.5 * s) + c2[:, None, None] * (0.5 * s)

        for _ in range(int(self.blob_count[k])):
            bu, bv = rng.uniform(0.1, 0.9, 2)
            # wrap-around distance in u (the texture is periodic in u on the
            # sphere, and mirror augmentation rolls it by half a period)
            du = np.abs(u - bu)
            du = np.minimum(du, 1.0 - du)
            d2 = du**2 + (v - bv) ** 2
            g = np.exp(-d2 / (2 * self.blob_sigma[k] ** 2))
            tex = tex * (1 - 0.6 * g) + c1[:, None, None] * (0.6 * g)

        lo = 0.08 + rng.normal(0, 0.01)
        hi = 0.92 + rng.normal(0, 0.01)
        alpha = _smoothstep(v, lo, lo + 0.1) * (1 - _smoothstep(v, hi - 0.1, hi))

        m = self.mesh_res
        mu, mv = np.meshgrid(
            (np.arange(m) + 0.5) / m, (np.arange(m) + 0.5) / m, indexing="xy"
        )
        mesh = np.zeros((3, m, m), np.float64)
        for a in range(3):
            for b in range(3):
                if a == 0 and b == 0:
                    continue
                amp = rng.normal(0, 1.0, 3) / (1.0 + a + b)
                ph = rng.uniform(0, 2 * np.pi)
                basis = np.cos(2 * np.pi * (a * mu + b * mv) + ph)
                mesh += amp[:, None, None] * basis
        # pole rows of the UV sphere collapse to points; taper displacement
        # there so the fabricated geometry stays watertight-looking
        taper = np.sin(np.pi * mv)
        mesh = self.mesh_amp[k] * mesh * taper

        return {
            "texture": (tex * 2.0 - 1.0).astype(np.float16),
            "texture_alpha": alpha[None].astype(np.float16),
            "mesh": mesh.astype(np.float16),
        }

    def poses(self) -> dict:
        """Plausible dataset poses (scale/translation/rotation), seeded."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 2]))
        rot = _unit(rng.normal(size=(self.n, 4)))
        return dict(
            scale=(0.7 + 0.05 * rng.standard_normal((self.n, 1))).astype(
                np.float32
            ),
            translation=(0.05 * rng.standard_normal((self.n, 3))).astype(
                np.float32
            ),
            rotation=rot.astype(np.float32),
        )


def render_generated(template, renderer_res: int, mesh_map: torch.Tensor,
                     texture: torch.Tensor, scale: torch.Tensor,
                     translation: torch.Tensor, rotation: torch.Tensor):
    """Pose and render UV mesh maps (B, m, m, 3) with [-1, 1] textures
    (B, T, T, 3) under (scale (B,), translation (B, 3), rotation (B, 4));
    returns (image (B, R, R, 3), alpha (B, R, R, 1)).  Counterpart of
    ``render_generated`` in ``im23d_tpu/train/gan_eval.py``."""
    vtx = template.get_vertex_positions(mesh_map)
    vtx = qrot(qnormalize(rotation), scale.reshape(-1, 1, 1) * vtx)
    vtx = (vtx + translation[:, None, :]) * vtx.new_tensor([1.0, -1.0, -1.0])
    uvs, tex_adj = template.adjust_uv_and_texture(texture / 2.0 + 0.5)
    dev = vtx.device
    image, alpha, _ = render_mesh(
        vtx, template.tensor("faces", dev), uvs,
        template.tensor("face_uvs", dev), tex_adj, renderer_res,
        renderer_res)
    return image, alpha


class StructuredReconSet:
    """``n`` photos rendered in memory from structured (texture, mesh)
    pairs, with the CMR item contract: ``image`` (R, R, 4) masked RGBA in
    [-1, 1] (white background outside the alpha > 0.5 mask, then masked),
    ``scale``, ``translation`` (x, y, 0), ``rotation`` (wxyz) and ``idx``;
    for each extra resolution S of ``sizes``, ``image_S`` (S, S, 3), the
    masked RGB of the same photo rendered at S (as the CMR loaders'
    multi-resolution items; pseudo-GT generation reads ``image_299`` and
    ``image_1024``).  ``get_paths`` names the photos as the JAX tree does.

    The poses are drawn as in ``build_structured_cmr_tree`` and are already
    normalised: the JAX tree writes each photo as a PNG with its pose in
    pixel units, and its CMR loader pads, crops, rescales and normalises
    them again; that round trip is left out here, so photo and pose reach
    the trainer exactly as rendered.
    """

    def __init__(self, template, n: int, photo_res: int = 256,
                 texture_resolution: int = 128, n_classes: int = 4,
                 seed: int = 0, batch: int = 10, device="cpu",
                 sizes=()):
        fab = StructuredPseudoGT(n, texture_resolution, n_classes=n_classes,
                                 seed=seed)
        rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
        scale_n = 0.55 + 0.1 * rng.random(n)
        t_n = 0.1 * rng.standard_normal((n, 2))
        quat = _unit(rng.standard_normal((n, 4)))
        self.scale = scale_n.astype(np.float32)
        self.translation = np.concatenate(
            [t_n, np.zeros((n, 1))], axis=1).astype(np.float32)
        self.rotation = quat.astype(np.float32)
        self.images = np.zeros((n, photo_res, photo_res, 4), np.float32)
        self.extra = {int(r): np.zeros((n, r, r, 3), np.float32)
                      for r in sizes}
        for start in range(0, n, batch):
            sel = list(range(start, min(start + batch, n)))
            maps = [fab.maps(i) for i in sel]

            def stack(key):
                return torch.as_tensor(np.stack(
                    [m[key].transpose(1, 2, 0) for m in maps]),
                    dtype=torch.float32, device=device)

            for res in (photo_res, *self.extra):
                with torch.no_grad():
                    img, alpha = render_generated(
                        template, res, stack("mesh"), stack("texture"),
                        *(torch.as_tensor(a[sel], device=device) for a in (
                            self.scale, self.translation, self.rotation)))
                img, alpha = img.cpu().numpy(), alpha.cpu().numpy()
                mask = (alpha > 0.5).astype(np.float32)
                rgb = (np.clip(np.where(alpha > 0.5, img, 1.0), 0.0, 1.0)
                       * 2 - 1) * mask
                if res == photo_res:
                    self.images[start:start + len(sel)] = np.concatenate(
                        [rgb, mask], axis=-1)
                else:
                    self.extra[res][start:start + len(sel)] = rgb

    def __len__(self) -> int:
        return len(self.images)

    def get_paths(self) -> list[str]:
        return [f"img_{i}.png" for i in range(len(self))]

    def __getitem__(self, index: int) -> dict:
        item = dict(image=self.images[index], scale=self.scale[index],
                    translation=self.translation[index],
                    rotation=self.rotation[index], idx=np.int32(index))
        for res, images in self.extra.items():
            item[f"image_{res}"] = images[index]
        return item
