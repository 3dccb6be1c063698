"""GAN evaluation: FID of rendered generated meshes and the sample export
(counterpart of ``im23d_tpu/train/gan_eval.py``).

* ``render_generated``: pose and render generated (mesh map, texture)
  pairs (K4 and K5 on CUDA).
* ``FIDEvaluator``: truncated z, the EMA generator, renders at 299² under
  the dataset's poses, Inception activations; the three variants
  (generated, real mesh + generated texture, generated mesh + real
  texture); a tail batch is padded to the batch size with repeats of its
  first item and its activations cut back, so every image scores once.
* The reference-format statistics readers and the validation-split FIDs.
* ``export_results`` (``--save_results``): obj / mtl / png per sample and a
  grid of renders on white, 2× average-pooled, written with
  ``core/metrics_logger.write_png`` (no imaging library).
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch

from im23d_tpu_torch.metrics.fid import calculate_stats, frechet_distance
from im23d_tpu_torch.ops.quaternion import qnormalize, qrot
from im23d_tpu_torch.render.renderer import render_mesh


def render_generated(template, renderer_res: int, mesh_map: torch.Tensor,
                     texture: torch.Tensor, scale: torch.Tensor,
                     translation: torch.Tensor, rotation: torch.Tensor):
    """Pose and render UV mesh maps (B, m, m, 3) with [-1, 1] textures
    (B, T, T, 3) under (scale (B,), translation (B, 3), rotation (B, 4));
    returns (image (B, R, R, 3), alpha (B, R, R, 1))."""
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


def _poses(batch: dict, device):
    def f32(key):
        return torch.as_tensor(np.asarray(batch[key]), dtype=torch.float32,
                               device=device)

    return f32("scale").reshape(-1), f32("translation"), f32("rotation")


class FIDEvaluator:
    """Renders generated samples and scores FID against real statistics.
    ``inception`` defaults to the calibrated random extractor
    (``init_inception``: 288-d features, numbers for regression tracking
    only, reported as ``fid_uncalibrated``)."""

    def __init__(self, gan_trainer, template, evaluation_res: int = 299,
                 inception=None):
        from im23d_tpu_torch.metrics.inception import init_inception

        self.trainer = gan_trainer
        self.template = template
        self.res = evaluation_res
        self.calibrated = inception is not None
        self.model = (inception if inception is not None
                      else init_inception(device=gan_trainer.device))
        self.model.eval()

    def _render(self, mesh_map, tex, poses):
        return render_generated(self.template, self.res, mesh_map, tex,
                                *poses)[0]

    @torch.no_grad()
    def _act(self, img: torch.Tensor) -> np.ndarray:
        return self.model(img).float().cpu().numpy()

    def activations_for_batches(self, eval_batches: Iterable[dict],
                                truncation_sigma: float = 1e9,
                                variants: bool = False,
                                z_batches=None) -> dict:
        """Generate, render and embed.  Returns {'combined': (N, D)} plus
        'texture_only' and 'mesh_only' when ``variants`` and the batches
        carry the pseudo-ground truth.  Batch i's z is
        ``trainer.truncation_sample(i, ...)``, or ``z_batches[i]`` when
        given."""
        dev = self.trainer.device
        acts: dict[str, list] = {"combined": []}
        if variants:
            acts["texture_only"] = []
            acts["mesh_only"] = []
        full_n = None
        for i, batch in enumerate(eval_batches):
            n = len(batch["rotation"])
            if full_n is None:
                full_n = n
            elif n < full_n:
                batch = {k: np.concatenate([v, np.repeat(v[:1], full_n - n,
                                                         0)])
                         for k, v in batch.items()}
            m = len(batch["rotation"])
            z = (torch.tensor(np.asarray(z_batches[i]), device=dev)
                 if z_batches is not None else
                 self.trainer.truncation_sample(i, m, truncation_sigma))
            tex, mesh_map = self.trainer.generate(z, batch.get("c"))
            poses = _poses(batch, dev)
            with torch.no_grad():
                acts["combined"].append(
                    self._act(self._render(mesh_map, tex, poses))[:n])
                if variants and "texture" in batch and "mesh" in batch:
                    real_tex = torch.as_tensor(np.asarray(batch["texture"]),
                                               dtype=torch.float32, device=dev)
                    real_mesh = torch.as_tensor(np.asarray(batch["mesh"]),
                                                dtype=torch.float32,
                                                device=dev)
                    acts["texture_only"].append(self._act(
                        self._render(real_mesh, tex, poses))[:n])
                    acts["mesh_only"].append(self._act(
                        self._render(mesh_map, real_tex, poses))[:n])
        return {k: np.concatenate(v, axis=0) for k, v in acts.items() if v}

    @property
    def metric_prefix(self) -> str:
        """'fid' with pretrained weights, 'fid_uncalibrated' with the random
        extractor."""
        return "fid" if self.calibrated else "fid_uncalibrated"

    @staticmethod
    def fid_against_stats(activations: np.ndarray, m_real, s_real) -> float:
        if activations.shape[-1] != len(m_real):
            raise ValueError(
                f"feature dim {activations.shape[-1]} != precomputed stats "
                f"dim {len(m_real)}: the cache statistics come from another "
                "extractor (the random one gives 288-d Mixed_5d features, "
                "pretrained weights 2048-d pool3); regenerate the cache's "
                "precomputed_fid_*.npz")
        m, s = calculate_stats(activations)
        return frechet_distance(m, s, m_real, s_real)


def load_precomputed_stats(path: str):
    """(mean, covariance, num_images, resolution) from a reference-format
    statistics npz (lower-triangular covariance)."""
    with np.load(path, allow_pickle=True) as stats:
        m = stats["stats_m"]
        s = stats["stats_s"]
        return (m, s + np.triu(s.T, 1), int(stats["num_images"]),
                int(stats["resolution"]))


def load_val_stats(cache_dir: str, evaluation_res: int = 299):
    """(mean, covariance, num_images) of the testval split, or None when the
    cache has none."""
    path = os.path.join(
        cache_dir,
        f"precomputed_fid_{evaluation_res}x{evaluation_res}_testval.npz")
    if not os.path.exists(path):
        return None
    m, s, n, _ = load_precomputed_stats(path)
    return m, s, n


def val_fids(acts: dict, val_stats, rng: np.random.RandomState) -> dict:
    """Validation FIDs: the fake activations subsampled to the val set's
    size (the same indices for every variant) against the testval stats."""
    m_v, s_v, n_v = val_stats
    n = len(acts["combined"])
    sel = rng.choice(n, size=min(n_v, n), replace=False)
    return {f"{key}_val": FIDEvaluator.fid_against_stats(act[sel], m_v, s_v)
            for key, act in acts.items()}


def export_results(gan_trainer, template, out_dir: str, n_samples: int = 16,
                   truncation_sigma: float = 1.0, classes=None, poses=None,
                   caption_tokens=None, render_res: int = 512) -> list[str]:
    """``--save_results``: obj / mtl / png per sample (Y-up, the reference's
    Y/Z swap), conditioned on ``classes`` and ``caption_tokens`` (B, L)
    where given, and, with ``poses`` (scale / translation / rotation arrays),
    the samples rendered under them on white, 2× average-pooled, tiled in
    rows of 8 into ``<out_dir>.png``.  Returns the written .obj paths and
    the grid's."""
    from im23d_tpu_torch.core.metrics_logger import tile_grid, write_png

    os.makedirs(out_dir, exist_ok=True)
    z = gan_trainer.truncation_sample(0, n_samples, truncation_sigma)
    tex, mesh_map = gan_trainer.generate(z, classes, caption_tokens)
    with torch.no_grad():
        vtx = template.get_vertex_positions(mesh_map)
    tex01 = (tex / 2.0 + 0.5).cpu().numpy()
    vtx_obj = vtx.cpu().numpy()[:, :, [0, 2, 1]]
    files = []
    for i in range(n_samples):
        prefix = os.path.join(out_dir, f"mesh_{i}")
        template.export_obj(prefix, vtx_obj[i], tex01[i])
        files.append(prefix + ".obj")
    if poses is not None:
        with torch.no_grad():
            img, alpha = render_generated(
                template, render_res, mesh_map, tex,
                *_poses(poses, gan_trainer.device))
        img = torch.where(alpha > 0, img, torch.ones_like(img)).cpu().numpy()
        H = img.shape[1] // 2 * 2
        img = img[:, :H, :H].reshape(img.shape[0], H // 2, 2, H // 2, 2,
                                     -1).mean((2, 4))
        grid = tile_grid(img, ncol=min(8, img.shape[0]), fill=1.0)
        grid_path = out_dir.rstrip("/\\") + ".png"
        write_png(grid_path, (grid * 255).astype(np.uint8))
        files.append(grid_path)
    return files
