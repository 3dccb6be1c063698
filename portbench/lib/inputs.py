"""The cells' inputs, made from ``--seed`` by the benchmark's own code on
the device in a few large draws, then held where the program's feed reads
them: structured fields (smooth colour maps, silhouettes, mesh
displacements) of the sizes the configurations state.

``GANCacheSet`` stands where the pseudo-ground-truth cache's dataset
stands (what ``DeviceGANCache`` stages), ``PhotoSet`` where the CMR photo
set stands (what ``batch_iterator`` reads), ``PoseSet`` where the FID
pass's evaluation batches stand.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib.common import (
    device_generator,
    random_poses,
    smooth_field,
    subseed,
)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class GANCacheSet:
    """``n`` pseudo-ground-truth items: a (T, T, 3) float16 texture in
    [-1, 1], a (T, T, 1) float16 visibility alpha in [0, 1], an (m, m, 3)
    float32 mesh displacement map of tenths, a class in [0, classes)."""

    augment = True
    evaluate = False
    conditional_class = True
    caption_tokens = None

    def __init__(self, seed: int, n: int, texture_res: int, mesh_res: int,
                 n_classes: int, device):
        gen = device_generator(subseed(seed, 11), device)
        tex = torch.empty((n, texture_res, texture_res, 3), device=device,
                          dtype=torch.float16)
        alpha = torch.empty((n, texture_res, texture_res, 1), device=device,
                            dtype=torch.float16)
        chunk = 64
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            tex[s:s + m] = torch.tanh(1.5 * smooth_field(
                gen, m, 3, texture_res, 16, device, chunk)).half()
            alpha[s:s + m] = torch.sigmoid(6.0 * (smooth_field(
                gen, m, 1, texture_res, 8, device, chunk) + 0.3)).half()
        mesh = 0.1 * smooth_field(gen, n, 3, mesh_res, 8, device)
        classes = torch.randint(0, n_classes, (n,), generator=gen,
                                device=device)
        self.texture, self.alpha = _host(tex), _host(alpha)
        self.mesh, self.class_ids = _host(mesh), _host(classes)
        self.classes = [np.array([c], np.int64) for c in self.class_ids]
        self.data_seed = subseed(seed, 12) % 2**32
        self._epoch = 0

    def __len__(self) -> int:
        return len(self.class_ids)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _item_rng(self, idx: int, epoch: int | None = None):
        e = self._epoch if epoch is None else int(epoch)
        return np.random.default_rng(
            np.random.SeedSequence([self.data_seed, e, int(idx)]))

    def load_pseudo_ground_truth(self, idx: int, with_image: bool = False):
        return dict(texture=self.texture[idx], texture_alpha=self.alpha[idx],
                    mesh=self.mesh[idx])


class PhotoSet:
    """``n`` masked RGBA photos (H, W, 4) float32 (RGB in [-1, 1] times the
    silhouette, then the silhouette): an ellipse of random centre, axes and
    tilt, its edge moved by a smooth field; and each photo's pose."""

    def __init__(self, seed: int, n: int, res: int, device):
        gen = device_generator(subseed(seed, 21), device)
        ys = (torch.arange(res, device=device) + 0.5) / res * 2 - 1
        py, px = torch.meshgrid(ys, ys, indexing="ij")
        u = torch.rand((n, 5), generator=gen, device=device)
        cx, cy = 0.3 * u[:, 0] - 0.15, 0.3 * u[:, 1] - 0.15
        ax, ay = 0.35 + 0.3 * u[:, 2], 0.25 + 0.3 * u[:, 3]
        th = u[:, 4] * np.pi
        images = torch.empty((n, res, res, 4), device=device)
        chunk = 50
        for s in range(0, n, chunk):
            sl = slice(s, min(n, s + chunk))
            m = sl.stop - sl.start
            dx = px[None] - cx[sl, None, None]
            dy = py[None] - cy[sl, None, None]
            c, sn = torch.cos(th[sl])[:, None, None], torch.sin(th[sl])[
                :, None, None]
            r = ((c * dx + sn * dy) / ax[sl, None, None]) ** 2 + (
                (-sn * dx + c * dy) / ay[sl, None, None]) ** 2
            edge = 0.25 * smooth_field(gen, m, 1, res, 6, device,
                                       chunk)[..., 0]
            mask = (r < 1.0 + edge).float()[..., None]
            rgb = torch.tanh(smooth_field(gen, m, 3, res, 12, device, chunk))
            images[sl] = torch.cat([rgb * mask, mask], dim=-1)
        scale, translation, rotation = random_poses(gen, n, device)
        self.image = _host(images)
        self.scale, self.translation = _host(scale), _host(translation)
        self.rotation = _host(rotation)

    def __len__(self) -> int:
        return len(self.scale)

    def item(self, index: int, epoch: int | None = None) -> dict:
        return dict(image=self.image[index], scale=self.scale[index],
                    translation=self.translation[index],
                    rotation=self.rotation[index], idx=np.int32(index))

    def rows(self, idx) -> dict:
        """The stacked rows ``idx``, as the reference reads them."""
        idx = np.asarray(idx)
        return dict(image=self.image[idx], scale=self.scale[idx],
                    translation=self.translation[idx],
                    rotation=self.rotation[idx],
                    idx=idx.astype(np.int64))


class PoseSet:
    """``n`` evaluation poses and classes: the FID pass's batches."""

    def __init__(self, seed: int, n: int, n_classes: int, device):
        gen = device_generator(subseed(seed, 31), device)
        scale, translation, rotation = random_poses(gen, n, device)
        c = torch.randint(0, n_classes, (n, 1), generator=gen, device=device)
        self.scale, self.translation = _host(scale), _host(translation)
        self.rotation, self.c = _host(rotation), _host(c)

    def batch(self, i: int, batch_size: int) -> dict:
        sl = slice(i * batch_size, (i + 1) * batch_size)
        return dict(scale=self.scale[sl], translation=self.translation[sl],
                    rotation=self.rotation[sl], c=self.c[sl])

    def __len__(self) -> int:
        return len(self.scale)
