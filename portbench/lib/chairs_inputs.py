"""The chairs cell's renders, made from ``--seed`` on the device in a few
large draws and held in host memory, where ``ShapeNetRenders``' RAM cache
holds a ShapeNet tree's decoded models.  Nothing here imports the
program.
"""

from __future__ import annotations

import math

import torch

from portbench.lib.common import device_generator, smooth_field, subseed


def _uint8(t: torch.Tensor) -> torch.Tensor:
    return (t * 255).round().clamp(0, 255).to(torch.uint8)


class ChairRenders:
    """``n`` models of ``views`` renders each, with ``ShapeNetRenders``'
    camera-less item contract: images (V, H, W, 3) uint8, the same images
    as the pose views, masks (V, H, W) uint8.  A mask is a smooth
    silhouette (an ellipse of random centre, axes and tilt, its edge moved
    by a smooth field, a soft rim of a pixel or two); its image a smooth
    colour field on it, black around it."""

    def __init__(self, seed: int, n: int, res: int, views: int, device,
                 chunk: int = 256):
        gen = device_generator(subseed(seed, 41), device)
        m_all = n * views
        ys = (torch.arange(res, device=device) + 0.5) / res * 2 - 1
        py, px = torch.meshgrid(ys, ys, indexing="ij")
        u = torch.rand((m_all, 5), generator=gen, device=device)
        cx, cy = 0.3 * u[:, 0] - 0.15, 0.3 * u[:, 1] - 0.15
        ax, ay = 0.3 + 0.35 * u[:, 2], 0.3 + 0.35 * u[:, 3]
        th = u[:, 4] * math.pi
        masks = torch.empty((m_all, res, res), device=device,
                            dtype=torch.uint8)
        images = torch.empty((m_all, res, res, 3), device=device,
                             dtype=torch.uint8)
        for s in range(0, m_all, chunk):
            sl = slice(s, min(m_all, s + chunk))
            k = sl.stop - sl.start
            dx = px[None] - cx[sl, None, None]
            dy = py[None] - cy[sl, None, None]
            c, sn = (torch.cos(th[sl])[:, None, None],
                     torch.sin(th[sl])[:, None, None])
            r = ((c * dx + sn * dy) / ax[sl, None, None]) ** 2 + (
                (-sn * dx + c * dy) / ay[sl, None, None]) ** 2
            edge = 0.3 * smooth_field(gen, k, 1, res, 6, device,
                                      chunk)[..., 0]
            mask = torch.sigmoid(0.25 * res * (1.0 + edge - r))
            rgb = 0.5 + 0.4 * torch.tanh(smooth_field(gen, k, 3, res, 8,
                                                      device, chunk))
            masks[sl] = _uint8(mask)
            images[sl] = _uint8(rgb * mask[..., None])
        self.images = images.cpu().numpy().reshape(n, views, res, res, 3)
        self.masks = masks.cpu().numpy().reshape(n, views, res, res)

    def __len__(self) -> int:
        return len(self.masks)

    def num_views(self, idx: int) -> int:
        return self.masks.shape[1]

    def __getitem__(self, idx: int):
        return self.images[idx], self.images[idx], self.masks[idx]
