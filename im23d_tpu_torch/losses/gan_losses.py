"""Mesh regularizer of the mesh-estimation and GAN objectives (counterpart
of ``flatness_loss`` in ``im23d_tpu/losses/gan_losses.py``; the adversarial
losses come with the GAN slice)."""

from __future__ import annotations

import torch


def flatness_loss(face_normals: torch.Tensor, ff: torch.Tensor,
                  per_sample: bool = False) -> torch.Tensor:
    """Mean squared cosine distance between edge-adjacent face normals,
    scaled by F / 2.

    face_normals (B, F, 3) unit normals; ff (F, 3) adjacent-face indices.
    Returns (B,) with ``per_sample``, else their mean.
    """
    F = face_normals.shape[1]
    loss = 0.0
    for i in range(3):
        n2 = face_normals[:, ff[:, i]]
        cos = (face_normals * n2).sum(dim=-1)
        loss = loss + ((cos - 1.0) ** 2).mean(dim=-1)
    loss = loss * (F / 2.0)
    return loss if per_sample else loss.mean()
