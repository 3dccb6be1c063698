"""GAN objectives (hinge / ls / original / w) with per-critic masking and
weighting, and the mesh flatness regularizer of the mesh-estimation and GAN
objectives (counterpart of ``im23d_tpu/losses/gan_losses.py``)."""

from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None,
                 weight) -> torch.Tensor:
    w = 1.0 if weight is None else weight
    if mask is None:
        return x.mean() * w
    per_sample = (x * mask).sum(dim=(1, 2, 3)) / torch.clamp(
        mask.sum(dim=(1, 2, 3)), min=1e-12)
    return per_sample.mean() * w


def _single_gan_loss(pred, target_is_real: bool, for_discriminator: bool,
                     mask, weight, mode: str) -> torch.Tensor:
    if mode == "original":
        target = 1.0 if target_is_real else 0.0
        return (torch.clamp(pred, min=0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    if mode == "ls":
        target = 1.0 if target_is_real else 0.0
        return ((pred - target) ** 2).mean()
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -_masked_mean(torch.clamp(pred - 1.0, max=0.0), mask,
                                     weight)
            return -_masked_mean(torch.clamp(-pred - 1.0, max=0.0), mask,
                                 weight)
        if not target_is_real:
            raise ValueError("the generator's hinge loss aims for real")
        return -_masked_mean(pred, mask, weight)
    if mode == "w":
        return -pred.mean() if target_is_real else pred.mean()
    raise ValueError(f"unknown GAN loss mode {mode!r}")


def gan_loss(preds, target_is_real: bool, for_discriminator: bool = True,
             masks=None, weights=None, mode: str = "hinge") -> torch.Tensor:
    """One prediction, or the mean over critics (the weighted sum divided
    by the weights' sum when per-critic ``weights`` are given); masks weigh
    the hinge terms per sample.  Predictions and masks are (B, 1, h, w)."""
    if not isinstance(preds, (list, tuple)):
        return _single_gan_loss(preds, target_is_real, for_discriminator,
                                masks, None, mode)
    total = 0.0
    for i, p in enumerate(preds):
        m = masks[i] if masks is not None else None
        w = weights[i] if weights is not None else None
        total = total + _single_gan_loss(p, target_is_real, for_discriminator,
                                         m, w, mode)
    if weights is None:
        return total / len(preds)
    return total / sum(weights)


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
