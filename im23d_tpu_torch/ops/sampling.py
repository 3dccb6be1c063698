"""Bilinear resize (counterpart of ``resize_bilinear`` in
``im23d_tpu/ops/sampling.py``), used for the mask downsample of the loss."""

from __future__ import annotations

import torch


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (B, H, W[, C]) with torch align_corners=True
    semantics (the JAX default, the only mode the loss uses).

    Separable: the bilinear weight of source pixel i at position x is the hat
    function max(0, 1 - |x - i|), applied as two interpolation matmuls (the
    same arithmetic as the JAX version).
    """
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    _, H, W, _ = img.shape
    dev = img.device
    ys = torch.linspace(0.0, H - 1.0, out_h, device=dev)
    xs = torch.linspace(0.0, W - 1.0, out_w, device=dev)
    ry = torch.clamp(1.0 - torch.abs(ys[:, None] - torch.arange(H, device=dev)),
                     min=0.0)
    rx = torch.clamp(1.0 - torch.abs(xs[:, None] - torch.arange(W, device=dev)),
                     min=0.0)
    out = torch.einsum("oh,bhwc->bowc", ry.to(img.dtype), img)
    out = torch.einsum("pw,bowc->bopc", rx.to(img.dtype), out)
    return out[..., 0] if squeeze else out
