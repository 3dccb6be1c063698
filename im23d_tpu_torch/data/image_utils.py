"""Host-side image crop/resize utilities for the CMR-style loaders (a
numpy copy of ``im23d_tpu/data/image_utils.py``; PIL is imported only by
``resize_img``, when it runs)."""

from __future__ import annotations

import numpy as np


def resize_img(img: np.ndarray, scale_factor: float):
    from PIL import Image

    new_size = np.round(np.array(img.shape[:2]) * scale_factor).astype(int)
    squeeze = img.ndim == 3 and img.shape[2] == 1
    src = img[..., 0] if squeeze else img
    pil = Image.fromarray((src * 255).astype(np.uint8)) if src.dtype != np.uint8 else Image.fromarray(src)
    resized = pil.resize((int(new_size[1]), int(new_size[0])), Image.BILINEAR)
    out = np.asarray(resized).astype(img.dtype)
    if img.dtype != np.uint8:
        out = out / 255.0
    if squeeze:
        out = out[..., None]
    actual = [new_size[0] / float(img.shape[0]), new_size[1] / float(img.shape[1])]
    return out, actual


def peturb_bbox(bbox, pf: float = 0.0, jf: float = 0.0, rng=None):
    """Jitter and pad a zero-indexed tight bbox (reference ``:17-38``)."""
    rng = rng or np.random
    out = [c for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    out[0] -= pf * bw + (1 - 2 * rng.random()) * jf * bw
    out[1] -= pf * bh + (1 - 2 * rng.random()) * jf * bh
    out[2] += pf * bw + (1 - 2 * rng.random()) * jf * bw
    out[3] += pf * bh + (1 - 2 * rng.random()) * jf * bh
    return out


def square_bbox(bbox):
    """Expand the short side so the bbox is square (reference ``:41-59``)."""
    sq = [int(round(c)) for c in bbox]
    bw = sq[2] - sq[0] + 1
    bh = sq[3] - sq[1] + 1
    maxdim = float(max(bw, bh))
    sq[0] -= int(round((maxdim - bw) / 2.0))
    sq[1] -= int(round((maxdim - bh) / 2.0))
    sq[2] = int(sq[0] + maxdim - 1)
    sq[3] = int(sq[1] + maxdim - 1)
    return sq


def crop(img: np.ndarray, bbox, bgval: float = 0.0) -> np.ndarray:
    """Crop with out-of-image regions filled by bgval (reference ``:62-91``)."""
    bbox = [int(round(c)) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    im_h, im_w = img.shape[:2]
    nc = 1 if img.ndim < 3 else img.shape[2]
    src = img if img.ndim == 3 else img[..., None]
    out = np.ones((bh, bw, nc), src.dtype) * bgval
    x0, x1 = max(0, bbox[0]), min(im_w, bbox[2] + 1)
    y0, y1 = max(0, bbox[1]), min(im_h, bbox[3] + 1)
    tx0 = x0 - bbox[0]
    ty0 = y0 - bbox[1]
    out[ty0 : ty0 + (y1 - y0), tx0 : tx0 + (x1 - x0)] = src[y0:y1, x0:x1]
    return out
