"""The arithmetic of a kernel's least time: bytes over the card's memory
rate or operations over its peak rate for their type, whichever is
larger, each input byte read once and each output byte written once.
Counts that depend on the data stay device tensors until the window has
closed (no wait inside it)."""

from __future__ import annotations

import math

import torch

from portbench.lib.common import PEAK_BF16, PEAK_BYTES, PEAK_F32

__all__ = ["PEAK_BF16", "PEAK_BYTES", "PEAK_F32", "nbytes", "peak_for",
           "raster_pairs", "seconds", "texels_read"]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def peak_for(x: torch.Tensor) -> float:
    """Tensor cores for bfloat16 and float16 operands, else float32."""
    return PEAK_BF16 if x.dtype in (torch.bfloat16, torch.float16) \
        else PEAK_F32


def raster_pairs(fv: torch.Tensor, height: int, width: int, sigma: float,
                 cull: bool = True) -> torch.Tensor:
    """Pixel and face pairs the rasterizer must visit: the pixel centres
    inside each drawn face's bounding box widened by sqrt(104 sigma), the
    distance beyond which a face changes no value in float32.  fv (B, F,
    3, 3) face corners; a 0-d device tensor."""
    fv = fv.detach().float()
    x, y = fv[..., 0], fv[..., 1]
    area = ((x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0])
            - (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    drawn = area > 1e-9 if cull else area.abs() > 1e-9
    m = math.sqrt(104.0 * sigma)
    c_lo = torch.ceil((x.amin(-1) - m + 1) * width / 2 - 0.5).clamp(min=0)
    c_hi = torch.floor((x.amax(-1) + m + 1) * width / 2 - 0.5).clamp(
        max=width - 1)
    r_lo = torch.ceil((1 - (y.amax(-1) + m)) * height / 2 - 0.5).clamp(min=0)
    r_hi = torch.floor((1 - (y.amin(-1) - m)) * height / 2 - 0.5).clamp(
        max=height - 1)
    n = (c_hi - c_lo + 1).clamp(min=0) * (r_hi - r_lo + 1).clamp(min=0)
    return (n * drawn).sum()


def seconds(nbytes_: float, ops, peak: float) -> float:
    """The least time of one call."""
    return max(float(nbytes_) / PEAK_BYTES, float(ops) / peak)


def texels_read(img: torch.Tensor, grid: torch.Tensor,
                samples: torch.Tensor | None = None) -> torch.Tensor:
    """Distinct texels of ``img`` (B, H, W, C) that the bilinear lookup at
    ``grid`` (B, Hg, Wg, 2), align_corners=True, must read: the in-range
    corners of every sample (of the samples where ``samples`` (B, Hg, Wg)
    is True).  A 0-d device tensor (a bitmap's count: no wait)."""
    B, H, W, _ = img.shape
    g = grid.detach().float()
    x = torch.floor((g[..., 0] + 1.0) * 0.5 * (W - 1))
    y = torch.floor((g[..., 1] + 1.0) * 0.5 * (H - 1))
    b = torch.arange(B, device=g.device).view(B, *([1] * (g.dim() - 2)))
    n = B * H * W
    # one slot past the texels takes the corners out of range: a scatter
    # by index, where a boolean mask would wait for the device
    seen = torch.zeros(n + 1, dtype=torch.uint8, device=g.device)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x + dx, y + dy
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            if samples is not None:
                ok = ok & samples
            idx = (b * H + yi.clamp(0, H - 1).long()) * W \
                + xi.clamp(0, W - 1).long()
            seen.scatter_(0, torch.where(ok, idx, n).flatten(), 1)
    return seen[:n].sum()
