"""IoU metrics (counterpart of ``im23d_tpu/metrics/iou.py``): 2D
silhouette mIoU, and voxelized 3D IoU through ``ops/splat.trilinear_splat``
(the kernel K6 on CUDA, the plain splat on the CPU; the JAX version uses its
XLA splat, the same function)."""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops.splat import trilinear_splat


def mean_iou(alpha_pred: torch.Tensor, alpha_real: torch.Tensor,
             per_sample: bool = False) -> torch.Tensor:
    """(B, H, W) predicted and real alphas, binarized at 0.5 -> the mean
    IoU, or the (B,) per-sample IoUs."""
    p = alpha_pred > 0.5
    r = alpha_real > 0.5
    inter = (p & r).to(torch.float32).sum(dim=(1, 2))
    union = (p | r).to(torch.float32).sum(dim=(1, 2))
    iou = inter / torch.clamp(union, min=1.0)
    return iou if per_sample else iou.mean()


def iou_3d(points_a: torch.Tensor, points_b: torch.Tensor,
           voxel_size: int = 32, threshold: float = 0.1) -> torch.Tensor:
    """(B,) occupancy IoU of two point clouds splatted to a shared
    (voxel_size)³ grid and binarized at ``threshold``."""
    va = trilinear_splat(points_a, voxel_size) > threshold
    vb = trilinear_splat(points_b, voxel_size) > threshold
    inter = (va & vb).to(torch.float32).sum(dim=(1, 2, 3))
    union = (va | vb).to(torch.float32).sum(dim=(1, 2, 3))
    return inter / torch.clamp(union, min=1.0)
