"""Voxelized 3D IoU (counterpart of ``iou_3d`` in
``im23d_tpu/metrics/iou.py``); uses the plain splat, as the JAX version
does."""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops.voxel import trilinear_splat


def iou_3d(points_a: torch.Tensor, points_b: torch.Tensor,
           voxel_size: int = 32, threshold: float = 0.1) -> torch.Tensor:
    """(B,) occupancy IoU of two point clouds splatted to a shared
    (voxel_size)³ grid and binarized at ``threshold``."""
    va = trilinear_splat(points_a, voxel_size) > threshold
    vb = trilinear_splat(points_b, voxel_size) > threshold
    inter = (va & vb).to(torch.float32).sum(dim=(1, 2, 3))
    union = (va | vb).to(torch.float32).sum(dim=(1, 2, 3))
    return inter / torch.clamp(union, min=1.0)
