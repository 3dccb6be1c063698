"""Camera-space transform for the rendering-free projection.

Counterpart of ``im23d_tpu/ops/camera.py``: point clouds are (..., N, 3) in
(z, y, x) order, component 0 is depth along the view ray; after rotation the
lateral components are divided by ``z + camera_distance`` and scaled by the
field-of-view factor.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops.quaternion import qrot_points

FIELD_OF_VIEW = 1.875
CAMERA_DISTANCE = 2.0


def world_to_camera_zyx(
    point_cloud: torch.Tensor,
    rotation: torch.Tensor,
    field_of_view: float = FIELD_OF_VIEW,
    camera_distance: float = CAMERA_DISTANCE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``world_to_camera`` returning the planar (..., N) z, y, x components."""
    pc = qrot_points(point_cloud, rotation)
    z = pc[..., 0]
    scale = field_of_view / (z + camera_distance)
    return z, pc[..., 1] * scale, pc[..., 2] * scale


def world_to_camera(
    point_cloud: torch.Tensor,
    rotation: torch.Tensor,
    field_of_view: float = FIELD_OF_VIEW,
    camera_distance: float = CAMERA_DISTANCE,
) -> torch.Tensor:
    """(..., N, 3) (z, y, x) cloud, (..., 4) wxyz quats -> camera space."""
    return torch.stack(
        world_to_camera_zyx(point_cloud, rotation, field_of_view,
                            camera_distance),
        dim=-1,
    )
