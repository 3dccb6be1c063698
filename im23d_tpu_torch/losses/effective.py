"""The rendering-free "effective" projection loss, values and gradients.

Counterpart of ``im23d_tpu/losses/effective.py``: camera transform ->
projection (kernel K1 forward, K2 backward on CUDA) -> ensemble min-loss
over the K pose candidates + weighted student quaternion-angle loss, and the
supervised projection loss under ground-truth poses.

The min over candidates only backpropagates through the argmin candidate,
so the K-way sweep runs without gradient and only the B*V winners are
differentiated, through the winner reuse ``projection_silhouette_reuse``:
its value is the sweep's silhouette, its backward K2 on the winners alone.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.core.profiler import span
from im23d_tpu_torch.ops.camera import world_to_camera_zyx
from im23d_tpu_torch.ops.projection import (
    projection_silhouette,
    projection_silhouette_reuse,
)
from im23d_tpu_torch.ops.quaternion import quaternion_angle_loss
from im23d_tpu_torch.ops.sampling import resize_bilinear


def _candidate_cam(point_cloud, rotations, scale, weights):
    """Camera-space planes + repeated weights/scale for C candidates.

    Returns ``((z, y, x), w, sc)`` with each component (B*C, N), b-major.
    """
    B, N, _ = point_cloud.shape
    C = rotations.shape[1]
    z, y, x = world_to_camera_zyx(point_cloud[:, None], rotations)  # (B,C,N)
    cam = tuple(g.reshape(B * C, N) for g in (z, y, x))
    w = None if weights is None else weights.repeat_interleave(C, dim=0)
    sc = None if scale is None else scale.reshape(B).repeat_interleave(C)
    return cam, w, sc


def project_candidates(
    point_cloud: torch.Tensor,
    rotations: torch.Tensor,
    sigma,
    scale: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    voxel_size: int = 64,
    kernel_size: int = 21,
) -> torch.Tensor:
    """Project each (B, N, 3) cloud under (B, C, 4) candidate poses ->
    (B, C, S, S) silhouettes.

    Without a ``scale`` the clouds project at scale 1, which gives the same
    silhouettes as the unscaled chain: a blur of values clamped to 1 with
    normalised taps stays <= 1, and the termination clip to 1 - eps follows.
    """
    B = point_cloud.shape[0]
    C = rotations.shape[1]
    S = voxel_size
    cam, w, sc = _candidate_cam(point_cloud, rotations, scale, weights)
    if sc is None:
        sc = torch.ones(B * C, dtype=torch.float32, device=point_cloud.device)
    sil = projection_silhouette(cam, S, sigma, sc, weights=w,
                                kernel_size=kernel_size)
    return sil.reshape(B, C, S, S)


def _downsample_masks(masks: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear (align_corners) mask resize to the silhouette resolution."""
    if masks.shape[-1] == size:
        return masks
    return resize_bilinear(masks, size, size)


def unsupervised_loss(
    outputs: dict,
    masks: torch.Tensor,
    sigma,
    keep_weights: torch.Tensor | None,
    num_views: int,
    voxel_size: int = 64,
    student_weight: float = 20.0,
    training: bool = True,
):
    """Ensemble min projection loss + weighted student pose loss.

    Args:
      outputs: ``UnsupervisedPart`` outputs — point_cloud (B,N,3), scale
        (B,1), ensemble_q (B*V,K,4), student_q (B*V,4).
      masks: (B*V, H, W) ground-truth silhouettes at image resolution.
      sigma: smoothing stddev (a device scalar on the scheduled path).
      keep_weights: (B, N) dropout mask or None.
      training: if False, project only under the student poses and return
        the plain projection loss.

    Returns:
      (losses dict, aux dict with ``projection`` and, for training,
      ``min_indexes``).
    """
    cloud = outputs["point_cloud"]
    scale = outputs["scale"]
    B = cloud.shape[0]
    V = num_views
    S = voxel_size
    masks_s = _downsample_masks(masks, S)  # (B*V, S, S)

    if not training:
        student_q = outputs["student_q"].reshape(B, V, 4)
        sil = project_candidates(cloud, student_q, sigma, scale=scale,
                                 weights=keep_weights, voxel_size=S)
        sil = sil.reshape(B * V, S, S)
        loss = torch.sum((sil - masks_s) ** 2) / (B * V)
        return dict(projection_loss=loss, total_loss=loss), dict(projection=sil)

    ensemble_q = outputs["ensemble_q"]  # (B*V, K, 4)
    student_q = outputs["student_q"]    # (B*V, 4)
    K = ensemble_q.shape[1]

    # K-way sweep of every candidate without gradient, then the argmin
    with torch.no_grad():
        with span("train.project"):
            sil = project_candidates(
                cloud, ensemble_q.reshape(B, V * K, 4), sigma, scale=scale,
                weights=keep_weights, voxel_size=S,
            ).reshape(B * V, K, S, S)
        per_candidate = torch.sum((sil - masks_s[:, None]) ** 2, dim=(2, 3))
        min_idx = torch.argmin(per_candidate, dim=-1)  # (B*V,)
    rows = torch.arange(B * V, device=min_idx.device)
    # gradients flow to the selected ensemble head
    best_q = ensemble_q[rows, min_idx]              # (B*V, 4)

    # the winners, differentiated: value from the sweep, backward K2
    cloud_v = cloud.repeat_interleave(V, dim=0)     # (B*V, N, 3)
    scale_v = (torch.ones(B * V, dtype=cloud.dtype, device=cloud.device)
               if scale is None else scale.reshape(B).repeat_interleave(V))
    w_v = (None if keep_weights is None
           else keep_weights.repeat_interleave(V, dim=0))
    cam_sel, w_sel, sc_sel = _candidate_cam(cloud_v, best_q[:, None], scale_v,
                                            w_v)
    sil_sel = projection_silhouette_reuse(cam_sel, S, sigma, sc_sel,
                                          sil[rows, min_idx], weights=w_sel)
    projection_loss = torch.sum((sil_sel - masks_s) ** 2) / (B * V)
    student_loss = torch.sum(
        quaternion_angle_loss(best_q.detach(), student_q)
    ) / (B * V)
    total = projection_loss + student_weight * student_loss
    losses = dict(projection_loss=projection_loss, student_loss=student_loss,
                  total_loss=total)
    return losses, dict(projection=sil, min_indexes=min_idx)


def supervised_loss(
    outputs: dict,
    poses: torch.Tensor,
    masks: torch.Tensor,
    sigma,
    keep_weights: torch.Tensor | None,
    num_views: int,
    voxel_size: int = 64,
):
    """Projection MSE under ground-truth poses (the ``SupervisedPart``
    path): a fresh differentiable projection, K1 then K2 on CUDA.

    ``poses``: (B*V, 4) ground-truth view quaternions.
    """
    cloud = outputs["point_cloud"]
    B = cloud.shape[0]
    S = voxel_size
    masks_s = _downsample_masks(masks, S)
    sil = project_candidates(
        cloud, poses.reshape(B, num_views, 4), sigma, scale=outputs["scale"],
        weights=keep_weights, voxel_size=S,
    ).reshape(B * num_views, S, S)
    loss = torch.sum((sil - masks_s) ** 2) / (B * num_views)
    return dict(projection_loss=loss, total_loss=loss), dict(projection=sil)
