"""Pipeline A networks: image encoder, point-cloud decoder, pose ensemble.

Counterpart of ``im23d_tpu/models/pointcloud_nets.py``.  Inputs are NHWC like
the JAX models; the convs run NCHW inside and flatten in NHWC order, so the
JAX ``Dense_0`` weight applies unchanged (see ``core/convert.py``).

Mixed precision follows the JAX rule: ``compute_dtype`` sets the conv/linear
compute dtype of the encoder and pose trunks (params stay float32 and are
cast at the call); the point-cloud, scale and quaternion heads always run in
float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` computed in ``x``'s dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def kaiming_init_(module: nn.Module, generator: torch.Generator) -> None:
    """He-normal (fan_in, gain 2) weights and zero biases, like the JAX
    ``variance_scaling(2.0, "fan_in", "normal")`` init, drawn from
    ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.copy_(
                    torch.randn(m.weight.shape, generator=generator,
                                device=generator.device)
                    * (2.0 / fan_in) ** 0.5
                )
                m.bias.zero_()


class ConvEncoder(nn.Module):
    """9-conv / 2-FC image encoder -> ``features``-d latent.

    16-channel convs with strides (2,2,1,2,1,2,1,2,1), kernel 5 then 3,
    symmetric k//2 padding, bias + ReLU; then flatten -> 1024 -> ReLU -> 1024.
    """

    def __init__(self, image_size: int = 128, features: int = 1024,
                 channels: int = 16,
                 strides: Sequence[int] = (2, 2, 1, 2, 1, 2, 1, 2, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        convs, cin, h = [], 3, image_size
        for i, s in enumerate(strides):
            k = 5 if i == 0 else 3
            convs.append(nn.Conv2d(cin, channels, k, stride=s, padding=k // 2))
            cin = channels
            h = (h + 2 * (k // 2) - k) // s + 1
        self.conv = nn.ModuleList(convs)
        self.dense = nn.ModuleList([
            nn.Linear(h * h * channels, features),
            nn.Linear(features, features),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, features) in ``self.dtype``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for conv in self.conv:
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype),
                                conv.bias.to(x.dtype), conv.stride,
                                conv.padding))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(_linear(self.dense[0], x))
        return _linear(self.dense[1], x)


class PointCloudDecoder(nn.Module):
    """Latent -> (point cloud in [-0.5, 0.5]³ (z, y, x), sigmoid scale)."""

    def __init__(self, z_dim: int = 1024, num_points: int = 8000):
        super().__init__()
        self.num_points = num_points
        self.points = nn.Linear(z_dim, num_points * 3)
        self.scale = nn.Linear(z_dim, 1)

    def forward(self, z: torch.Tensor):
        z = z.to(torch.float32)
        pc = torch.tanh(self.points(z).reshape(-1, self.num_points, 3)) / 2.0
        return pc, torch.sigmoid(self.scale(z))


class _PoseHead(nn.Module):
    """3-layer quaternion regression head; the last layer runs in float32."""

    def __init__(self, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.ModuleList([
            nn.Linear(hidden, hidden), nn.Linear(hidden, hidden),
            nn.Linear(hidden, 4),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_linear(self.dense[0], x.to(self.dtype)))
        x = F.relu(_linear(self.dense[1], x))
        return self.dense[2](x.to(torch.float32))


class PoseDecoder(nn.Module):
    """Ensemble of K pose regressors on a shared trunk + a student head with
    its own trunk.  Returns ``(ensemble (B, K, 4), student (B, 4))``."""

    def __init__(self, z_dim: int = 1024, hidden: int = 128,
                 num_candidates: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.student_trunk = nn.Linear(z_dim, hidden)
        self.student_head = _PoseHead(hidden, dtype)
        self.ensemble_trunk = nn.Linear(z_dim, hidden)
        self.heads = nn.ModuleList(
            _PoseHead(hidden, dtype) for _ in range(num_candidates)
        )

    def forward(self, z: torch.Tensor):
        z = z.to(self.dtype)
        student = self.student_head(F.relu(_linear(self.student_trunk, z)))
        shared = F.relu(_linear(self.ensemble_trunk, z))
        ensemble = torch.stack([h(shared) for h in self.heads], dim=1)
        return ensemble, student


class UnsupervisedPart(nn.Module):
    """Single-image point cloud + ensemble pose prediction.

    ``forward(images (B,H,W,3), pose_images (P,H,W,3))`` -> dict with
    ``point_cloud`` (B, N, 3), ``scale`` (B, 1), ``ensemble_q`` (P, K, 4),
    ``student_q`` (P, 4).  One encoder serves both image sets.
    """

    def __init__(self, image_size: int = 128, num_points: int = 8000,
                 z_dim: int = 1024, pose_hidden: int = 128,
                 num_candidates: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = ConvEncoder(image_size, features=z_dim,
                                   dtype=compute_dtype)
        self.decoder = PointCloudDecoder(z_dim, num_points)
        self.pose_decoder = PoseDecoder(z_dim, pose_hidden, num_candidates,
                                        dtype=compute_dtype)

    def forward(self, images: torch.Tensor, pose_images: torch.Tensor):
        point_cloud, scale = self.decoder(self.encoder(images))
        ensemble_q, student_q = self.pose_decoder(self.encoder(pose_images))
        return dict(point_cloud=point_cloud, scale=scale,
                    ensemble_q=ensemble_q, student_q=student_q)
