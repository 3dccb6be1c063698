"""Quaternion algebra (wxyz convention), batched over leading dims.

Counterpart of ``im23d_tpu/ops/quaternion.py``; the Blender-camera
helpers at the end are host-side numpy, as there.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def qnormalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / torch.clamp(norm, min=eps)


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2. Shapes broadcast; last axis is (w, x, y, z)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        dim=-1,
    )


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (w, -x, -y, -z)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v`` (..., N, 3) by unit quaternions ``q`` (..., 4).

    Cross-product form v + 2*(w*(u x v) + u x (u x v)); ``q`` must already
    be unit length.
    """
    u = q[..., None, 1:4]
    w = q[..., None, :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def qrot_points(points: torch.Tensor, q: torch.Tensor,
                inverse: bool = False) -> torch.Tensor:
    """Rotate point clouds (..., N, 3) by (possibly unnormalized) quats (..., 4)."""
    qn = qnormalize(q)
    if inverse:
        qn = qconj(qn)
    return qrot(qn, points)


def quaternion_angle_loss(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angular difference loss 1 - Re(q1 * q2̄ / ||q1 * q2̄||)^2 per element."""
    rel = qnormalize(qmul(q1, qconj(q2)))
    return 1.0 - rel[..., 0] ** 2


def _euler_yzx_to_quat(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Extrinsic Euler 'yzx' (scipy's lowercase convention) to a wxyz
    quaternion: q = qx(roll) * qz(pitch) * qy(yaw), float64."""
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    cz, sz = math.cos(pitch / 2), math.sin(pitch / 2)
    cx, sx = math.cos(roll / 2), math.sin(roll / 2)
    qy = np.array([cy, 0.0, sy, 0.0])
    qz = np.array([cz, 0.0, 0.0, sz])
    qx = np.array([cx, sx, 0.0, 0.0])

    def mul(a, b):
        w1, x1, y1, z1 = a
        w2, x2, y2, z2 = b
        return np.array(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
                w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            ]
        )

    return mul(mul(qx, qz), qy)


def blender_camera_to_quaternion(position) -> np.ndarray:
    """Blender camera world position -> wxyz view quaternion, float32
    numpy: yaw from the horizontal direction, pitch from the elevation,
    roll 0, composed as Euler 'yzx' (parsed once per dataset item on the
    host)."""
    x, y, z = (float(v) for v in np.asarray(position).reshape(-1)[:3])
    d = math.sqrt(x * x + y * y + z * z)
    x, y, z = x / d, y / d, z / d
    d2 = math.sqrt(x * x + y * y)
    x2, y2 = x / d2, y / d2
    yaw = math.acos(np.clip(x2, -1.0, 1.0))
    if y2 > 0:
        yaw = 2 * math.pi - yaw
    pitch = math.asin(np.clip(z, -1.0, 1.0))
    yaw = yaw + math.pi
    q = _euler_yzx_to_quat(yaw, pitch, 0.0)
    return q.astype(np.float32)
