"""Quaternion algebra (wxyz convention), batched over leading dims.

Counterpart of ``im23d_tpu/ops/quaternion.py``.
"""

from __future__ import annotations

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
