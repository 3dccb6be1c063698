"""Shape-static point dropout (counterpart of ``im23d_tpu/ops/pointcloud.py``).

All N points are kept and dropped ones get splat weight 0: exactly
``ceil(N*p)`` survivors per cloud, chosen uniformly at random.  ``p`` may be a
device tensor, so the keep-prob schedule never needs a host sync.
"""

from __future__ import annotations

import torch


def keep_mask(generator: torch.Generator, batch: int, n_points: int,
              p: torch.Tensor | float) -> torch.Tensor:
    """(B, N) float mask with exactly ceil(N*p) ones per row.

    Drawn on ``generator.device``; a rank threshold over i.i.d. uniforms.
    """
    device = generator.device
    u = torch.rand((batch, n_points), generator=generator, device=device)
    ranks = torch.argsort(torch.argsort(u, dim=-1), dim=-1)
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    m = torch.ceil(n_points * p)
    return (ranks < m).to(torch.float32)
