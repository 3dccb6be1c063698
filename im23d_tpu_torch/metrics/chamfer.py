"""Chamfer distance between point clouds (counterpart of
``im23d_tpu/metrics/chamfer.py``).

``nn_dist2`` runs the plain ``nn_dist2_torch`` on CPU tensors and the CUDA
kernel K3 (``csrc/nn_dist2.cu``) on CUDA tensors.  ``chamfer_distance`` is the
symmetric Chamfer-L2:
``mean_n min_m ||a_n - b_m||^2 + mean_m min_n ||a_m - b_n||^2``.
"""

from __future__ import annotations

import torch

from im23d_tpu_torch.ops import _build

# y points per step of the plain version's loop
_M_CHUNK = 256


def nn_dist2_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) squared distance of each x point to its nearest y point, in the
    direct ``dz² + dy² + dx²`` form of the kernel, y taken in chunks so the
    (N, M) distance matrix never exists whole."""
    best = torch.full(x.shape[:2], float("inf"), dtype=x.dtype, device=x.device)
    xz, xy, xx = (x[..., i, None] for i in range(3))  # (B, N, 1)
    for m0 in range(0, y.shape[1], _M_CHUNK):
        yc = y[:, None, m0:m0 + _M_CHUNK]  # (B, 1, mc, 3)
        dz, dy, dx = yc[..., 0] - xz, yc[..., 1] - xy, yc[..., 2] - xx
        best = torch.minimum(best, (dz * dz + dy * dy + dx * dx).amin(-1))
    return best


def nn_dist2_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K3 on (B, N, 3) and (B, M, 3) float32 contiguous CUDA tensors.

    Replaces the Pallas kernel ``_nn_kernel``
    (``im23d_tpu/metrics/chamfer.py:56``).  Bound by CUDA-core arithmetic
    (N·M distances); one thread per x point, y streamed through shared
    memory in tiles (see ``csrc/nn_dist2.cu``).
    """
    dev = x.device
    if dev.type != "cuda" or y.device != dev:
        raise ValueError(f"nn_dist2_kernel needs CUDA tensors on one device, "
                         f"got {x.device} and {y.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 3 or t.shape[-1] != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, n, 3) tensor, "
                             f"got {tuple(t.shape)}")
    B, N, _ = x.shape
    M = y.shape[1]
    if y.shape[0] != B or min(B, N, M) < 1:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(y.shape)} do "
                         "not pair up")
    lib = _build.load_kernels()
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    rc = lib.im23d_nn_dist2(x.data_ptr(), y.data_ptr(), out.data_ptr(), B, N,
                            M, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "nn_dist2 kernel (K3)")
    nn_dist2_kernel.launches += 1
    return out


nn_dist2_kernel.launches = 0


def nn_dist2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour squared distances: plain on CPU, K3 on CUDA."""
    if x.device.type == "cpu":
        return nn_dist2_torch(x, y)
    return nn_dist2_kernel(x.float().contiguous(), y.float().contiguous())


def chamfer_distance(a: torch.Tensor, b: torch.Tensor):
    """Symmetric Chamfer-L2; returns (total, a->b term, b->a term)."""
    t1 = nn_dist2(a, b).mean(-1)
    t2 = nn_dist2(b, a).mean(-1)
    return t1 + t2, t1, t2
