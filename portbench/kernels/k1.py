"""K1, the projection's forward, at ``ops/projection.py:_projection_forward``,
the function that holds its one launch in ``_Projection.forward`` (the
K-way sweep calls it once a step; the winner reuse launches no K1 and
does not pass here; the cull, the planes and the taps are built before):
reads the (z, y, x) planes, the splat weights (the keep mask times the
cull), the taps and the scales, writes the (C, S, S) silhouettes; per
point 8 corners × 4 operations, per voxel a 21-tap blur along three axes
(6 · 21) and the clamp and termination (5), in float32
(``chip_smoke.py``'s count).

A program without that function launches K1 inside ``_Projection.forward``
itself, which the winner reuse enters too, so no entry there holds K1
alone: the entry is then ``_silent``, which nothing calls, its counter
``_NONE`` stays at 0, and ``k1_roofline.train`` reads nothing."""

import importlib
import types

from portbench.lib.bounds import PEAK_F32, nbytes

_PROJECTION = "im23d_tpu_torch.ops.projection"


def _silent():
    """The entry where the program has no K1-only entry."""


_NONE = types.SimpleNamespace(launches=0)

if hasattr(importlib.import_module(_PROJECTION), "_projection_forward"):
    ENTRY = f"{_PROJECTION}:_projection_forward"
    COUNTER = f"{_PROJECTION}:projection_kernel"
else:
    ENTRY = "portbench.kernels.k1:_silent"
    COUNTER = "portbench.kernels.k1:_NONE"


def bound(args, out):
    gz, gy, gx, c, taps, scale, S = args[:7]
    C, N = gz.shape
    return (nbytes(gz, gy, gx, c, taps, scale, out),
            C * (32 * N + (6 * taps.numel() + 5) * S ** 3), PEAK_F32)
