"""K2, the projection's backward, at its autograd node
(``_Projection.backward``, on the autograd thread; once a step, on the
B·V winners): reads the coordinate planes, the splat weights, the taps,
the scales and the silhouette gradient, writes the three coordinate
gradients and d scale; per voxel the blur recomputed and transposed
(4 × 126) and the termination's VJP (10), per point the splat and its
gather (64), in float32 (``chip_smoke.py``'s count)."""

from portbench.lib.bounds import PEAK_F32, nbytes

ENTRY = "im23d_tpu_torch.ops.projection:_Projection.backward"
COUNTER = "im23d_tpu_torch.ops.projection:projection_backward_kernel"


def bound(args, out):
    ctx, gsil = args[:2]
    gz, gy, gx, c, taps, scale = ctx.saved_tensors
    C, N = gz.shape
    S = gsil.shape[-1]
    return (nbytes(gz, gy, gx, c, taps, scale, gsil) + 3 * C * N * 4 + C * 4,
            C * (64 * N + 514 * S ** 3), PEAK_F32)
