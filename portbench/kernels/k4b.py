"""K4 backward at the rasterizer's autograd node (``_Rasterize.backward``):
reads the face corners, attributes, both upstream gradients and the
forward's soft silhouette and winner cache, writes d corners and
d attributes; 81 float32 operations per pixel and nearby face."""

from portbench.lib.bounds import PEAK_F32, nbytes, raster_pairs

ENTRY = "im23d_tpu_torch.render.rasterizer:_Rasterize.backward"
COUNTER = "im23d_tpu_torch.render.rasterizer:rasterize_backward_kernel"
OPS_PER_PAIR = 81


def bound(args, out):
    ctx, dfeat, dsoft = args[:3]
    fv, attrs, soft, win, wz = ctx.saved_tensors
    height, width, sigma, cull = ctx.cfg
    pairs = raster_pairs(fv, height, width, sigma, cull)
    return (nbytes(fv, attrs, dfeat, dsoft, soft, win, wz, *out[:2]),
            OPS_PER_PAIR * pairs, PEAK_F32)
