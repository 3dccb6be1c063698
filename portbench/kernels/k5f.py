"""K5 forward, the bilinear texture lookup, at the renderer's entry
``grid_sample_bilinear``: reads the grid and the distinct texels its
samples' corners fall on, writes C floats a sample; 12 + 8 C float32
operations a sample."""

from portbench.lib.bounds import PEAK_F32, nbytes, texels_read

ENTRY = "im23d_tpu_torch.render.renderer:grid_sample_bilinear"
COUNTER = "im23d_tpu_torch.ops.sampling:grid_sample_bilinear_kernel"


def bound(args, out):
    img, grid = args[:2]
    n, C = grid[..., 0].numel(), img.shape[-1]
    texels = texels_read(img, grid)
    return (nbytes(grid, out) + texels * C * img.element_size(),
            n * (12 + 8 * C), PEAK_F32)
