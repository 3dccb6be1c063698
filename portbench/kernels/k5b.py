"""K5 backward at the texture lookup's autograd node
(``_GridSample.backward``): reads the upstream, and for the samples whose
upstream is not 0 on every channel (no other sample adds anything) their
grid and the distinct texels their corners fall on; writes d texture and
d grid; 20 + 16 C float32 operations per such sample."""

from portbench.lib.bounds import PEAK_F32, nbytes, texels_read

ENTRY = "im23d_tpu_torch.ops.sampling:_GridSample.backward"
COUNTER = "im23d_tpu_torch.ops.sampling:grid_sample_bilinear_backward_kernel"


def bound(args, out):
    ctx, dout = args[:2]
    img, grid = ctx.saved_tensors
    C = img.shape[-1]
    live = (dout != 0).any(dim=-1)
    n = live.sum()
    texels = texels_read(img, grid, live)
    return (nbytes(dout, *out[:2]) + 8 * n + texels * C * img.element_size(),
            n * (20 + 16 * C), PEAK_F32)
