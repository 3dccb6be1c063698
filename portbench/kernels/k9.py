"""K9 forward, a ResBlockUp's folded affine + leaky ReLU + 3 × 3 conv, at
the generator's entry ``fused_affine_conv3x3``: reads x, the affine rows
a and b and the weight, writes y; 2 · 9 · C_in · C_out operations per
output pixel."""

from portbench.lib.bounds import nbytes, peak_for

ENTRY = "im23d_tpu_torch.models.gan:fused_affine_conv3x3"
COUNTER = "im23d_tpu_torch.ops.conv:fused_affine_conv3x3_kernel"


def bound(args, out):
    x, a, b, w = args[:4]
    cin, cout = x.shape[1], w.shape[0]
    return (nbytes(x, a, b, w, out), 2 * 9 * cin * cout * x.numel() // cin,
            peak_for(x))
