"""K8 forward, the GAN's texture head (5 × 5 conv to 3 channels + tanh),
at the generator's entry ``head_conv_tanh``: reads x, the weight and the
bias, writes y; 2 · 25 · 3 operations per input element, on tensor cores
for bfloat16 x."""

from portbench.lib.bounds import nbytes, peak_for

ENTRY = "im23d_tpu_torch.models.gan:head_conv_tanh"
COUNTER = "im23d_tpu_torch.ops.conv:head_conv_kernel"


def bound(args, out):
    x, w, b = args[:3]
    return nbytes(x, w, b, out), 2 * 25 * 3 * x.numel(), peak_for(x)
