"""K8 dW, the head's weight gradient, at the op ``im23d::head_conv_dw``
that the head's backward calls: reads x and the upstream g, writes dW;
2 · 25 · 3 operations per element of x."""

from portbench.lib.bounds import nbytes, peak_for

ENTRY = "im23d_tpu_torch.ops.conv:_head_conv_dw_op"
COUNTER = "im23d_tpu_torch.ops.conv:head_conv_dw_kernel"


def bound(args, out):
    x, g = args[:2]
    return nbytes(x, g, out), 2 * 25 * 3 * x.numel(), peak_for(x)
