"""The control's precision: every conv, transposed conv and linear layer
takes its input and weight rounded to float8 and leaves its output in
float8 (e4m3, one scale per tensor: its largest magnitude maps to 448),
as a network that keeps its activations in float8, with the gradient
passed straight through the rounding.  The step below bfloat16 that a
later change might take; the benchmark's comparison has to call it wrong.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_E4M3_MAX = 448.0


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, in ``t``'s type; the
    gradient passes as if unrounded."""
    if not t.is_floating_point():
        return t
    tf = t.detach().float()
    scale = (tf.abs().amax() / _E4M3_MAX).clamp(min=1e-30)
    q = ((tf / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (q - t).detach()


class Fp8Mode(TorchFunctionMode):
    """Inside ``with Fp8Mode():`` conv and linear operands are e4m3."""

    _OPS = {F.conv2d, F.linear, F.conv_transpose2d}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._OPS:
            args = (to_fp8(args[0]), to_fp8(args[1]), *args[2:])
            return to_fp8(func(*args, **kwargs))
        return func(*args, **kwargs)
