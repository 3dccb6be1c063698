"""The GAN generator's texture-head conv: 5×5 conv to 3 channels, zero H
padding and replicate or circular W padding, plus bias and tanh
(counterpart of ``head_conv_tanh`` in ``im23d_tpu/ops/conv_pallas.py``).

``head_conv_tanh`` runs the plain ``head_conv_tanh_torch`` on CPU tensors
and, on CUDA tensors, the autograd Function ``_HeadConv``: kernel K8's
forward (``csrc/head_conv.cu``) and, as its backward, g = dy·(1 − y²),
db = Σ g, dW from K8's dW kernel and dx from cuDNN's transpose conv folded
back over the W padding, as the JAX version's VJP computes dx with XLA.
Tensors are NCHW: x (B, C, H, W) in float32 or bfloat16, weight (3, C, 5, 5)
and bias (3,) float32, y (B, 3, H, W) in x's type.  The weight is rounded
to x's type before use, as the JAX model casts its kernel to the compute
dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from im23d_tpu_torch.ops import _build

KSIZE, PAD, COUT = 5, 2, 3
_PAD_MODES = ("replicate", "circular")


def _pad_w(x: torch.Tensor, pad_mode: str) -> torch.Tensor:
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}, got "
                         f"{pad_mode!r}")
    return F.pad(x, (PAD, PAD, 0, 0), mode=pad_mode)


def head_conv_tanh_torch(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor,
                         pad_mode: str = "replicate") -> torch.Tensor:
    """Plain forward: ``F.conv2d`` in float32 on the explicitly W-padded
    input (zero H padding by the conv), plus bias, tanh, cast to x's type
    (the JAX model's default branch)."""
    xp = _pad_w(x.float(), pad_mode)
    y = F.conv2d(xp, weight.to(x.dtype).float(), bias.float(),
                 padding=(PAD, 0))
    return torch.tanh(y).to(x.dtype)


def head_conv_dw_torch(x: torch.Tensor, g: torch.Tensor,
                       pad_mode: str = "replicate") -> torch.Tensor:
    """Plain dW: the weight gradient of the padded conv for the float32
    upstream ``g`` (B, 3, H, W) = dy·(1 − y²), (3, C, 5, 5) float32.

    Taken in float64: cuDNN's float32 weight gradient of this conv read a
    relative L2 error of 2.2e-2 against a float64 reference at the main
    path's shape (32 × 64 × 512 × 256, H100 80GB HBM3 at 700 W), K8's dW
    1.9e-6; a float32 reference could not tell a right kernel from a
    wrong one."""
    xp = _pad_w(x.double(), pad_mode)
    return torch.nn.grad.conv2d_weight(
        xp, (COUT, x.shape[1], KSIZE, KSIZE), g.double(),
        padding=(PAD, 0)).float()


def _check(x: torch.Tensor, pad_mode: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"K8 needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or min(x.shape) < 1:
        raise ValueError(f"x must be a contiguous non-empty NCHW tensor, got "
                         f"{tuple(x.shape)}")
    if x.shape[1] > 128:
        raise ValueError(f"K8 takes at most 128 input channels, got "
                         f"{x.shape[1]}")
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}, got "
                         f"{pad_mode!r}")


def head_conv_kernel(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor,
                     pad_mode: str = "replicate") -> torch.Tensor:
    """Launch K8's forward: x (B, C, H, W) float32 or bfloat16, weight
    (3, C, 5, 5) and bias (3,) float32, all contiguous on one CUDA device;
    returns tanh(conv + bias) (B, 3, H, W) in x's type.

    Replaces the Pallas kernel ``_fwd_kernel``
    (``im23d_tpu/ops/conv_pallas.py:91``).  Bound by bytes for bfloat16 x
    (the main path), by operations (2·25·C·3 FLOP a pixel) for float32 x;
    a block stages 8 channels of a 36 × 36 padded patch at a
    time, padding by index arithmetic, and each thread keeps 12 float32
    sums (see ``csrc/head_conv.cu``).
    """
    _check(x, pad_mode)
    B, C, H, W = x.shape
    dev = x.device
    for name, t, shape in (("weight", weight, (COUT, C, KSIZE, KSIZE)),
                           ("bias", bias, (COUT,))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape} "
                             f"tensor on {dev}")
    y = torch.empty((B, COUT, H, W), dtype=x.dtype, device=dev)
    lib = _build.load_kernels()
    rc = lib.im23d_head_conv_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), B, C,
        H, W, int(pad_mode == "circular"), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "head conv kernel (K8)")
    head_conv_kernel.launches += 1
    return y


head_conv_kernel.launches = 0


def head_conv_dw_kernel(x: torch.Tensor, g: torch.Tensor,
                        pad_mode: str = "replicate") -> torch.Tensor:
    """Launch K8's dW: x (B, C, H, W) float32 or bfloat16 and the float32
    upstream g (B, 3, H, W), contiguous on one CUDA device; returns the
    (3, C, 5, 5) float32 weight gradient.

    Replaces the Pallas kernel ``_dw_kernel``
    (``im23d_tpu/ops/conv_pallas.py:188``).  Bound by bytes for bfloat16 x
    (the TPU kernel's products take bf16 operands; the float32 upstream
    is this port's choice), by operations for float32 x; a thread
    owns one (channel, tap row) and its 15 sums, each block sums a fixed
    set of 4 × 32 tiles into its row of a partial buffer (3 rows a
    multiprocessor), and a second kernel adds the rows in order: the same
    result on every launch (see ``csrc/head_conv.cu``).
    """
    _check(x, pad_mode)
    B, C, H, W = x.shape
    dev = x.device
    if (g.device != dev or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (B, COUT, H, W)):
        raise ValueError(f"g must be a contiguous float32 {(B, COUT, H, W)} "
                         f"tensor on {dev}")
    tiles = B * -(-H // 4) * -(-W // 32)
    nrows = min(tiles, 3 * torch.cuda.get_device_properties(
        dev).multi_processor_count)
    partial = torch.empty((nrows, COUT * C * KSIZE * KSIZE),
                          dtype=torch.float32, device=dev)
    dw = torch.empty((COUT, C, KSIZE, KSIZE), dtype=torch.float32, device=dev)
    lib = _build.load_kernels()
    rc = lib.im23d_head_conv_dw(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), B, C,
        H, W, int(pad_mode == "circular"), int(x.dtype == torch.bfloat16),
        nrows, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "head conv dW kernel (K8 dW)")
    head_conv_dw_kernel.launches += 1
    return dw


head_conv_dw_kernel.launches = 0


def head_conv_dx(g: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
                 pad_mode: str) -> torch.Tensor:
    """dx of the padded conv: the transpose conv of g (in ``dtype``, as the
    JAX VJP) gives the gradient of the padded input; the zero H rows carry
    none, and the W pad columns fold back onto the columns they copied."""
    W = g.shape[-1]
    dxp = F.conv_transpose2d(g.to(dtype), weight.to(dtype),
                             padding=(PAD, 0))  # (B, C, H, W + 4)
    dx = dxp[..., PAD:PAD + W].clone()
    left, right = dxp[..., :PAD], dxp[..., PAD + W:]
    if pad_mode == "replicate":
        dx[..., :1] += left.sum(-1, keepdim=True)
        dx[..., -1:] += right.sum(-1, keepdim=True)
    else:
        dx[..., W - PAD:] += left
        dx[..., :PAD] += right
    return dx


class _HeadConv(torch.autograd.Function):
    """K8 forward; backward: g = dy·(1 − y²), db = Σ g, dW by K8's dW
    kernel, dx by ``head_conv_dx``."""

    @staticmethod
    def forward(ctx, x, weight, bias, pad_mode):
        w = weight.detach().to(x.dtype).float().contiguous()
        y = head_conv_kernel(x, w, bias.detach().float().contiguous(),
                             pad_mode)
        ctx.save_for_backward(x, w, y)
        ctx.pad_mode = pad_mode
        ctx.param_dtypes = (weight.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        yf = y.float()
        g = (dy.float() * (1.0 - yf * yf)).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = head_conv_dx(g, w, x.dtype, ctx.pad_mode)
        if ctx.needs_input_grad[1]:
            dw = head_conv_dw_kernel(x, g, ctx.pad_mode).to(
                ctx.param_dtypes[0])
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 2, 3)).to(ctx.param_dtypes[1])
        return dx, dw, db, None


def head_conv_tanh(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pad_mode: str = "replicate") -> torch.Tensor:
    """tanh(conv5x5(pad(x)) + bias) to 3 channels, NCHW: plain on CPU; on
    CUDA, K8 forward with K8's dW in the gradient."""
    if x.device.type == "cpu":
        return head_conv_tanh_torch(x, weight, bias, pad_mode)
    return _HeadConv.apply(x.contiguous(), weight, bias, pad_mode)
