"""The GAN generator's convs with a hand-written kernel: the texture head
(K8) and the ResBlockUp conv2 with its folded norm (K9), counterparts of
``head_conv_tanh`` and ``fused_affine_conv3x3`` in
``im23d_tpu/ops/conv_pallas.py``.

The head is a 5×5 conv to 3 channels, zero H padding and replicate or
circular W padding, plus bias and tanh.

``head_conv_tanh`` runs the plain ``head_conv_tanh_torch`` on CPU tensors
and, on CUDA tensors, the custom op ``im23d::head_conv_tanh``: kernel K8's
forward (``csrc/head_conv.cu``: bf16 tensor-core products for bfloat16 x,
float32 FMA sums for float32 x) and, as its backward, g = dy·(1 − y²),
db = Σ g, dW from K8's dW kernel and dx from cuDNN's transpose conv folded
back over the W padding, as the JAX version's VJP computes dx with XLA.
Tensors are NCHW: x (B, C, H, W) in float32 or bfloat16, weight (3, C, 5, 5)
and bias (3,) float32, y (B, 3, H, W) in x's type.  The weight is rounded
to x's type before use, as the JAX model casts its kernel to the compute
dtype: by the forward kernel itself, and by ``head_conv_dx`` for dx.

``fused_affine_conv3x3`` is conv3x3(leaky_relu(x·a + b, 0.2)), a and b
per-(batch, channel) float32 rows (a conditional norm folded into one
multiply-add) or both None, with zero H padding and replicate or circular
W padding.  It runs the plain ``fused_affine_conv3x3_torch`` on CPU
tensors and, on CUDA tensors, the custom op
``im23d::fused_affine_conv3x3``: kernel K9's forward
(``csrc/fused_conv.cu``) and, as its backward, the JAX version's XLA VJP
written in PyTorch (cuDNN's transpose conv and weight gradient, their
operands in x's type).

Both ops are ``torch.library`` custom ops, so ``torch.export`` keeps each
as one node of the graph it traces (``serve/export.py``); importing this
module registers them, and K8's dW as ``im23d::head_conv_dw``, which the
head op's backward calls.  An op's CUDA implementation launches its kernel
or raises, its CPU implementation is the plain version (the rule for a CPU
tensor), its fake implementation gives the output's shape and dtype, and
its autograd formula is the backward above on either device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from im23d_tpu_torch.ops import _build

KSIZE, PAD, COUT = 5, 2, 3
_PAD_MODES = ("replicate", "circular")


def _pad_w(x: torch.Tensor, pad_mode: str, amount: int = PAD) -> torch.Tensor:
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}, got "
                         f"{pad_mode!r}")
    return F.pad(x, (amount, amount, 0, 0), mode=pad_mode)


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
    upstream ``g`` (B, 3, H, W) = dy·(1 − y²), rounded to x's type first
    as the JAX VJP rounds it (``conv_pallas.py:316-322``: bf16 products
    for bfloat16 x), (3, C, 5, 5) float32.

    Summed in float64: cuDNN's float32 weight gradient of this conv read a
    relative L2 error of 2.2e-2 against a float64 reference at the main
    path's shape (32 × 64 × 512 × 256, H100 80GB HBM3 at 700 W), K8's dW
    1.9e-6; a float32 reference could not tell a right kernel from a
    wrong one."""
    xp = _pad_w(x.double(), pad_mode)
    return torch.nn.grad.conv2d_weight(
        xp, (COUT, x.shape[1], KSIZE, KSIZE), g.to(x.dtype).double(),
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
    returns tanh(conv + bias) (B, 3, H, W) in x's type, the weight rounded
    to x's type by the kernel.

    Replaces the Pallas kernel ``_fwd_kernel``
    (``im23d_tpu/ops/conv_pallas.py:91``).  Bound by bytes for bfloat16 x
    (the main path): a persistent implicit GEMM on bf16 ``mma.sync`` with
    the tap column folded into N = 16 (3 outputs × 5 columns), its A
    fragments read by ldmatrix.trans straight from TMA boxes of the NCHW
    tensor, 3 boxes in flight a block.  Bound by operations (2·25·C·3
    FLOP a pixel) for float32 x: 12 float32 FMA sums a thread over a
    staged 36 × 36 patch (see ``csrc/head_conv.cu``).
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
    fwd = (lib.im23d_head_conv_fwd_bf16 if x.dtype == torch.bfloat16
           else lib.im23d_head_conv_fwd)
    rc = fwd(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
             B, C, H, W, int(pad_mode == "circular"),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "head conv kernel (K8)")
    head_conv_kernel.launches += 1
    return y


head_conv_kernel.launches = 0


def head_conv_dw_kernel(x: torch.Tensor, g: torch.Tensor,
                        pad_mode: str = "replicate") -> torch.Tensor:
    """Launch K8's dW: x (B, C, H, W) float32 or bfloat16 and the float32
    upstream g (B, 3, H, W), contiguous on one CUDA device; returns the
    (3, C, 5, 5) float32 weight gradient of g rounded to x's type, as the
    JAX VJP computes it (``head_conv_dw_torch``).

    Replaces the Pallas kernel ``_dw_kernel``
    (``im23d_tpu/ops/conv_pallas.py:188``).  Bound by bytes for bfloat16
    x: with C <= 64 (the head) bf16 ``mma.sync`` with the tap column
    folded into M = (tap column, output), x streamed a row at a time by
    TMA boxes down each 128-column tile and read once, g staged in float32
    and rounded to bf16 as its pairs are read, one persistent block an SM
    writing a partial row.
    Float32 x (bound by operations) and wider bfloat16 x run on the FMA
    units: a thread owns one (channel, tap row) and its 15 sums, each
    block sums a fixed set of 4 × 32 tiles into its row of a partial
    buffer (3 rows a multiprocessor).  A second kernel adds the rows in
    order: the same result on every launch (see ``csrc/head_conv.cu``).
    """
    _check(x, pad_mode)
    B, C, H, W = x.shape
    dev = x.device
    if (g.device != dev or g.dtype != torch.float32 or not g.is_contiguous()
            or tuple(g.shape) != (B, COUT, H, W)):
        raise ValueError(f"g must be a contiguous float32 {(B, COUT, H, W)} "
                         f"tensor on {dev}")
    # a row a block: the FMA kernel's blocks, or at most the tensor-core
    # kernel's one block an SM
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


def _fold_w_pad(dxp: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """The gradient of a W-padded map (B, C, H, W + 2·pad) folded back onto
    the columns the pad copied: the edge column (replicate) or the
    opposite edge (circular)."""
    W = dxp.shape[-1] - 2 * pad
    dx = dxp[..., pad:pad + W].clone()
    left, right = dxp[..., :pad], dxp[..., pad + W:]
    if pad_mode == "replicate":
        dx[..., :1] += left.sum(-1, keepdim=True)
        dx[..., -1:] += right.sum(-1, keepdim=True)
    else:
        dx[..., W - pad:] += left
        dx[..., :pad] += right
    return dx


def head_conv_dx(g: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype,
                 pad_mode: str) -> torch.Tensor:
    """dx of the padded conv: the transpose conv of g (in ``dtype``, as the
    JAX VJP) gives the gradient of the padded input; the zero H rows carry
    none, and the W pad columns fold back onto the columns they copied."""
    dxp = F.conv_transpose2d(g.to(dtype), weight.to(dtype),
                             padding=(PAD, 0))  # (B, C, H, W + 4)
    return _fold_w_pad(dxp, PAD, pad_mode)


@torch.library.custom_op("im23d::head_conv_tanh", mutates_args=(),
                         device_types="cuda")
def _head_conv_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  pad_mode: str) -> torch.Tensor:
    """K8 forward (``head_conv_kernel``)."""
    return head_conv_kernel(x, weight.float().contiguous(),
                            bias.float().contiguous(), pad_mode)


@torch.library.custom_op("im23d::head_conv_dw", mutates_args=(),
                         device_types="cuda")
def _head_conv_dw_op(x: torch.Tensor, g: torch.Tensor,
                     pad_mode: str) -> torch.Tensor:
    """K8 dW (``head_conv_dw_kernel``), opaque to tracers, so the head
    op's backward traces."""
    return head_conv_dw_kernel(x, g, pad_mode)


@_head_conv_dw_op.register_kernel("cpu")
def _head_conv_dw_cpu(x, g, pad_mode):
    return head_conv_dw_torch(x, g, pad_mode)


@_head_conv_dw_op.register_fake
def _head_conv_dw_fake(x, g, pad_mode):
    return x.new_empty((COUT, x.shape[1], KSIZE, KSIZE), dtype=torch.float32)


@_head_conv_op.register_kernel("cpu")
def _head_conv_cpu(x, weight, bias, pad_mode):
    return head_conv_tanh_torch(x, weight, bias, pad_mode)


@_head_conv_op.register_fake
def _head_conv_fake(x, weight, bias, pad_mode):
    return x.new_empty((x.shape[0], COUT, x.shape[2], x.shape[3]))


def _head_conv_setup(ctx, inputs, output):
    x, weight, bias, pad_mode = inputs
    ctx.save_for_backward(x, weight, output)
    ctx.pad_mode = pad_mode
    ctx.param_dtypes = (weight.dtype, bias.dtype)


def _head_conv_backward(ctx, dy):
    """g = dy·(1 − y²), db = Σ g, dW by K8's dW kernel (the op
    ``im23d::head_conv_dw``: its plain version for CPU tensors), dx by
    ``head_conv_dx``."""
    x, w, y = ctx.saved_tensors
    yf = y.float()
    g = (dy.float() * (1.0 - yf * yf)).contiguous()
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        dx = head_conv_dx(g, w, x.dtype, ctx.pad_mode)
    if ctx.needs_input_grad[1]:
        dw = _head_conv_dw_op(x, g, ctx.pad_mode).to(ctx.param_dtypes[0])
    if ctx.needs_input_grad[2]:
        db = g.sum(dim=(0, 2, 3)).to(ctx.param_dtypes[1])
    return dx, dw, db, None


_head_conv_op.register_autograd(_head_conv_backward,
                                setup_context=_head_conv_setup)


def head_conv_tanh(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pad_mode: str = "replicate") -> torch.Tensor:
    """tanh(conv5x5(pad(x)) + bias) to 3 channels, NCHW: plain on CPU; on
    CUDA, K8 forward with K8's dW in the gradient."""
    if x.device.type == "cpu":
        return head_conv_tanh_torch(x, weight, bias, pad_mode)
    return _head_conv_op(x.contiguous(), weight, bias, pad_mode)


# --- K9: folded affine + leaky ReLU + 3×3 conv ------------------------------

LRELU_SLOPE = 0.2


def _leaky(pre: torch.Tensor) -> torch.Tensor:
    """leaky ReLU with JAX's tie rule: ``pre >= 0`` keeps pre, so autograd
    passes the gradient whole at 0 (``F.leaky_relu`` passes the slope)."""
    return torch.where(pre >= 0, pre, LRELU_SLOPE * pre)


def _check_affine(a, b) -> None:
    if (a is None) != (b is None):
        raise ValueError("a and b must both be given or both be None")


def fused_affine_conv3x3_torch(x: torch.Tensor, a: torch.Tensor | None,
                               b: torch.Tensor | None, weight: torch.Tensor,
                               pad_mode: str = "replicate") -> torch.Tensor:
    """Plain forward: the affine in float32 and the leaky ReLU, rounded to
    x's type, the W pad, then ``F.conv2d`` in float32 with zero H padding
    and the weight rounded to x's type; y in x's type."""
    _check_affine(a, b)
    act = x
    if a is not None:
        act = _leaky(x.float() * a.float()[:, :, None, None]
                     + b.float()[:, :, None, None]).to(x.dtype)
    y = F.conv2d(_pad_w(act.float(), pad_mode, 1),
                 weight.to(x.dtype).float(), padding=(1, 0))
    return y.to(x.dtype)


class K9Limits(NamedTuple):
    """What K9's bf16 plan reads from the kernel library
    (``im23d_fused_conv_limits``): the card's multiprocessors and opt-in
    shared memory a block (bytes), then the kernel's own tiling constants:
    output pixels (``bm``) and channels (``bn``) a tile, input channels a
    stage (``ck``), the widest tile (``max_tw``), the most padded pixels a
    tile (``max_patch``), the bytes of one stage's weights (``wstage``)
    and of the warps' affine tables (``tables``)."""
    sms: int
    smem_optin: int
    bm: int
    bn: int
    ck: int
    max_tw: int
    max_patch: int
    wstage: int
    tables: int


def fused_conv_plan(B: int, cin: int, cout: int, H: int, W: int,
                    x_aligned: bool, lim: K9Limits) -> dict:
    """K9's bf16 plan for a (B, cin, H, W) -> cout conv under ``lim``:
    tiles of ``ti`` images × ``th`` rows × ``tw`` columns (at most
    ``bm`` pixels: 16 × 32 where W allows; shorter, or whole small images
    side by side, so that a small layer gives each multiprocessor about
    one tile; the last column tile may be partial), ``vec`` when x is
    staged by TMA boxes (W and the tile width multiples of 8, x 16-byte
    aligned, one image a tile), ``resident`` when all 9·cin weights of a
    ``bn``-channel slice fit in shared memory beside two patch buffers and
    the box, the box's columns ``bw`` and rows ``bh`` (the tile's padded
    rows and 16 columns more, widened where it fits so that a channel's
    block is an odd number of 16-byte units: ldmatrix.trans then reads
    no bank twice), and the dynamic shared memory ``smem`` it takes, as
    ``im23d_fused_conv_fwd`` counts it."""
    tw = min(W, lim.max_tw)
    th = min(H, max(1, lim.bm // tw), max(1, lim.max_patch // (tw + 2) - 2))
    nslices = -(-cout // lim.bn)
    # small layers: shorter tiles while the card would still get fewer than
    # one tile a multiprocessor
    while th > 1 and 2 * B * -(-H // th) * -(-W // tw) * nslices <= lim.sms:
        th = (th + 1) // 2
    ti = 1
    if th == H and tw == W:  # whole images, as many a tile as leaves about
        # one tile a multiprocessor
        ti = max(1, min(B, lim.bm // (H * W),
                        lim.max_patch // ((H + 2) * (W + 2)),
                        -(-B * nslices // lim.sms)))
    patch = ti * (th + 2) * (tw + 2)
    vec = x_aligned and W % 8 == 0 and tw % 8 == 0 and ti == 1
    nks = -(-cin // lim.ck)

    def smem_for(bw, bh, nw):
        # weights, patches, the box and the tables, the mbarrier's 128
        raw = -(-(lim.ck * bh * bw * 2) // 128) * 128 + lim.tables \
            if vec else 0
        return nw * lim.wstage + 2 * patch * 64 + raw + 128

    # the box: an odd number of 16-byte units a channel where it fits
    bw, bh = tw + 16, th + 2
    if (bw // 8) % 2 == 0 and bh % 2 == 0 \
            and smem_for(bw + 8, bh + 1, 2) <= lim.smem_optin:
        bw, bh = bw + 8, bh + 1
    resident = smem_for(bw, bh, nks) <= lim.smem_optin
    smem = smem_for(bw, bh, nks if resident else 2)
    return dict(ti=ti, th=th, tw=tw, vec=vec, resident=resident,
                bw=bw, bh=bh, patch=patch, smem=smem,
                tiles=-(-B // ti) * -(-H // th) * -(-W // tw) * nslices)


_K9_LIMITS: dict = {}


def k9_limits(dev: torch.device) -> K9Limits:
    """``K9Limits`` of CUDA device ``dev``, read from the library once."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _K9_LIMITS:
        lib = _build.load_kernels()
        out = (ctypes.c_int * len(K9Limits._fields))()
        _build.check(lib, lib.im23d_fused_conv_limits(key, out),
                     "K9 limits")
        _K9_LIMITS[key] = K9Limits(*out)
    return _K9_LIMITS[key]


def fused_affine_conv3x3_kernel(x: torch.Tensor, a: torch.Tensor | None,
                                b: torch.Tensor | None, weight: torch.Tensor,
                                pad_mode: str = "replicate") -> torch.Tensor:
    """Launch K9: x (B, Cin, H, W) float32 or bfloat16, a and b (B, Cin)
    float32 or both None, weight (Cout, Cin, 3, 3) (rounded to x's type),
    all contiguous on one CUDA device, Cin and Cout multiples of 16;
    returns y (B, Cout, H, W) in x's type.  Raises ``ValueError`` for any
    other operand.

    Replaces the Pallas kernel ``_fused_fwd_kernel``
    (``im23d_tpu/ops/conv_pallas.py:375``).  Bound by bytes at 64 input
    channels and by operations at 128 (bf16, blk6's 512 × 256 stage); a
    persistent implicit GEMM on the tensor cores (mma.sync) that rounds
    the float32 weight to bf16 itself (no copy of it outside the kernel),
    keeps a block's weights in shared memory where they fit, and has the
    next 32-channel stage's x brought by TMA while the current stage's
    products run, then staged channel-last with the affine, the leaky
    ReLU and the padding applied once per element; the tiling is
    ``fused_conv_plan``'s.  float32 operands run on the FMA units (see
    ``csrc/fused_conv.cu``).
    """
    _check_affine(a, b)
    if x.device.type != "cuda":
        raise ValueError(f"K9 needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or min(x.shape) < 1:
        raise ValueError(f"x must be a contiguous non-empty NCHW tensor, got "
                         f"{tuple(x.shape)}")
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {_PAD_MODES}, got "
                         f"{pad_mode!r}")
    B, C, H, W = x.shape
    dev = x.device
    if (weight.dim() != 4 or weight.shape[1:] != (C, 3, 3)
            or weight.device != dev or not weight.is_floating_point()):
        raise ValueError(f"weight must be a (Cout, {C}, 3, 3) float tensor "
                         f"on {dev}, got {tuple(weight.shape)} on "
                         f"{weight.device}")
    cout = weight.shape[0]
    if C % 16 or cout % 16:
        raise ValueError(f"K9 takes channel counts that are multiples of "
                         f"16, got {C} -> {cout}")
    if a is not None:
        for name, t in (("a", a), ("b", b)):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != (B, C) or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"{(B, C)} tensor on {dev}")
    # the kernel reads a float32 weight and rounds it to x's type itself;
    # another type is rounded to x's type first, as the plain version does
    w = weight.detach()
    if w.dtype != torch.float32:
        w = w.to(x.dtype).float()
    w = w.contiguous()
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((B, cout, H, W), dtype=x.dtype, device=dev)
    plan = dict(ti=0, th=0, tw=0, vec=False, resident=False, bw=0, bh=0)
    w9 = None
    if bf16:
        plan = fused_conv_plan(B, C, cout, H, W, x.data_ptr() % 16 == 0,
                               k9_limits(dev))
        w9 = torch.empty((3, 3, cout, C), dtype=torch.bfloat16, device=dev)
    lib = _build.load_kernels()
    rc = lib.im23d_fused_conv_fwd(
        x.data_ptr(), 0 if a is None else a.data_ptr(),
        0 if b is None else b.data_ptr(), w.data_ptr(),
        0 if w9 is None else w9.data_ptr(), y.data_ptr(), B, C, cout, H, W,
        int(pad_mode == "circular"), int(a is not None), int(bf16),
        plan["ti"], plan["th"], plan["tw"], int(plan["vec"]),
        int(plan["resident"]), plan["bw"], plan["bh"],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "fused affine conv3x3 kernel (K9)")
    fused_affine_conv3x3_kernel.launches += 1
    return y


fused_affine_conv3x3_kernel.launches = 0


def _fused_conv_bwd(x, a, b, weight, dy, pad_mode, needs):
    """The JAX VJP (``conv_pallas.py:_fused_bwd``) in PyTorch: pre and act
    recomputed in float32, dW as the weight gradient of the padded act,
    d act by the transpose conv folded back over the W pad, d pre by JAX's
    tie rule, then dx = d pre·a, da = Σ d pre·x, db = Σ d pre over H and W.
    ``needs`` flags (dx, da, db, dW); returns them, None where not needed.

    The two convs take their operands in x's type, summing in float32: for
    float32 x this is ``_fused_bwd`` exactly; for bfloat16 x they are the
    bf16 conv gradients that the JAX model's own conv VJP takes (its
    generator never calls the fused op).  float32 operands cost the CUB
    GAN's bs-32 G step 7.5 ms more on an H100 80GB HBM3 at 700 W (TF32
    convs and float32 layout transposes; ``tools/profile_eval.py --only
    gan_train``, ``PERF.md`` §6).
    """
    xf = x.float()
    act = xf
    if a is not None:
        pre = xf * a[:, :, None, None] + b[:, :, None, None]
        act = _leaky(pre)
    dyc = dy.to(x.dtype)
    wc = weight.detach().to(x.dtype)
    dx = da = db = dw = None
    if needs[3]:
        dw = torch.nn.grad.conv2d_weight(
            _pad_w(act.to(x.dtype), pad_mode, 1), wc.shape, dyc,
            padding=(1, 0)).to(weight.dtype)
    if any(needs[:3]):
        dact = _fold_w_pad(F.conv_transpose2d(dyc, wc, padding=(1, 0)), 1,
                           pad_mode).float()
        if a is None:
            dx = dact.to(x.dtype)
        else:
            dpre = torch.where(pre >= 0, dact, LRELU_SLOPE * dact)
            if needs[0]:
                dx = (dpre * a[:, :, None, None]).to(x.dtype)
            if needs[1]:
                da = (dpre * xf).sum(dim=(2, 3))
            if needs[2]:
                db = dpre.sum(dim=(2, 3))
    return dx, da, db, dw


@torch.library.custom_op("im23d::fused_affine_conv3x3", mutates_args=(),
                         device_types="cuda")
def _fused_conv_op(x: torch.Tensor, a: torch.Tensor | None,
                   b: torch.Tensor | None, weight: torch.Tensor,
                   pad_mode: str) -> torch.Tensor:
    """K9 forward (``fused_affine_conv3x3_kernel``)."""
    return fused_affine_conv3x3_kernel(x, a, b, weight, pad_mode)


@_fused_conv_op.register_kernel("cpu")
def _fused_conv_cpu(x, a, b, weight, pad_mode):
    return fused_affine_conv3x3_torch(x, a, b, weight, pad_mode)


@_fused_conv_op.register_fake
def _fused_conv_fake(x, a, b, weight, pad_mode):
    return x.new_empty((x.shape[0], weight.shape[0], x.shape[2], x.shape[3]))


def _fused_conv_setup(ctx, inputs, output):
    x, a, b, weight, pad_mode = inputs
    ctx.save_for_backward(x, a, b, weight)
    ctx.pad_mode = pad_mode


def _fused_conv_backward(ctx, dy):
    """``_fused_conv_bwd``."""
    x, a, b, weight = ctx.saved_tensors
    dx, da, db, dw = _fused_conv_bwd(
        x, a, b, weight, dy, ctx.pad_mode, ctx.needs_input_grad[:4])
    return dx, da, db, dw, None


_fused_conv_op.register_autograd(_fused_conv_backward,
                                 setup_context=_fused_conv_setup)


def fused_affine_conv3x3(x: torch.Tensor, a: torch.Tensor | None,
                         b: torch.Tensor | None, weight: torch.Tensor,
                         pad_mode: str = "replicate") -> torch.Tensor:
    """conv3x3(leaky_relu(x·a + b, 0.2)) with zero H and replicate or
    circular W padding, NCHW: plain on CPU; on CUDA, K9 forward with the
    JAX VJP's formula as its backward."""
    if x.device.type == "cpu":
        return fused_affine_conv3x3_torch(x, a, b, weight, pad_mode)
    _check_affine(a, b)
    if a is not None:
        a, b = a.contiguous(), b.contiguous()
    return _fused_conv_op(x.contiguous(), a, b, weight, pad_mode)
