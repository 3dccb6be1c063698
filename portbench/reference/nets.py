"""Frozen plain copy of the two networks the benchmark measures: the
mesh-estimation network with its ``DatasetParams`` and posing, the UV
GAN's generator and multi-scale critics with their losses, in plain
PyTorch.

It imports nothing of the program.  The layers keep the program's (and
the original torch implementation's) names, so one state dict loads into
both.  ``compute_dtype`` is the conv and linear dtype as in the program;
the benchmark builds it in float32.  The texture head is the plain 5 × 5
conv + tanh, and each ResBlockUp's conv2 the plain folded affine +
leaky ReLU + 3 × 3 conv: the functions the program's kernels K8 and K9
compute.  Batch norm takes the batch's own moments in train mode (one
process, no group).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.render import (
    adjust_poles,
    qnormalize,
    qrot,
    symmetrize_texture,
)

BN_MOMENTUM = 0.01
LRELU_SLOPE = 0.2
def replicate_pad_w(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Edge-replicate padding of the width of an NCHW map."""
    return torch.cat([x[..., :1].expand(*x.shape[:-1], amount), x,
                      x[..., -1:].expand(*x.shape[:-1], amount)], dim=-1)


def circular_pad_w(x: torch.Tensor, amount: int) -> torch.Tensor:
    """Circular padding of the width of an NCHW map."""
    return torch.cat([x[..., -amount:], x, x[..., :amount]], dim=-1)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsampling of an NCHW map."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` computed in ``x``'s dtype."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride,
                    conv.padding)


def bn_stats(bn: nn.modules.batchnorm._BatchNorm,
             xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, var): the running statistics in eval mode; in
    train mode the batch's biased variance E[x²] − E[x]², clamped at 0,
    with the running statistics moved by momentum in place."""
    if not bn.training:
        return bn.running_mean, bn.running_var
    dims = [0, *range(2, xf.dim())]
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    return mean, var


def _bn(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch norm in float32, returned in ``x``'s dtype: the running
    statistics in eval mode; in train mode flax's batch statistics and
    running-statistics update (updated in place)."""
    xf = x.float()
    if not bn.training:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps).to(x.dtype)
    mean, var = bn_stats(bn, xf)
    shape = [1, -1] + [1] * (xf.dim() - 2)
    mul = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        mul = mul * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape)
    if bn.bias is not None:
        y = y + bn.bias.view(shape)
    return y.to(x.dtype)


def _batch_norm(ch: int, dims: int = 2):
    cls = nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d
    return cls(ch, eps=1e-5, momentum=BN_MOMENTUM)


class ResBlock(nn.Module):
    """conv-bn-relu twice plus a shortcut (a 1x1 conv when the channel count
    changes); the 3x3 convs pad the height with zeros and the width with
    ``pad_fn``."""

    def __init__(self, ch_in: int, ch_out: int, pad_fn=replicate_pad_w):
        super().__init__()
        self.pad_fn = pad_fn
        self.conv1 = nn.Conv2d(ch_in, ch_in, 3, padding=(1, 0), bias=False)
        self.bn1 = _batch_norm(ch_in)
        self.conv2 = nn.Conv2d(ch_in, ch_out, 3, padding=(1, 0), bias=False)
        self.bn2 = _batch_norm(ch_out)
        self.shortcut = (nn.Conv2d(ch_in, ch_out, 1, bias=False)
                         if ch_in != ch_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else _conv(self.shortcut, x)
        h = F.relu(_bn(self.bn1, _conv(self.conv1, self.pad_fn(x, 1))))
        h = F.relu(_bn(self.bn2, _conv(self.conv2, self.pad_fn(h, 1))))
        return h + shortcut


class ReconstructionNetwork(nn.Module):
    """RGBA image -> texture (tanh) and a mesh displacement map.

    Encoder: five stride-2 conv-bn-relu (kernel 5 then 3), two linear-bn-relu
    (256, 1024).  Decoder: ``fc1_tex`` to a (256, 4, base_w) map, three
    ResBlock + 2x upsample stages to 32 rows, then a mesh head
    (``blk4_mesh``, ``conv_mesh``, zero-initialised; poles averaged) and a
    texture head (``blk3b_tex``/``blk3c_tex`` for 128/256 textures,
    ``blk4_tex``, ``blk5_tex``, ``conv_tex``, tanh).  When ``symmetric``,
    the decoder is half width and both maps are mirrored to full width.
    """

    def __init__(self, symmetric: bool = True, texture_res: int = 64,
                 mesh_res: int = 32, image_res: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if texture_res not in (64, 128, 256):
            raise ValueError(f"texture_res must be 64, 128 or 256, got "
                             f"{texture_res}")
        self.symmetric = symmetric
        self.texture_res = texture_res
        self.mesh_res = mesh_res
        self.compute_dtype = compute_dtype
        self.pad = replicate_pad_w if symmetric else circular_pad_w
        self.base_w = 2 if symmetric else 4
        enc = [(4, 64, 5), (64, 128, 3), (128, 256, 3), (256, 512, 3),
               (512, 64, 3)]
        for i, (ci, co, k) in enumerate(enc, start=1):
            setattr(self, f"conv{i}e", nn.Conv2d(ci, co, k, stride=2,
                                                 padding=k // 2, bias=False))
            setattr(self, f"bn{i}e", _batch_norm(co))
        side = image_res
        for _, _, k in enc:
            side = (side + 2 * (k // 2) - k) // 2 + 1
        self.fc1e = nn.Linear(64 * side * side, 256, bias=False)
        self.bnfc1e = _batch_norm(256, dims=1)
        self.fc3e = nn.Linear(256, 1024, bias=False)
        self.bnfc3e = _batch_norm(1024, dims=1)
        self.fc1_tex = nn.Linear(1024, 4 * self.base_w * 256)
        pad = self.pad
        self.blk1 = ResBlock(256, 512, pad)
        self.blk2 = ResBlock(512, 256, pad)
        self.blk3 = ResBlock(256, 256, pad)
        if texture_res >= 128:
            self.blk3b_tex = ResBlock(256, 256, pad)
        if texture_res >= 256:
            self.blk3c_tex = ResBlock(256, 256, pad)
        self.blk4_mesh = ResBlock(256, 64, pad)
        self.conv_mesh = nn.Conv2d(64, 3, 5, padding=(2, 0))
        self.blk4_tex = ResBlock(256, 128, pad)
        self.blk5_tex = ResBlock(128, 64, pad)
        self.conv_tex = nn.Conv2d(64, 3, 5, padding=(2, 0))

    def forward(self, x: torch.Tensor):
        """(B, H, W, 4) -> (texture (B, T, T, 3), mesh map (B, M, M, 3)),
        both NHWC float32."""
        h = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        for i in range(1, 6):
            h = F.relu(_bn(getattr(self, f"bn{i}e"),
                           _conv(getattr(self, f"conv{i}e"), h)))
        h = h.reshape(h.shape[0], -1)  # CHW flatten, as the reference
        w = self.fc1e.weight.to(h.dtype)
        z = F.relu(_bn(self.bnfc1e, F.linear(h, w)))
        z = F.relu(_bn(self.bnfc3e, F.linear(z, self.fc3e.weight.to(z.dtype))))
        bb = F.linear(z, self.fc1_tex.weight.to(z.dtype),
                      self.fc1_tex.bias.to(z.dtype))
        bb = bb.reshape(-1, 256, 4, self.base_w)
        for blk in (self.blk1, self.blk2, self.blk3):
            bb = upsample_nearest(blk(bb))
        bb_mesh = bb
        if self.texture_res >= 128:
            bb = upsample_nearest(self.blk3b_tex(bb))
        if self.texture_res >= 256:
            bb = upsample_nearest(self.blk3c_tex(bb))

        mesh_map = self.blk4_mesh(bb_mesh)
        mesh_map = _conv(self.conv_mesh, self.pad(F.relu(mesh_map), 2))
        mesh_map = adjust_poles(mesh_map.float().permute(0, 2, 3, 1))

        tex = upsample_nearest(self.blk4_tex(bb))
        tex = self.blk5_tex(tex)
        tex = torch.tanh(_conv(self.conv_tex, self.pad(F.relu(tex), 2))
                         .float()).permute(0, 2, 3, 1)
        if self.symmetric:
            tex = symmetrize_texture(tex)
            mesh_map = symmetrize_texture(mesh_map)
        return tex.contiguous(), mesh_map.contiguous()


class DatasetParams(nn.Module):
    """Learnable per-image pose refinement.

    Indices in [N, 2N) are the mirrored images: their x translation flips
    sign.  ``mode='deltas'`` -> (translation (B, 3), scale (B, 1));
    ``mode='z0'`` -> the perspective factor 1 + exp(z0), (B, 1).  With no
    indices the mean over the dataset is used.
    """

    def __init__(self, dataset_size: int, optimize_deltas: bool = True,
                 optimize_z0: bool = False):
        super().__init__()
        self.dataset_size = dataset_size
        if optimize_deltas:
            self.ds_translation = nn.Parameter(torch.zeros(dataset_size, 2))
            self.ds_scale = nn.Parameter(torch.zeros(dataset_size, 1))
        if optimize_z0:
            self.ds_z0 = nn.Parameter(torch.ones(dataset_size, 1))

    def forward(self, indices: torch.Tensor | None, mode: str):
        if mode not in ("deltas", "z0"):
            raise ValueError(f"mode must be 'deltas' or 'z0', got {mode!r}")
        N = self.dataset_size
        if indices is not None:
            indices = indices.long()
            x_sign = (1.0 - 2.0 * (indices // N).float())[:, None]
            idx = indices % N

        def pick(p):
            return p[idx] if indices is not None else p.mean(0, keepdim=True)

        if mode == "deltas":
            t = pick(self.ds_translation)
            s = pick(self.ds_scale)
            tx = t[:, :1] * x_sign if indices is not None else t[:, :1]
            return torch.cat([tx, t[:, 1:2], torch.zeros_like(t[:, :1])],
                             dim=1), s
        return 1.0 + torch.exp(pick(self.ds_z0))


def transform_vertices(vtx, scale, translation, rotation,
                       translation_delta=0.0, scale_delta=0.0, z0=None):
    """Pose (B, V, 3) vertices into screen space: normalise the quaternion,
    scale, rotate, translate, flip (y, z), and apply the optional z0
    perspective factor."""
    s = (scale + scale_delta).reshape(-1, 1, 1)
    v = qrot(qnormalize(rotation), s * vtx)
    if torch.is_tensor(translation_delta):
        translation = translation + translation_delta
    v = v + translation[:, None, :]
    v = v * v.new_tensor([1.0, -1.0, -1.0])
    if z0 is not None:
        z = v[..., 2:]
        factor = (z0[:, None] + z / 2.0) / (z0[:, None] - z / 2.0)
        v = torch.cat([v[..., :2] * factor, z], dim=-1)
    return v


# --- the GAN -----------------------------------------------------------------

def _leaky(pre: torch.Tensor) -> torch.Tensor:
    """leaky ReLU with JAX's tie rule: ``pre >= 0`` keeps pre, so autograd
    passes the gradient whole at 0 (``F.leaky_relu`` passes the slope)."""
    return torch.where(pre >= 0, pre, LRELU_SLOPE * pre)


def _pad_w(x: torch.Tensor, pad_mode: str, amount: int) -> torch.Tensor:
    return F.pad(x, (amount, amount, 0, 0), mode=pad_mode)


def head_conv_tanh(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   pad_mode: str = "replicate") -> torch.Tensor:
    """The texture head: 5 × 5 conv to 3 channels in float32 on the
    W-padded input (zero H padding), plus bias, tanh, in x's type."""
    xp = _pad_w(x.float(), pad_mode, 2)
    y = F.conv2d(xp, weight.to(x.dtype).float(), bias.float(),
                 padding=(2, 0))
    return torch.tanh(y).to(x.dtype)


def fused_affine_conv3x3(x: torch.Tensor, a: torch.Tensor | None,
                         b: torch.Tensor | None, weight: torch.Tensor,
                         pad_mode: str = "replicate") -> torch.Tensor:
    """conv3x3(leaky_relu(x·a + b, 0.2)): the affine in float32, rounded to
    x's type, the W pad, the conv in float32 with zero H padding."""
    act = x
    if a is not None:
        act = _leaky(x.float() * a.float()[:, :, None, None]
                     + b.float()[:, :, None, None]).to(x.dtype)
    y = F.conv2d(_pad_w(act.float(), pad_mode, 1),
                 weight.to(x.dtype).float(), padding=(1, 0))
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """The JAX ``GANConfig``'s fields and defaults."""

    texture_resolution: int = 512
    mesh_resolution: int = 32
    symmetric_g: bool = True
    texture_only: bool = False
    conditional_class: bool = False
    conditional_color: bool = False
    conditional_text: bool = False
    norm_g: str = "batch"  # batch | instance | none
    norm_d: str = "none"   # instance | none
    latent_dim: int = 64
    num_discriminators: int = 2
    mask_output: bool = True
    n_classes: Sequence[int] = (200,)
    text_embedding_dim: int = 256
    compute_dtype: str = "float32"
    wide_hires: bool = False

    def __post_init__(self):
        if self.wide_hires:
            raise NotImplementedError("wide_hires is not ported")
        if self.num_discriminators not in (2, 3):
            raise ValueError(f"num_discriminators must be 2 or 3, got "
                             f"{self.num_discriminators}")

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def positional_encoding(ny: int, nx: int) -> np.ndarray:
    """Sine-cosine embedding wrapping around x, (ny, nx', 4) NHWC; the
    middle half of the columns when nx = ny / 2 (symmetric critics)."""
    symmetric = nx == ny // 2
    nx = ny
    ty = np.linspace(0, np.pi, ny, endpoint=False)
    tx = np.linspace(-np.pi, np.pi, nx, endpoint=False)
    Y, X = np.meshgrid(tx, ty)
    result = np.stack([np.cos(X), np.sin(X), np.cos(Y), np.sin(Y)], axis=-1)
    if symmetric:
        q = result.shape[1] // 4
        return result[:, q:-q].astype(np.float32)
    return result.astype(np.float32)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def avg_pool_box(x: torch.Tensor, k: int) -> torch.Tensor:
    """k × k box pooling of an NCHW map (the JAX version's box-matrix
    contraction equals ``nn.avg_pool`` for divisible k)."""
    return F.avg_pool2d(x, k) if k > 1 else x


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` computed in ``x``'s dtype."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


class SNConv2d(nn.Module):
    """Conv2d with flax's spectral norm (see the module docstring); the
    input's dtype is the compute dtype."""

    def __init__(self, ch_in: int, ch_out: int, kernel_size: int,
                 stride: int = 1, padding=(0, 0), bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(
            torch.empty(ch_out, ch_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(ch_out)) if bias else None
        self.register_buffer("weight_u", torch.empty(ch_out))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1)  # (out, in·kh·kw)
        with torch.no_grad():
            v = _l2_normalize(self.weight_u[None] @ mat)
            u = _l2_normalize(v @ mat.T)
        sigma = (v @ mat.T @ u.T)[0, 0]
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u[0])
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.normalized_weight().to(x.dtype), bias,
                        self.stride, self.padding)


class ConditionalNorm(nn.Module):
    """Norm without affine, then h·(1 + γ(z)) + β(z) (reference
    ``ConditionalBatchNorm2d``); batch norm is flax's (``_bn``)."""

    def __init__(self, ch: int, z_dim: int, norm: str):
        super().__init__()
        if norm not in ("batch", "instance", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        self.kind = norm
        if norm == "batch":
            self.norm = nn.BatchNorm2d(ch, eps=1e-5, momentum=BN_MOMENTUM,
                                       affine=False)
        self.fc_gamma = nn.Linear(z_dim, ch)
        self.fc_beta = nn.Linear(z_dim, ch)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if self.kind == "batch":
            h = _bn(self.norm, x)
        elif self.kind == "instance":
            xf = x.float()
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
            h = ((xf - mean) / torch.sqrt(var + 1e-5)).to(x.dtype)
        else:
            h = x
        gamma = _linear(self.fc_gamma, z)[:, :, None, None]
        beta = _linear(self.fc_beta, z)[:, :, None, None]
        return h * (1.0 + gamma) + beta

    def fold(self, x: torch.Tensor,
             z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This norm of ``x`` as one multiply-add per (batch, channel):
        float32 rows (a, b) of shape (B, C) with forward(x, z) = x·a + b
        up to rounding, a = rsqrt(var + eps)·(1 + γ), b = β − mean·a.  The
        batch norm's statistics are ``bn_stats``'s (running statistics
        updated once in train mode), the instance norm's per (b, c)."""
        gamma = _linear(self.fc_gamma, z).float()
        beta = _linear(self.fc_beta, z).float()
        if self.kind == "none":
            return (1.0 + gamma).contiguous(), beta.contiguous()
        xf = x.float()
        if self.kind == "batch":
            mean, var = bn_stats(self.norm, xf)
            eps = self.norm.eps
        else:
            mean = xf.mean(dim=(2, 3))
            var = xf.var(dim=(2, 3), unbiased=False)
            eps = 1e-5
        a = torch.rsqrt(var + eps) * (1.0 + gamma)
        return a.contiguous(), (beta - mean * a).contiguous()


class ResBlockUp(nn.Module):
    """Spectral-norm 3 × 3 conv block with conditional norm (no upsampling
    inside); the width pads as ``pad_mode`` says ("replicate" or
    "circular"), the height with zeros.  norm1 and its leaky ReLU are
    folded into conv2: ``fused_affine_conv3x3``, kernel K9 on CUDA."""

    def __init__(self, ch_in: int, ch_out: int, z_dim: int, norm: str,
                 pad_mode: str):
        super().__init__()
        ch_mid = min(ch_in, ch_out)
        self.pad_mode = pad_mode
        self.pad_fn = {"replicate": replicate_pad_w,
                       "circular": circular_pad_w}[pad_mode]
        self.shortcut = (SNConv2d(ch_in, ch_out, 1, bias=False)
                         if ch_in != ch_out else None)
        self.conv1 = SNConv2d(ch_in, ch_mid, 3, padding=(1, 0), bias=False)
        self.norm1 = ConditionalNorm(ch_mid, z_dim, norm)
        self.conv2 = SNConv2d(ch_mid, ch_out, 3, padding=(1, 0), bias=False)
        self.norm2 = ConditionalNorm(ch_out, z_dim, norm)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        h = self.conv1(self.pad_fn(x, 1))
        a, b = self.norm1.fold(h, z)
        h = fused_affine_conv3x3(h, a, b, self.conv2.normalized_weight(),
                                 self.pad_mode)
        h = leaky_relu(self.norm2(h, z))
        return h + shortcut


class SpatialAttention(nn.Module):
    """AttnGAN-style word / region attention: a 1 × 1 ``conv_context`` (no
    bias) takes the word features to the map's channels, the logits q·ctxᵀ
    are formed in float32 from the compute-dtype operands (the JAX
    version's ``preferred_element_type``), padded words get − 1e4, the
    softmax over words runs in float32 and attn·ctx in the compute dtype.
    """

    def __init__(self, ctx_dim: int, ch: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv_context = nn.Conv2d(ctx_dim, ch, 1, bias=False)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: torch.Tensor | None = None):
        """x (B, C, H, W), context (B, L, ctx_dim), mask (B, L) True where
        padded -> (out (B, C, H, W) in the compute dtype, attention map
        (B, H, W, L) float32)."""
        B, C, H, W = x.shape
        w = self.conv_context.weight[:, :, 0, 0].to(self.dtype)
        ctx = F.linear(context.to(self.dtype), w)  # (B, L, C)
        q = x.reshape(B, C, H * W).transpose(1, 2)
        attn = torch.matmul(q.float(), ctx.float().transpose(1, 2))
        if mask is not None:
            attn = attn - 1e4 * mask[:, None, :].float()
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(ctx.dtype), ctx)  # (B, HW, C)
        return (out.transpose(1, 2).reshape(B, C, H, W),
                attn.reshape(B, H, W, -1))


class HeadConvTanh(nn.Module):
    """``conv_final`` + tanh: (3, C, 5, 5) weight and bias, kernel K8 on
    CUDA, the plain conv on the CPU."""

    def __init__(self, ch_in: int, pad_mode: str):
        super().__init__()
        self.pad_mode = pad_mode
        self.weight = nn.Parameter(torch.empty(3, ch_in, 5, 5))
        self.bias = nn.Parameter(torch.zeros(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_conv_tanh(x, self.weight, self.bias, self.pad_mode)


class Generator(nn.Module):
    """z (+ class embedding) -> (texture in [-1, 1], mesh displacement map):
    an 8 × 8 base of 512 channels (half width when symmetric), ResBlockUp
    stages by texture resolution, the K8 texture head, a zero-initialised
    mesh conv with ``adjust_poles``, both maps mirrored when symmetric."""

    def __init__(self, cfg: GANConfig, mesh_head: bool = True):
        super().__init__()
        self.cfg = cfg
        self.mesh_head = mesh_head
        emb = cfg.latent_dim
        z_dim = cfg.latent_dim
        if cfg.conditional_class:
            if cfg.conditional_color:
                self.emb_class = nn.Embedding(cfg.n_classes[0], emb // 2)
                self.emb_color = nn.Embedding(cfg.n_classes[1], emb // 2)
            else:
                self.emb_class = nn.Embedding(cfg.n_classes[0], emb)
            z_dim += emb
        self.pad = replicate_pad_w if cfg.symmetric_g else circular_pad_w
        pad_mode = "replicate" if cfg.symmetric_g else "circular"
        self.base_w = 4 if cfg.symmetric_g else 8
        self.fc = nn.Linear(z_dim, 8 * self.base_w * 512)

        def blk(ci, co):
            return ResBlockUp(ci, co, z_dim, cfg.norm_g, pad_mode)

        self.blk1 = blk(512, 512)
        self.blk2 = blk(512, 256)
        if cfg.conditional_text:
            self.att = SpatialAttention(cfg.text_embedding_dim, 256, cfg.dtype)
        self.tex_stages = [n for n, r in (("blk3a", 256), ("blk3b", 512),
                                          ("blk3c", 1024))
                           if cfg.texture_resolution >= r]
        for name in self.tex_stages:
            setattr(self, name, blk(256, 256))
        self.blk4 = blk(256, 128)
        self.blk5 = blk(128, 128)
        self.blk6 = blk(128, 64)
        self.conv_final = HeadConvTanh(64, pad_mode)
        if mesh_head:
            self.blk3_mesh = blk(256, 64)
            self.conv_mesh = nn.Conv2d(64, 3, 5, padding=(2, 0))

    def forward(self, z: torch.Tensor, c: torch.Tensor | None = None,
                caption=None, return_attention: bool = False):
        """-> (texture, mesh map), and the attention map (B, 16, W, L)
        mirrored as the texture, or None, when ``return_attention``."""
        cfg = self.cfg
        dt = cfg.dtype
        if cfg.conditional_class:
            if c is None:
                raise ValueError("a class-conditional generator needs c")
            c = c.long()
            if cfg.conditional_color:
                z = torch.cat([z, self.emb_class(c[:, 0]),
                               self.emb_color(c[:, 1])], dim=1)
            else:
                z = torch.cat([z, self.emb_class(c[:, 0])], dim=1)
        z = z.to(dt)
        x = _linear(self.fc, z).reshape(z.shape[0], 512, 8, self.base_w)
        x = upsample_nearest(self.blk1(x, z))
        x = self.blk2(x, z)
        attn_map = None
        if cfg.conditional_text and caption is not None:
            att_out, attn_map = self.att(x, caption[0], caption[1])
            x = x + att_out
        x = upsample_nearest(x)

        x_tex = x
        for name in self.tex_stages:
            x_tex = upsample_nearest(getattr(self, name)(x_tex, z))
        x_tex = upsample_nearest(self.blk4(x_tex, z))
        x_tex = upsample_nearest(self.blk5(x_tex, z))
        x_tex = leaky_relu(self.blk6(x_tex, z))
        tex = self.conv_final(x_tex).permute(0, 2, 3, 1)

        mesh = None
        if self.mesh_head:
            x_mesh = leaky_relu(self.blk3_mesh(x, z))
            w = self.conv_mesh.weight.to(dt)
            x_mesh = F.conv2d(self.pad(x_mesh, 2), w,
                              self.conv_mesh.bias.to(dt), padding=(2, 0))
            mesh = adjust_poles(x_mesh.float().permute(0, 2, 3, 1))

        if cfg.symmetric_g:
            tex = symmetrize_texture(tex)
            if mesh is not None:
                mesh = symmetrize_texture(mesh)
            if attn_map is not None:
                attn_map = symmetrize_texture(attn_map)
        out = tex.contiguous(), (None if mesh is None else mesh.contiguous())
        return (*out, attn_map) if return_attention else out


class _InstanceNormAffine(nn.Module):
    """flax ``GroupNorm(group_size=1)``: per-channel instance norm with
    scale and bias, eps 1e-6, in float32 (reference affine InstanceNorm2d
    names ``weight``/``bias``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), x.shape[1], self.weight, self.bias,
                            eps=1e-6)


def _pe(h: int, w: int, like: torch.Tensor) -> torch.Tensor:
    pe = torch.as_tensor(positional_encoding(h, w), device=like.device)
    return pe.permute(2, 0, 1)[None].expand(like.shape[0], -1, -1, -1).to(
        like.dtype)


class _Critic(nn.Module):
    """Shared tail of both critics: the spectral-norm conv stack, the
    optional instance norms and the class projection or text term."""

    def _norm(self, name: str, h: torch.Tensor) -> torch.Tensor:
        norm = getattr(self, name, None)
        return h if norm is None else norm(h)

    def _conv(self, conv: SNConv2d, h: torch.Tensor, pad: int):
        """``conv`` on the width-circularly padded ``h`` in the compute
        dtype (the instance norms leave float32, as flax's GroupNorm)."""
        return conv(circular_pad_w(h.to(self.cfg.dtype), pad))

    def _project(self, y, h, c, caption):
        """The class projection, or without class conditioning the text
        term Σ_c h·att(h, caption)."""
        if not self.cfg.conditional_class:
            if self.cfg.conditional_text and caption is not None:
                att_out, _ = self.att(h, caption[0], caption[1])
                y = y + (h * att_out).float().sum(dim=1, keepdim=True)
            return y
        c = c.long()
        emb = self.projector(c[:, 0])
        if self.cfg.conditional_color:
            emb = emb + self.projector_col1(c[:, 1])
        return y + (h.float() * emb[:, :, None, None]).sum(dim=1, keepdim=True)

    def _make_norms(self, cfg, chans):
        if cfg.norm_d == "instance":
            for name, ch in chans:
                setattr(self, name, _InstanceNormAffine(ch))
        elif cfg.norm_d != "none":
            raise ValueError(f"unknown norm_d {cfg.norm_d!r}")

    def _make_projector(self, cfg, ch):
        if cfg.conditional_class:
            self.projector = nn.Embedding(cfg.n_classes[0], ch)
            if cfg.conditional_color:
                self.projector_col1 = nn.Embedding(cfg.n_classes[1], ch)
        elif cfg.conditional_text:
            self.att = SpatialAttention(cfg.text_embedding_dim, ch, cfg.dtype)


class TextureDiscriminator(_Critic):
    """Texture critic at 1 / ``downsample`` resolution."""

    def __init__(self, cfg: GANConfig, downsample: int = 1):
        super().__init__()
        self.cfg = cfg
        self.downsample = downsample
        self.stride_first = ((downsample == 1 and cfg.texture_resolution >= 512)
                             or cfg.texture_resolution >= 1024
                             or cfg.conditional_text)
        bias = cfg.norm_d != "instance"
        if self.stride_first:
            self.conv1 = SNConv2d(8, 64, 4, stride=2, padding=(1, 0))
        else:
            self.conv1 = SNConv2d(8, 64, 5, padding=(2, 0))
        self.conv2 = SNConv2d(64, 128, 4, 2, (1, 0), bias)
        self.conv3 = SNConv2d(128, 256, 4, 2, (1, 0), bias)
        self.conv4 = SNConv2d(256, 512, 4, 2, (1, 0), bias)
        self.conv5 = SNConv2d(512, 1, 5, padding=(2, 0))
        self._make_norms(cfg, (("bn2", 128), ("bn3", 256), ("bn4", 512)))
        self._make_projector(cfg, 512)

    def forward(self, x, c=None, alpha=None, caption=None):
        """x (B, H, W, 4) NHWC; alpha (B, H, W, 1), the channel 3 of x
        when given -> (prediction (B, 1, h, w) float32, mask or None)."""
        cfg = self.cfg
        x = avg_pool_box(x.permute(0, 3, 1, 2), self.downsample)
        mask = None
        if cfg.mask_output:
            ds = 16 if self.stride_first else 8
            pooled = (avg_pool_box(x[:, 3:4], ds) if alpha is None else
                      avg_pool_box(alpha.permute(0, 3, 1, 2),
                                   self.downsample * ds))
            mask = pooled.detach().float()
        x = torch.cat([x, _pe(x.shape[2], x.shape[3], x)], dim=1)
        h = leaky_relu(self._conv(self.conv1, x, 1 if self.stride_first else 2))
        h = leaky_relu(self._norm("bn2", self._conv(self.conv2, h, 1)))
        h = leaky_relu(self._norm("bn3", self._conv(self.conv3, h, 1)))
        h = leaky_relu(self._norm("bn4", self._conv(self.conv4, h, 1)))
        y = self._conv(self.conv5, h, 2).float()
        return self._project(y, h, c, caption), mask


class MeshDiscriminator(_Critic):
    """Mesh-resolution critic over (texture pooled to the mesh map, mesh
    map)."""

    def __init__(self, cfg: GANConfig):
        super().__init__()
        self.cfg = cfg
        bias = cfg.norm_d != "instance"
        self.conv1 = SNConv2d(11, 64, 5, padding=(2, 0))
        self.conv2 = SNConv2d(64, 128, 4, 2, (1, 0), bias)
        self.conv3 = SNConv2d(128, 256, 4, 2, (1, 0), bias)
        self.conv4 = SNConv2d(256, 1, 5, padding=(2, 0))
        self._make_norms(cfg, (("bn2", 128), ("bn3", 256)))
        self._make_projector(cfg, 256)

    def forward(self, texture, mesh_map, c=None, alpha=None, caption=None):
        cfg = self.cfg
        pool = texture.shape[1] // mesh_map.shape[1]
        x = avg_pool_box(texture.permute(0, 3, 1, 2), pool)
        x = torch.cat([x, mesh_map.permute(0, 3, 1, 2).to(x.dtype)], dim=1)
        mask = None
        if cfg.mask_output:
            pooled = (avg_pool_box(x[:, 3:4], 4) if alpha is None else
                      avg_pool_box(alpha.permute(0, 3, 1, 2), pool * 4))
            mask = pooled.detach().float()
        x = torch.cat([x, _pe(x.shape[2], x.shape[3], x)], dim=1)
        h = leaky_relu(self._conv(self.conv1, x, 2))
        h = leaky_relu(self._norm("bn2", self._conv(self.conv2, h, 1)))
        h = leaky_relu(self._norm("bn3", self._conv(self.conv3, h, 1)))
        y = self._conv(self.conv4, h, 2).float()
        return self._project(y, h, c, caption), mask


class MultiScaleDiscriminator(nn.Module):
    """d1 = the full texture, d2 = the mesh (the texture at 1/2 when
    ``texture_only``), d3 = the texture at 1/4 when there are 3."""

    def __init__(self, cfg: GANConfig):
        super().__init__()
        self.cfg = cfg
        self.d1 = TextureDiscriminator(cfg, 1)
        self.d2 = (TextureDiscriminator(cfg, 2) if cfg.texture_only
                   else MeshDiscriminator(cfg))
        if cfg.num_discriminators == 3:
            self.d3 = TextureDiscriminator(cfg, 4)

    def forward(self, x, mesh_map=None, c=None, alpha=None, caption=None):
        """-> (predictions, masks), one of each per critic."""
        outs = [self.d1(x, c, alpha, caption)]
        if self.cfg.texture_only:
            outs.append(self.d2(x, c, alpha, caption))
        else:
            outs.append(self.d2(x, mesh_map, c, alpha, caption))
        if self.cfg.num_discriminators == 3:
            outs.append(self.d3(x, c, alpha, caption))
        return [o[0] for o in outs], [o[1] for o in outs]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None,
                 weight) -> torch.Tensor:
    w = 1.0 if weight is None else weight
    if mask is None:
        return x.mean() * w
    per_sample = (x * mask).sum(dim=(1, 2, 3)) / torch.clamp(
        mask.sum(dim=(1, 2, 3)), min=1e-12)
    return per_sample.mean() * w


def _single_gan_loss(pred, target_is_real: bool, for_discriminator: bool,
                     mask, weight, mode: str) -> torch.Tensor:
    if mode == "original":
        target = 1.0 if target_is_real else 0.0
        return (torch.clamp(pred, min=0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    if mode == "ls":
        target = 1.0 if target_is_real else 0.0
        return ((pred - target) ** 2).mean()
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return -_masked_mean(torch.clamp(pred - 1.0, max=0.0), mask,
                                     weight)
            return -_masked_mean(torch.clamp(-pred - 1.0, max=0.0), mask,
                                 weight)
        if not target_is_real:
            raise ValueError("the generator's hinge loss aims for real")
        return -_masked_mean(pred, mask, weight)
    if mode == "w":
        return -pred.mean() if target_is_real else pred.mean()
    raise ValueError(f"unknown GAN loss mode {mode!r}")


def gan_loss(preds, target_is_real: bool, for_discriminator: bool = True,
             masks=None, weights=None, mode: str = "hinge") -> torch.Tensor:
    """One prediction, or the mean over critics (the weighted sum divided
    by the weights' sum when per-critic ``weights`` are given); masks weigh
    the hinge terms per sample.  Predictions and masks are (B, 1, h, w)."""
    if not isinstance(preds, (list, tuple)):
        return _single_gan_loss(preds, target_is_real, for_discriminator,
                                masks, None, mode)
    total = 0.0
    for i, p in enumerate(preds):
        m = masks[i] if masks is not None else None
        w = weights[i] if weights is not None else None
        total = total + _single_gan_loss(p, target_is_real, for_discriminator,
                                         m, w, mode)
    if weights is None:
        return total / len(preds)
    return total / sum(weights)


def flatness_loss(face_normals: torch.Tensor, ff: torch.Tensor,
                  per_sample: bool = False) -> torch.Tensor:
    """Mean squared cosine distance between edge-adjacent face normals,
    scaled by F / 2.

    face_normals (B, F, 3) unit normals; ff (F, 3) adjacent-face indices.
    Returns (B,) with ``per_sample``, else their mean.
    """
    F = face_normals.shape[1]
    loss = 0.0
    for i in range(3):
        n2 = face_normals[:, ff[:, i]]
        cos = (face_normals * n2).sum(dim=-1)
        loss = loss + ((cos - 1.0) ** 2).mean(dim=-1)
    loss = loss * (F / 2.0)
    return loss if per_sample else loss.mean()
