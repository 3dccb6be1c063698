"""UV-space texture+mesh GAN: the generator and the multi-scale critics
(counterpart of ``im23d_tpu/models/gan.py``).

Layers carry the reference's torch names (``fc``, ``emb_class``,
``blk1..blk6``, ``blk3a..c``, ``blk3_mesh`` with ``conv1``/``conv2``/
``shortcut`` and ``norm1``/``norm2`` = {``norm``, ``fc_gamma``,
``fc_beta``}, ``conv_final``, ``conv_mesh``; critics ``d1..d3`` with
``conv1..conv5``, ``bn2..bn4`` and ``projector``), so a reference state
dict loads as it is; ``core/convert.py`` maps the JAX package's flax
variables onto them.  The layers run NCHW; the public tensors are NHWC as
in the JAX model: the generator returns (texture (B, T, T, 3) in [-1, 1],
mesh map (B, m, m, 3) float32), the critics take (B, H, W, 4) textures
with alpha and (B, m, m, 3) mesh maps and return (B, 1, h, w) predictions
and masks (one channel, so the same values in the same order as JAX's
(B, h, w, 1)).

Spectral norm is flax's ``nn.SpectralNorm``, not torch's: the OIHW weight
flattened to (out, in·kh·kw), one power iteration from the stored ``u``
on every call, in train and in eval (torch's skips it in eval), ``u`` and
``v`` without gradient while sigma = v·Wᵀ·uᵀ carries it to the weight,
l2 normalisation x·rsqrt(Σx² + 1e-12); ``u`` is written back only in train
mode.  Only ``weight_orig`` and ``weight_u`` are stored.

Mixed precision follows the JAX rule: ``compute_dtype`` is the conv and
linear dtype (parameters and spectral norm stay float32); batch norm
reduces in float32; the texture leaves in the compute dtype, the mesh map
and the critics' outputs in float32.  The texture head is kernel K8 on
CUDA and each ResBlockUp's conv2, with norm1 and its leaky ReLU folded
in, is kernel K9 (``ops/conv.py``); on the CPU both are their plain
versions.  ``conditional_text`` and ``wide_hires`` are not
ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from im23d_tpu_torch.models.reconstruction import (
    _bn,
    bn_stats,
    circular_pad_w,
    replicate_pad_w,
    upsample_nearest,
)
from im23d_tpu_torch.ops.conv import fused_affine_conv3x3, head_conv_tanh
from im23d_tpu_torch.ops.sampling import adjust_poles, symmetrize_texture

BN_MOMENTUM = 0.01  # flax's 0.99


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
        if self.conditional_text:
            raise NotImplementedError(
                "conditional_text (SpatialAttention, the text encoder and "
                "the caption cache) is not ported yet")
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

    def forward(self, z: torch.Tensor, c: torch.Tensor | None = None):
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
        x = upsample_nearest(self.blk2(x, z))

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
        return tex.contiguous(), (None if mesh is None
                                  else mesh.contiguous())


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
    optional instance norms and the class projection."""

    def _norm(self, name: str, h: torch.Tensor) -> torch.Tensor:
        norm = getattr(self, name, None)
        return h if norm is None else norm(h)

    def _conv(self, conv: SNConv2d, h: torch.Tensor, pad: int):
        """``conv`` on the width-circularly padded ``h`` in the compute
        dtype (the instance norms leave float32, as flax's GroupNorm)."""
        return conv(circular_pad_w(h.to(self.cfg.dtype), pad))

    def _project(self, y, h, c):
        if not self.cfg.conditional_class:
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


class TextureDiscriminator(_Critic):
    """Texture critic at 1 / ``downsample`` resolution."""

    def __init__(self, cfg: GANConfig, downsample: int = 1):
        super().__init__()
        self.cfg = cfg
        self.downsample = downsample
        self.stride_first = ((downsample == 1 and cfg.texture_resolution >= 512)
                             or cfg.texture_resolution >= 1024)
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

    def forward(self, x, c=None, alpha=None):
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
        return self._project(y, h, c), mask


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

    def forward(self, texture, mesh_map, c=None, alpha=None):
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
        return self._project(y, h, c), mask


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

    def forward(self, x, mesh_map=None, c=None, alpha=None):
        """-> (predictions, masks), one of each per critic."""
        outs = [self.d1(x, c, alpha)]
        if self.cfg.texture_only:
            outs.append(self.d2(x, c, alpha))
        else:
            outs.append(self.d2(x, mesh_map, c, alpha))
        if self.cfg.num_discriminators == 3:
            outs.append(self.d3(x, c, alpha))
        return [o[0] for o in outs], [o[1] for o in outs]


def gan_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init, drawn from ``generator``: truncated-normal LeCun
    conv and linear weights, zero biases, standard-normal spectral-norm
    ``u``, embeddings normal with variance 1 / rows, ``conv_mesh`` zero."""

    def lecun(w):
        std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, SNConv2d):
                lecun(m.weight_orig)
                m.weight_u.normal_(generator=generator)
            elif isinstance(m, HeadConvTanh):
                lecun(m.weight)
            elif isinstance(m, nn.Conv2d) and name.endswith("conv_mesh"):
                m.weight.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun(m.weight)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[0]),
                                 generator=generator)
            bias = getattr(m, "bias", None)
            if isinstance(bias, torch.Tensor) and not isinstance(
                    m, _InstanceNormAffine):
                bias.zero_()
