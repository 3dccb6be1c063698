"""Mesh-estimation network: RGBA image -> (UV texture, UV displacement map),
and the per-image pose refinement ``DatasetParams`` (counterpart of
``im23d_tpu/models/reconstruction.py``).

The layers carry the reference's torch names and NCHW layout
(``conv{1..5}e``/``bn{1..5}e``, ``fc1e``/``bnfc1e``, ``fc3e``/``bnfc3e``,
``fc1_tex``, ``blk1..3``, ``blk3b_tex``, ``blk3c_tex``, ``blk4_mesh``,
``conv_mesh``, ``blk4_tex``, ``blk5_tex``, ``conv_tex``), so a reference
state dict loads as it is; ``core/convert.py`` maps the JAX package's flax
variables onto them.  Inputs and outputs are NHWC like the JAX model.

Mixed precision follows the JAX rule: ``compute_dtype`` sets the conv and
linear compute dtype (parameters stay float32 and are cast at the call);
batch norm runs in float32, and both outputs are float32.  BatchNorm
momentum 0.01 is flax's 0.99; eps 1e-5 as in flax.  In train mode batch
norm is flax's: the batch moments in float32 (variance E[x²] − E[x]²,
biased, clipped at 0), and the running statistics move by momentum with
that biased variance, where ``F.batch_norm`` would take the unbiased one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from im23d_tpu_torch.ops.sampling import adjust_poles, symmetrize_texture

BN_MOMENTUM = 0.01


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


def _bn(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Batch norm in float32, returned in ``x``'s dtype: the running
    statistics in eval mode; in train mode flax's batch statistics and
    running-statistics update (updated in place)."""
    xf = x.float()
    if not bn.training:
        return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps).to(x.dtype)
    dims = [0, *range(2, xf.dim())]
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
    shape = [1, -1] + [1] * (xf.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
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


def lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default init, drawn from ``generator``: truncated-normal
    LeCun weights (variance 1 / fan_in, cut at two standard deviations of
    the untruncated normal), zero biases, unit BatchNorm scale; ``conv_mesh``
    zero, as in the JAX model."""
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            with torch.no_grad():
                if name == "conv_mesh":
                    m.weight.zero_()
                else:
                    fan_in = m.weight[0].numel()
                    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                    torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                                2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


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
