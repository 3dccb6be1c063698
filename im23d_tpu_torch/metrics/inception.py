"""InceptionV3 feature extractor for FID (counterpart of
``im23d_tpu/metrics/inception.py``).

torchvision's ``inception_v3`` blocks up to the final average pooling, with
torchvision's module names (so a torchvision state dict loads as it is) and
NCHW inside; the input is (B, H, W, 3) in [0, 1], resized to 299 with
half-pixel bilinear and scaled to [-1, 1].  ``feature_layer="pool3"`` gives
the 2048-d pool3 features, ``"Mixed_5d"`` the 288-d spatial mean after
Mixed_5d (the JAX package's default for random weights, where pool3
features collapse).  Batch norm always uses its running statistics
(eps 1e-3).

``init_inception`` makes the deterministic calibrated random init of the
JAX package: LeCun-normal kernels scaled by sqrt(gain), then, over 20
passes on 8 seeded 299² probe images, every batch norm's running moments
set to those of its sibling conv's output.  Its draws come from a torch
generator, so its weights are not the JAX init's; parity is tested on
converted weights (``core/convert.py:inception_state_dict``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from im23d_tpu_torch.ops.sampling import resize_bilinear

FEATURE_LAYERS = ("pool3", "Mixed_5d")
CALIBRATION_PASSES = 20  # at least the number of sequential conv stages


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(F.batch_norm(self.conv(x), self.bn.running_mean,
                                   self.bn.running_var, self.bn.weight,
                                   self.bn.bias, False, 0.0, self.bn.eps))


def _avg_pool(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool(x))], 1)


class InceptionV3Features(nn.Module):
    """(B, H, W, 3) in [0, 1] -> (B, 2048) pool3 or (B, 288) Mixed_5d
    features; the blocks past ``feature_layer`` are not built."""

    def __init__(self, feature_layer: str = "pool3"):
        super().__init__()
        if feature_layer not in FEATURE_LAYERS:
            raise ValueError(f"feature_layer must be one of {FEATURE_LAYERS}, "
                             f"got {feature_layer!r}")
        self.feature_layer = feature_layer
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        if feature_layer == "pool3":
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280)
            self.Mixed_7c = InceptionE(2048)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 299 or x.shape[2] != 299:
            x = resize_bilinear(x, 299, 299, align_corners=False)
        x = (2.0 * x - 1.0).permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        x = self.Mixed_5d(self.Mixed_5c(self.Mixed_5b(x)))
        if self.feature_layer == "pool3":
            for name in ("Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                         "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def calibrate_pass(model: InceptionV3Features, probe: torch.Tensor) -> None:
    """One calibration pass: every batch norm's running mean and (biased)
    variance become the moments of its sibling conv's output on ``probe``,
    all taken in one forward with the current statistics, then sanitised
    (non-finite mean -> 0, non-finite variance -> 1, mean clipped to
    ±1e4, variance to [1e-4, 1e8])."""
    convs = {m.conv: m.bn for m in model.modules()
             if isinstance(m, BasicConv2d)}
    moments = {}

    def hook(conv, _, out):
        o = out.float()
        moments[convs[conv]] = (o.mean(dim=(0, 2, 3)),
                                o.var(dim=(0, 2, 3), unbiased=False))

    handles = [c.register_forward_hook(hook) for c in convs]
    try:
        with torch.no_grad():
            model(probe)
    finally:
        for h in handles:
            h.remove()
    with torch.no_grad():
        for bn, (m, v) in moments.items():
            m = torch.where(torch.isfinite(m), m.clamp(-1e4, 1e4),
                            torch.zeros_like(m))
            v = torch.where(torch.isfinite(v), v.clamp(1e-4, 1e8),
                            torch.ones_like(v))
            bn.running_mean.copy_(m)
            bn.running_var.copy_(v)


def init_inception(seed: int = 0, calibrate: bool = True, gain: float = 1.0,
                   feature_layer: str = "Mixed_5d",
                   device: str | torch.device = "cpu") -> InceptionV3Features:
    """The calibrated random-init extractor on ``device``: flax's default
    LeCun-normal conv kernels (truncated at two standard deviations) times
    sqrt(``gain``), unit batch-norm scale, then CALIBRATION_PASSES
    calibration passes on 8 uniform 299² probe images, all drawn from a
    torch generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionV3Features(feature_layer=feature_layer)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (math.sqrt(1.0 / m.weight[0].numel())
                       / 0.87962566103423978)
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                m.weight.mul_(math.sqrt(gain))
    probe = torch.rand((8, 299, 299, 3), generator=gen)
    model.to(device)
    if calibrate:
        probe = probe.to(device)
        for _ in range(CALIBRATION_PASSES):
            calibrate_pass(model, probe)
    return model


def load_inception(path, device):
    """``--inception_weights`` of the GAN and reconstruction CLIs: a
    torchvision inception_v3 state dict (.pth, or .npz of the same tensors)
    in the pool3 (2048-d) extractor on ``device``, or None without a path.
    A state dict that lacks an extractor tensor raises ``ValueError``."""
    if not path:
        return None
    if path.endswith(".npz"):
        with np.load(path) as f:
            sd = {k: torch.from_numpy(f[k]) for k in f.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    model = InceptionV3Features(feature_layer="pool3")
    missing = model.load_state_dict(sd, strict=False).missing_keys
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} extractor tensors, "
                         f"e.g. {missing[:3]}")
    return model.to(device).eval()
