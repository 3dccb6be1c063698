"""Serving artifacts: inference graphs traced by ``torch.export`` and
written to disk (counterpart of ``im23d_tpu/serve/export.py``).

``torch.export`` traces a module on example inputs into an
``ExportedProgram`` with the trained parameters inside it; the serving
process loads it into a plain callable without the model code.  An
artifact holds one program per platform ("cuda", "cpu"), each traced from
the same weights on that device, as members ``<platform>.pt2`` of one zip
file.

The generator's program on CUDA calls the kernels K8 and K9 as the custom
ops ``im23d::head_conv_tanh`` and ``im23d::fused_affine_conv3x3``, so a
serving process must import ``im23d_tpu_torch.ops.conv`` to register them
before it loads the artifact (``load_artifact`` does); the first call
builds the kernel library from the checkout's ``csrc/``.  That import is
the port's counterpart of "the serving process needs only jax".
"""

from __future__ import annotations

import copy
import io
import zipfile
from typing import Sequence

import torch
from torch import nn

PLATFORMS = ("cuda", "cpu")


def _check_platforms(platforms: Sequence[str]) -> tuple[str, ...]:
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{platforms}")
    return platforms


def _to(x, device):
    return x.to(device) if torch.is_tensor(x) else x


def export_callable(module: nn.Module, example_args: Sequence,
                    platforms: Sequence[str] = PLATFORMS) -> bytes:
    """Trace ``module(*example_args)`` on each platform (a copy of the
    module and of the arguments moved there) and return the artifact's
    bytes."""
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as zf:
        for platform in _check_platforms(platforms):
            dev = torch.device(platform)
            m = copy.deepcopy(module).to(dev).eval()
            args = tuple(_to(a, dev) for a in example_args)
            with torch.no_grad():
                program = torch.export.export(m, args)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            zf.writestr(f"{platform}.pt2", buf.getvalue())
    return out.getvalue()


def save_artifact(path: str, module: nn.Module, example_args: Sequence,
                  platforms: Sequence[str] = PLATFORMS) -> None:
    data = export_callable(module, example_args, platforms)
    with open(path, "wb") as f:
        f.write(data)


def load_artifact(path: str, device: str | torch.device = "cuda"):
    """The program of ``device``'s platform in the artifact at ``path``, as
    a plain callable taking and returning tensors on that device."""
    import im23d_tpu_torch.ops.conv  # noqa: F401  registers the custom ops

    platform = torch.device(device).type
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if f"{platform}.pt2" not in names:
            raise ValueError(f"{path} holds no {platform} program "
                             f"({names})")
        data = zf.read(f"{platform}.pt2")
    return torch.export.load(io.BytesIO(data)).module()


class _GANInference(nn.Module):
    """The EMA generator in eval mode, float32 outputs (the trainer's
    ``generate`` without captions)."""

    def __init__(self, g_ema: nn.Module):
        super().__init__()
        self.g = g_ema

    def forward(self, z, c=None):
        tex, mesh = self.g(z, c)
        return tex.float(), None if mesh is None else mesh.float()


def export_gan_inference(trainer, batch_size: int, path: str,
                         platforms: Sequence[str] = PLATFORMS) -> None:
    """Export the EMA generator: (z [, classes]) -> (texture, mesh map).

    The classes are an input when the model is class-conditional; a
    text-conditional model's captions stay unresolved (no caption), as in
    the JAX export."""
    mcfg = trainer.mcfg
    z = torch.zeros((batch_size, mcfg.latent_dim))
    args = (z,)
    if mcfg.conditional_class:
        args = (z, torch.zeros((batch_size, len(mcfg.n_classes)),
                               dtype=torch.int64))
    save_artifact(path, _GANInference(trainer.g_ema), args, platforms)


def export_reconstruction_inference(trainer, batch_size: int, path: str,
                                    platforms: Sequence[str] = PLATFORMS
                                    ) -> None:
    """Export the reconstruction network alone, in eval mode: RGBA images
    (B, R, R, 4) -> (texture, mesh map)."""
    res = trainer.cfg.image_resolution
    images = torch.zeros((batch_size, res, res, 4))
    save_artifact(path, trainer.model, (images,), platforms)
