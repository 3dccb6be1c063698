"""The reference's training steps and inference calls: frozen plain copies
of what the program's trainers and evaluator do, in float32 with TF32 off.

* ``GANSteps``: the G step (hinge loss through the critics, flatness of
  the generated mesh, Adam(0, 0.9)), the D step (the generator in train
  mode without gradient, the critics on fake + real, Adam(0, 0.9)) and
  the EMA generator's update; a G step every third iteration.
* ``ReconSteps``: the network in train mode, posing with the
  ``DatasetParams`` deltas, the render, recon + warm-up × flatness loss,
  two Adams; and the eval call (weighted per-sample losses, mIoU).
* ``fid_activations``: the EMA generator in eval mode, the posed render at
  the evaluation resolution, the Inception features.

It imports nothing of the program.  Batches, poses and z are worked out
here again from the benchmark's raw inputs.
"""

from __future__ import annotations

import copy
from contextlib import contextmanager

import numpy as np
import torch

from portbench.reference import nets
from portbench.reference.render import (
    MeshTemplate,
    qnormalize,
    qrot,
    render_mesh,
)

FLAT_WARMUP = 10.0


@contextmanager
def fp32_only():
    """float32 matmuls and convs without TF32 inside, the previous
    settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def gan_z(seed: int, it: int, n: int, dim: int) -> torch.Tensor:
    """The trainer's iteration draw: standard normal from a CPU generator
    seeded with (seed << 32) + it."""
    gen = torch.Generator().manual_seed((seed << 32) + it)
    return torch.randn((n, dim), generator=gen)


def truncation_sample(seed: int, n: int, dim: int,
                      sigma: float) -> torch.Tensor:
    """(n, dim) normal draws from a CPU generator seeded with ``seed``,
    components above ``sigma`` redrawn, at most 100 rounds."""
    gen = torch.Generator().manual_seed(int(seed))
    z = torch.randn((n, dim), generator=gen)
    for _ in range(100):
        bad = z.abs() > sigma
        if not bool(bad.any()):
            break
        z = torch.where(bad, torch.randn((n, dim), generator=gen), z)
    return z


def mirror_nhwc(x: torch.Tensor) -> torch.Tensor:
    """The UV mirror: flip u, roll by half a period."""
    return torch.roll(torch.flip(x, dims=(2,)), -(x.shape[2] // 2), dims=2)


def gan_epoch_batches(n: int, batch_size: int, epoch: int) -> list:
    """One epoch's item indices: a RandomState(epoch) shuffle, the tail
    dropped."""
    order = np.arange(n)
    np.random.RandomState(epoch).shuffle(order)
    end = n - n % batch_size
    return [order[s:s + batch_size] for s in range(0, end, batch_size)]


def gan_mirror(data_seed: int, epoch: int, idx) -> list:
    """Each item's mirror draw of the epoch."""
    return [np.random.default_rng(np.random.SeedSequence(
        [data_seed, epoch, int(i)])).integers(2) == 1 for i in idx]


class GANSteps:
    """Generator, critics and EMA generator in float32 from one state."""

    def __init__(self, mcfg: nets.GANConfig, g_state: dict, d_state: dict,
                 template: MeshTemplate, device, lr_g: float, lr_d: float,
                 mesh_regularization: float, ema_alpha: float):
        self.cfg = mcfg
        self.dev = device
        self.G = nets.Generator(mcfg).to(device)
        self.G.load_state_dict(g_state)
        self.D = nets.MultiScaleDiscriminator(mcfg).to(device)
        self.D.load_state_dict(d_state)
        self.G.eval()
        self.D.eval()
        self.ema = copy.deepcopy(self.G).requires_grad_(False)
        self.template = template
        self.opt_g = torch.optim.Adam(self.G.parameters(), lr=lr_g,
                                      betas=(0.0, 0.9), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.D.parameters(), lr=lr_d,
                                      betas=(0.0, 0.9), eps=1e-8)
        self.mesh_reg = mesh_regularization
        self.ema_alpha = ema_alpha

    def _fake(self, z, c, alpha):
        tex, mesh = self.G(z, c)
        return torch.cat([tex * alpha, alpha], dim=-1), mesh

    def g_step(self, b: dict, z: torch.Tensor) -> dict:
        G, D = self.G, self.D
        G.train()
        D.train()
        D.requires_grad_(False)
        x_fake, mesh = self._fake(z, b["c"], b["alpha"])
        preds, masks = D(x_fake, mesh, b["c"], alpha=b["alpha"])
        loss_gan = nets.gan_loss(preds, True, False, masks, None, "hinge")
        vtx = self.template.get_vertex_positions(mesh)
        flat = nets.flatness_loss(self.template.compute_normals(vtx),
                                  self.template.tensor("ff", self.dev))
        self.opt_g.zero_grad(set_to_none=True)
        (loss_gan + self.mesh_reg * flat).backward()
        self.opt_g.step()
        D.requires_grad_(True)
        G.eval()
        D.eval()
        with torch.no_grad():
            live = self.G.state_dict()
            a = self.ema_alpha
            for k, v in self.ema.state_dict().items():
                if v.is_floating_point():
                    v.copy_(v * a + live[k] * (1.0 - a))
        return dict(g_loss=float(loss_gan.detach()),
                    flat_loss=float(flat.detach()))

    def d_step(self, b: dict, z: torch.Tensor) -> dict:
        G, D = self.G, self.D
        G.train()
        D.train()
        c, alpha = b["c"], b["alpha"]
        with torch.no_grad():
            x_fake, mesh = self._fake(z, c, alpha)
        x_real = torch.cat([b["texture"], alpha], dim=-1)
        preds, masks = D(torch.cat([x_fake, x_real]),
                         torch.cat([mesh, b["mesh"]]), torch.cat([c, c]),
                         alpha=torch.cat([alpha, alpha]))
        B = x_fake.shape[0]
        loss_fake = nets.gan_loss([p[:B] for p in preds], False, True,
                                  [m[:B] for m in masks], None, "hinge")
        loss_real = nets.gan_loss([p[B:] for p in preds], True, True,
                                  [m[B:] for m in masks], None, "hinge")
        self.opt_d.zero_grad(set_to_none=True)
        (loss_fake + loss_real).backward()
        self.opt_d.step()
        G.eval()
        D.eval()
        return dict(d_fake=float(loss_fake.detach()),
                    d_real=float(loss_real.detach()))


def transform_vertices(vtx, scale, translation, rotation, t_delta, s_delta):
    s = (scale + s_delta).reshape(-1, 1, 1)
    v = qrot(qnormalize(rotation), s * vtx)
    v = v + (translation + t_delta)[:, None, :]
    return v * v.new_tensor([1.0, -1.0, -1.0])


class ReconSteps:
    """The mesh-estimation network and ``DatasetParams`` in float32."""

    def __init__(self, net_kwargs: dict, net_state: dict, dp_state: dict,
                 dataset_size: int, template: MeshTemplate, device,
                 lr: float, lr_dataset: float, mesh_regularization: float,
                 image_res: int):
        self.dev = device
        self.net = nets.ReconstructionNetwork(**net_kwargs).to(device)
        self.net.load_state_dict(net_state)
        self.net.eval()
        self.dp = nets.DatasetParams(dataset_size).to(device)
        self.dp.load_state_dict(dp_state)
        self.template = template
        self.opt = torch.optim.Adam(self.net.parameters(), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.opt_dp = torch.optim.Adam(self.dp.parameters(), lr=lr_dataset,
                                       betas=(0.9, 0.999), eps=1e-8)
        self.mesh_reg = mesh_regularization
        self.res = image_res
        self.warmup = FLAT_WARMUP

    def _render(self, mesh_map, tex, b, rows: int | None = None):
        """Posed render (image, alpha) and the raw vertices, ``rows`` images
        at a time (the plain rasterizer's memory)."""
        t = self.template
        raw = t.get_vertex_positions(mesh_map)
        t_d, s_d = self.dp(b["idx"], "deltas")
        vtx = transform_vertices(raw, b["scale"], b["translation"],
                                 b["rotation"], t_d, s_d[:, 0])
        uvs, tex_adj = t.adjust_uv_and_texture(tex)
        faces, fuv = t.tensor("faces", self.dev), t.tensor("face_uvs",
                                                           self.dev)
        rows = rows or vtx.shape[0]
        imgs, alphas = [], []
        for s in range(0, vtx.shape[0], rows):
            img, alpha, _ = render_mesh(vtx[s:s + rows], faces,
                                        uvs[s:s + rows], fuv,
                                        tex_adj[s:s + rows], self.res,
                                        self.res)
            imgs.append(img)
            alphas.append(alpha)
        return raw, torch.cat(imgs), torch.cat(alphas)

    def train_step(self, b: dict, rows: int | None = None) -> dict:
        coeff = self.mesh_reg * self.warmup
        self.warmup = max(self.warmup - 0.1, 1.0)
        self.net.train()
        tex, mesh_map = self.net(b["image"])
        self.net.eval()
        self.last_out = (tex.detach(), mesh_map.detach())
        raw, image, alpha = self._render(mesh_map, tex, b, rows)
        x_fake = torch.cat([image, alpha], dim=-1)
        recon = ((x_fake - b["image"]) ** 2).mean(dim=(1, 2, 3)).mean()
        flat = nets.flatness_loss(self.template.compute_normals(raw),
                                  self.template.tensor("ff", self.dev))
        self.opt.zero_grad(set_to_none=True)
        self.opt_dp.zero_grad(set_to_none=True)
        (recon + coeff * flat).backward()
        self.opt.step()
        self.opt_dp.step()
        return dict(recon_loss=float(recon.detach()),
                    flat_loss=float(flat.detach()))


@torch.no_grad()
def fid_activations(G: nets.Generator, inception, template: MeshTemplate,
                    res: int, z: torch.Tensor, c: torch.Tensor,
                    scale: torch.Tensor, translation: torch.Tensor,
                    rotation: torch.Tensor) -> torch.Tensor:
    """Generate (eval mode), pose, render at ``res`` and embed: (B, D)."""
    G.eval()
    tex, mesh_map = G(z, c)
    tex, mesh_map = tex.float(), mesh_map.float()
    vtx = template.get_vertex_positions(mesh_map)
    vtx = qrot(qnormalize(rotation), scale.reshape(-1, 1, 1) * vtx)
    vtx = (vtx + translation[:, None, :]) * vtx.new_tensor([1.0, -1.0, -1.0])
    uvs, tex_adj = template.adjust_uv_and_texture(tex / 2.0 + 0.5)
    dev = vtx.device
    image, _, _ = render_mesh(vtx, template.tensor("faces", dev), uvs,
                              template.tensor("face_uvs", dev), tex_adj,
                              res, res)
    return inception(image).float()
