"""Mesh-estimation trainer, renderer in the loop (counterpart of
``im23d_tpu/train/recon_trainer.py``), on one device.

This slice carries the inference surface: config, seeded init,
``load_params`` from the JAX package's variables, ``predict``,
``eval_step`` (recon loss, flatness loss and mIoU, weighted per sample),
``evaluate`` (the tail batch padded with repeats of weight 0, so every image
scores once), ``render_multiview`` and checkpoints ``{params, batch_stats,
dp_params, epoch, total_it}`` by ``torch.save``, numbered or under the
rolling tag ``latest``.  The training step and pseudo-ground-truth
generation come with the next slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from im23d_tpu_torch.core.checkpoint import resolve_checkpoint, save_checkpoint
from im23d_tpu_torch.core.convert import (
    dataset_params_state_dict,
    reconstruction_state_dict,
)
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.losses.gan_losses import flatness_loss
from im23d_tpu_torch.metrics.iou import mean_iou
from im23d_tpu_torch.models.reconstruction import (
    DatasetParams,
    ReconstructionNetwork,
    lecun_init_,
)
from im23d_tpu_torch.ops.quaternion import qmul, qnormalize, qrot
from im23d_tpu_torch.render.renderer import render_mesh


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    """Same fields and defaults as the JAX ``ReconConfig`` (the reference's
    argparse defaults), except ``compute_dtype``: "auto" is bfloat16 on a
    CUDA device and float32 on the CPU."""

    image_resolution: int = 256
    texture_resolution: int = 128
    mesh_resolution: int = 32
    symmetric: bool = True
    loss: str = "mse"  # mse | l1
    mesh_regularization: float = 5e-5
    optimize_deltas: bool = True
    optimize_z0: bool = False
    lr: float = 1e-4
    lr_dataset: float = 1e-4
    lr_decay_every: int = 250
    epochs: int = 1000
    batch_size: int = 50
    seed: int = 0
    # conv/linear compute dtype of the network; losses, DatasetParams, the
    # renderer inputs and both network outputs stay float32
    compute_dtype: str = "auto"


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


class ReconTrainer:
    """The reconstruction network and its ``DatasetParams`` on ``device``,
    the epoch and iteration counters, and the mesh template."""

    def __init__(self, config: ReconConfig, dataset_size: int,
                 template: MeshTemplate | None = None,
                 workdir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.workdir = workdir
        self.device = torch.device(device)
        self.template = template if template is not None else MeshTemplate()
        self.dataset_size = dataset_size
        dt = config.compute_dtype
        if dt == "auto":
            dt = "bfloat16" if self.device.type == "cuda" else "float32"
        self.model = ReconstructionNetwork(
            symmetric=config.symmetric,
            texture_res=config.texture_resolution,
            mesh_res=config.mesh_resolution,
            image_res=config.image_resolution,
            compute_dtype=getattr(torch, dt),
        )
        gen = torch.Generator().manual_seed(config.seed)
        lecun_init_(self.model, gen)
        self.model.to(self.device).eval()
        self.use_dp = config.optimize_deltas or config.optimize_z0
        self.dp_model = (
            DatasetParams(dataset_size, config.optimize_deltas,
                          config.optimize_z0).to(self.device)
            if self.use_dp else None)
        self.total_it = 0
        self.epoch = 0

    # -- batches and the forward -------------------------------------------

    def _put(self, batch: dict) -> dict:
        """Host arrays -> device tensors (float32; ``idx`` int64)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            t = t.to(self.device, non_blocking=True)
            out[k] = t.long() if k == "idx" else t.float()
        return out

    def _pose_and_render(self, mesh_map, tex, batch):
        cfg = self.cfg
        raw_vtx = self.template.get_vertex_positions(mesh_map)
        t_delta, s_delta, z0 = 0.0, 0.0, None
        if self.use_dp and batch.get("idx") is not None:
            if cfg.optimize_deltas:
                t_delta, s_delta = self.dp_model(batch["idx"], "deltas")
                s_delta = s_delta[:, 0]
            if cfg.optimize_z0:
                z0 = self.dp_model(batch["idx"], "z0")
        vtx = transform_vertices(raw_vtx, batch["scale"], batch["translation"],
                                 batch["rotation"], t_delta, s_delta, z0)
        uvs, tex_adj = self.template.adjust_uv_and_texture(tex)
        res = cfg.image_resolution
        dev = vtx.device
        image, alpha, _ = render_mesh(
            vtx, self.template.tensor("faces", dev), uvs,
            self.template.tensor("face_uvs", dev), tex_adj, res, res)
        return raw_vtx, vtx, image, alpha

    def _recon_loss(self, x_fake, x_real, per_sample: bool = False):
        err = x_fake - x_real
        per = (err.abs() if self.cfg.loss == "l1" else err ** 2).mean(
            dim=(1, 2, 3))
        return per if per_sample else per.mean()

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def predict(self, images):
        """images (B, H, W, 4) -> (texture, mesh map), eval mode."""
        self.model.eval()
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images)
                            else images).to(self.device).float()
        return self.model(x)

    @torch.no_grad()
    def eval_step(self, batch: dict, w=None):
        """Weighted per-sample means of the recon loss, the flatness loss
        and the mIoU on one batch (device scalars), and the rendered RGBA
        (B, H, W, 4).  ``w`` (B,) weighs the samples (1 by default)."""
        nb = self._put(batch)
        if w is None:
            w = torch.ones(nb["image"].shape[0], device=self.device)
        else:
            w = torch.as_tensor(np.asarray(w), dtype=torch.float32,
                                device=self.device)
        self.model.eval()
        tex, mesh_map = self.model(nb["image"])
        raw_vtx, _, image, alpha = self._pose_and_render(mesh_map, tex, nb)
        x_fake = torch.cat([image, alpha], dim=-1)
        wsum = torch.clamp(w.sum(), min=1.0)

        def wmean(per_sample):
            return (per_sample * w).sum() / wsum

        ff = self.template.tensor("ff", self.device)
        recon = wmean(self._recon_loss(x_fake, nb["image"], per_sample=True))
        flat = wmean(flatness_loss(self.template.compute_normals(raw_vtx), ff,
                                   per_sample=True))
        miou = wmean(mean_iou(x_fake[..., 3], nb["image"][..., 3],
                              per_sample=True))
        return dict(recon_loss=recon, flat_loss=flat, iou=miou), x_fake

    def evaluate(self, batches) -> dict:
        """Means over every image of ``batches``: a batch smaller than the
        configured batch size is padded with repeats of its first item,
        weighted 0, as the JAX trainer pads its tail batch to its compiled
        shape."""
        totals: dict[str, float] = {}
        n = 0
        B = self.cfg.batch_size
        for batch in batches:
            bs = len(batch["image"])
            w = np.ones((bs,), np.float32)
            if 0 < bs % B:
                pad = B - bs % B
                batch = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
                         for k, v in batch.items()}
                w = np.concatenate([w, np.zeros((pad,), np.float32)])
            losses, _ = self.eval_step(batch, w)
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + float(v) * bs
            n += bs
        return {k: v / max(n, 1) for k, v in totals.items()}

    @torch.no_grad()
    def render_multiview(self, raw_vtx, pred_tex, idx: int = 0,
                         angles=(0, 45, 90, 135, 180, 225, 270, 315)):
        """Render mesh ``idx`` from canonical viewpoints into a grid of
        rows of four, (2H, 4W, 3) in [0, 1] for the eight default views."""
        dev = raw_vtx.device

        def quat(rad, axis):
            q = [math.cos(-rad / 2), 0.0, 0.0, 0.0]
            q[axis] = math.sin(-rad / 2)
            return torch.tensor(q, device=dev)

        q0 = qmul(quat(-90 / 180 * math.pi, 3), quat(110 / 180 * math.pi, 2))
        rot = torch.stack([qmul(q0, quat(a / 180 * math.pi * 0.8, 3))
                           for a in angles])
        n = rot.shape[0]
        vtx = raw_vtx[idx][None].expand(n, -1, -1)
        tex = pred_tex[idx][None].expand(n, -1, -1, -1)
        v = qrot(rot, vtx) * 0.9
        v = v * v.new_tensor([1.0, -1.0, -1.0])
        uvs, tex_adj = self.template.adjust_uv_and_texture(tex / 2.0 + 0.5)
        res = self.cfg.image_resolution
        image, _, _ = render_mesh(
            v, self.template.tensor("faces", dev), uvs,
            self.template.tensor("face_uvs", dev), tex_adj, res, res)
        img = torch.clamp(image, 0.0, 1.0).cpu().numpy()
        rows = [np.concatenate(list(img[i * 4:(i + 1) * 4]), axis=1)
                for i in range(n // 4)]
        return np.concatenate(rows, axis=0)

    # -- params and checkpoints ---------------------------------------------

    def load_params(self, variables: dict, dp_params: dict | None = None):
        """Load the JAX package's network variables ``{params,
        batch_stats}`` (nested numpy dicts) and, optionally, its
        ``DatasetParams`` params."""
        self.model.load_state_dict(reconstruction_state_dict(variables))
        if dp_params is not None:
            self.dp_model.load_state_dict(dataset_params_state_dict(dp_params))

    def _split_state(self):
        params = {k: v.detach().cpu() for k, v in
                  self.model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in self.model.named_buffers()}
        dp = ({k: v.detach().cpu() for k, v in self.dp_model.state_dict()
               .items()} if self.dp_model is not None else {})
        return params, stats, dp

    def save(self, workdir: str | None = None, tag: str | None = None) -> str:
        """tag None writes the permanent checkpoint_<total_it>.pt, tag
        "latest" overwrites the rolling checkpoint_latest.pt."""
        params, stats, dp = self._split_state()
        return save_checkpoint(
            workdir or self.workdir, self.total_it if tag is None else tag,
            dict(params=params, batch_stats=stats, dp_params=dp,
                 epoch=self.epoch, total_it=self.total_it))

    def restore(self, workdir: str | None = None, step=None) -> None:
        """Load the checkpoint of ``step`` (an int or "latest"; by default
        the newest)."""
        path = resolve_checkpoint(workdir or self.workdir, step)
        tree = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict({**tree["params"], **tree["batch_stats"]})
        if self.dp_model is not None:
            self.dp_model.load_state_dict(tree["dp_params"])
        self.epoch = int(tree["epoch"])
        self.total_it = int(tree["total_it"])
