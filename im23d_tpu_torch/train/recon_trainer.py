"""Mesh-estimation trainer, renderer in the loop (counterpart of
``im23d_tpu/train/recon_trainer.py``), on one device or on a rank of a
``parallel.mesh.Mesh``.

* ``train_step``: the network in train mode (flax batch norm; on one CUDA
  card its forward and backward replay from CUDA graphs,
  ``train/recon_graph.py``), posing with the learnable ``DatasetParams``
  deltas, the render (K4 and K5 with their backward kernels on CUDA),
  loss = recon + mesh_regularization x warm-up x flatness, the warm-up
  read and then decayed by 0.1 a step to 1.0; two Adam optimizers, the
  network's at lr x 0.5 ** (epoch // lr_decay_every) and
  ``DatasetParams``' at lr_dataset (dense gradients, so every row's
  moments move each step, as optax's).
* ``eval_step`` (recon loss, flatness loss and mIoU, weighted per sample),
  ``evaluate`` (the tail batch padded with repeats of weight 0, so every
  image scores once), ``predict``, ``render_multiview``.
* ``generate_pseudogt``: the pseudo-ground-truth cache of the reference
  layout (per-image npz, poses metadata, FID statistics).
* Checkpoints ``{params, batch_stats, opt, dp_params, opt_dp, epoch,
  total_it}`` by ``torch.save``, numbered or under the rolling tag
  ``latest``; a checkpoint without optimizer state restores with fresh
  optimizers.  The flatness warm-up is replayed from ``total_it`` on
  restore, so a resumed run continues the uninterrupted one.
* On a mesh each rank trains on its rows of the global batch (its
  ``idx`` index the shared ``DatasetParams``): batch norm takes the global
  moments, the gradients of the network and of ``DatasetParams`` and the
  losses are averaged over the data group; ``evaluate`` sums over the
  ranks' rows; rank 0 writes checkpoints while the others wait.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from im23d_tpu_torch.core.checkpoint import resolve_checkpoint, save_checkpoint
from im23d_tpu_torch.core.convert import (
    dataset_params_state_dict,
    reconstruction_state_dict,
)
from im23d_tpu_torch.core.profiler import span, to_device
from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.losses.gan_losses import flatness_loss
from im23d_tpu_torch.metrics.iou import mean_iou
from im23d_tpu_torch.models.reconstruction import (
    DatasetParams,
    ReconstructionNetwork,
    lecun_init_,
)
from im23d_tpu_torch.ops.quaternion import qmul, qnormalize, qrot
from im23d_tpu_torch.ops.sampling import resize_bilinear
from im23d_tpu_torch.parallel import mesh as pmesh
from im23d_tpu_torch.render.renderer import render_mesh
from im23d_tpu_torch.train.recon_graph import NetworkGraphs

FLAT_WARMUP = 10.0  # flatness weight multiplier at step 0, decays to 1.0


def _flat_warmup_after(steps: int) -> float:
    """The warm-up multiplier after ``steps`` decays of 0.1, in the float
    arithmetic of the step-by-step decay."""
    w = FLAT_WARMUP
    for _ in range(steps):
        if w == 1.0:
            break
        w = max(w - 0.1, 1.0)
    return w


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
                 device: str | torch.device = "cuda",
                 mesh: pmesh.Mesh | None = None):
        self.cfg = config
        self.workdir = workdir
        self.device = torch.device(device)
        self.mesh = mesh
        self.data_group = None if mesh is None else mesh.data_group
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
        self.graphs = NetworkGraphs(self.model)
        self.use_dp = config.optimize_deltas or config.optimize_z0
        self.dp_model = (
            DatasetParams(dataset_size, config.optimize_deltas,
                          config.optimize_z0).to(self.device)
            if self.use_dp else None)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=config.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.opt_dp = (torch.optim.Adam(self.dp_model.parameters(),
                                        lr=config.lr_dataset,
                                        betas=(0.9, 0.999), eps=1e-8)
                       if self.use_dp else None)
        self.total_it = 0
        self.epoch = 0
        self.flat_warmup = FLAT_WARMUP

    # -- batches and the forward -------------------------------------------

    def _put(self, batch: dict) -> dict:
        """Host arrays -> device tensors (float32; ``idx`` int64)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v)
            t = to_device(t, self.device, non_blocking=True)
            out[k] = t.long() if k == "idx" else t.float()
        return out

    def _pose(self, raw_vtx, batch):
        """Screen-space vertices: the batch's pose plus the learnable
        ``DatasetParams`` refinement of its indices."""
        cfg = self.cfg
        t_delta, s_delta, z0 = 0.0, 0.0, None
        if self.use_dp and batch.get("idx") is not None:
            if cfg.optimize_deltas:
                t_delta, s_delta = self.dp_model(batch["idx"], "deltas")
                s_delta = s_delta[:, 0]
            if cfg.optimize_z0:
                z0 = self.dp_model(batch["idx"], "z0")
        return transform_vertices(raw_vtx, batch["scale"],
                                  batch["translation"], batch["rotation"],
                                  t_delta, s_delta, z0)

    def _pose_and_render(self, mesh_map, tex, batch):
        cfg = self.cfg
        raw_vtx = self.template.get_vertex_positions(mesh_map)
        vtx = self._pose(raw_vtx, batch)
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

    # -- training -----------------------------------------------------------

    def _lr_factor(self) -> float:
        return 0.5 ** (self.epoch // self.cfg.lr_decay_every)

    def train_step(self, batch: dict) -> dict:
        """One Adam step on a batch: image (B, H, W, 4), scale (B,),
        translation (B, 3), rotation (B, 4), idx (B,) int or absent.
        Returns recon_loss, flat_loss and the soft alpha's iou as device
        scalars."""
        cfg, it = self.cfg, self.total_it
        with span("train.step", it):
            with span("train.put", it):
                nb = self._put(batch)
            flat_coeff = cfg.mesh_regularization * self.flat_warmup
            self.flat_warmup = max(self.flat_warmup - 0.1, 1.0)
            with span("train.forward", it):
                self.model.train()
                try:
                    with pmesh.batch_norm_group(self.data_group), \
                            self.graphs.engaged(nb["image"], self.data_group):
                        tex, mesh_map = self.model(nb["image"])
                finally:
                    self.model.eval()
            with span("train.render", it):
                raw_vtx, _, image, alpha = self._pose_and_render(
                    mesh_map, tex, nb)
            with span("train.loss", it):
                x_fake = torch.cat([image, alpha], dim=-1)
                recon = self._recon_loss(x_fake, nb["image"])
                flat = flatness_loss(self.template.compute_normals(raw_vtx),
                                     self.template.tensor("ff", self.device))
                loss = recon + flat_coeff * flat
                with torch.no_grad():
                    miou = mean_iou(x_fake[..., 3], nb["image"][..., 3])
            optimizers = [o for o in (self.opt, self.opt_dp) if o is not None]
            with span("train.optimizer", it):
                for group in self.opt.param_groups:
                    group["lr"] = cfg.lr * self._lr_factor()
                for opt in optimizers:
                    opt.zero_grad(set_to_none=True)
            with span("train.backward", it):
                loss.backward()
                pmesh.all_reduce_grads([p for opt in optimizers
                                        for g in opt.param_groups
                                        for p in g["params"]], self.data_group)
            with span("train.optimizer", it):
                for opt in optimizers:
                    opt.step()
        self.total_it += 1
        return pmesh.mean_over(dict(recon_loss=recon.detach(),
                                    flat_loss=flat.detach(), iou=miou),
                               self.data_group)

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
        shape.  On a mesh each rank passes its rows and the sums are
        taken over the data group."""
        totals: dict[str, float] = {}
        n = 0
        B = self.cfg.batch_size
        for batch in batches:
            bs = len(batch["image"])
            if bs == 0:
                continue
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
        if self.data_group is not None:
            keys = ("recon_loss", "flat_loss", "iou")
            sums = pmesh.sum_over(
                np.array([totals.get(k, 0.0) for k in keys] + [n]),
                self.data_group, self.device)
            totals, n = dict(zip(keys, sums[:-1])), sums[-1]
        return {k: float(v / max(n, 1)) for k, v in totals.items()}

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
        "latest" overwrites the rolling checkpoint_latest.pt; on a mesh
        rank 0 writes and the others wait."""
        path = None
        if pmesh.is_main(self.mesh):
            params, stats, dp = self._split_state()
            path = save_checkpoint(
                workdir or self.workdir,
                self.total_it if tag is None else tag,
                dict(params=params, batch_stats=stats,
                     opt=self.opt.state_dict(), dp_params=dp,
                     opt_dp=(self.opt_dp.state_dict()
                             if self.opt_dp is not None else {}),
                     epoch=self.epoch, total_it=self.total_it))
        pmesh.barrier(self.mesh)
        return path

    def restore(self, workdir: str | None = None, step=None) -> None:
        """Load the checkpoint of ``step`` (an int or "latest"; by default
        the newest).  A checkpoint without optimizer state (the inference
        slice's) leaves the optimizers fresh."""
        path = resolve_checkpoint(workdir or self.workdir, step)
        tree = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict({**tree["params"], **tree["batch_stats"]})
        if self.dp_model is not None:
            self.dp_model.load_state_dict(tree["dp_params"])
        if tree.get("opt"):
            self.opt.load_state_dict(tree["opt"])
        if self.opt_dp is not None and tree.get("opt_dp"):
            self.opt_dp.load_state_dict(tree["opt_dp"])
        self.epoch = int(tree["epoch"])
        self.total_it = int(tree["total_it"])
        self.flat_warmup = _flat_warmup_after(self.total_it)

    # -- pseudo-ground-truth generation --------------------------------------

    def generate_pseudogt(self, loader, cache_dir: str, dataset_name: str,
                          pseudogt_resolution: int = 512,
                          inception_resolution: int = 299,
                          paths: list | None = None, val_loader=None,
                          renderer_resolution: int | None = None,
                          inception=None) -> None:
        """Write the pseudo-ground-truth cache in the reference layout:
        per-image ``pseudogt_<R>x<R>/<idx>.npz`` holding ``data`` = {mesh,
        texture, texture_alpha, image}, float16 NCHW; ``poses_metadata.npz``;
        ``precomputed_fid_<r>x<r>_train.npz`` (and ``_testval`` for CUB with
        ``val_loader``), ``stats_s`` lower-triangular float32.

        Per batch: predict, pose, down-resize the texture to
        ``renderer_res // 8``; visibility is the gradient of the summed
        render at ``renderer_res`` with respect to that texture (K5's
        backward on CUDA); the photo ``hd_image`` is inverse-rendered into
        UV space at ``pseudogt_resolution`` and masked where the resized
        visibility is > 0 in any channel; Inception activations of
        ``inception_image`` (in [-1, 1]).  ``renderer_resolution`` defaults
        to max(1024, 2 R); ``inception`` defaults to the calibrated random
        ``init_inception()`` (288-d Mixed_5d features, as the JAX
        package)."""
        from im23d_tpu_torch.metrics.fid import calculate_stats
        from im23d_tpu_torch.metrics.inception import init_inception
        from im23d_tpu_torch.render.inverse import (
            inverse_render,
            visibility_mask,
        )

        R = pseudogt_resolution
        renderer_res = renderer_resolution or max(1024, 2 * R)
        pseudogt_dir = os.path.join(cache_dir, f"pseudogt_{R}x{R}")
        os.makedirs(pseudogt_dir, exist_ok=True)
        if inception is None:
            inception = init_inception(device=self.device)
        template = self.template
        dev = self.device

        def render_for_vis(vtx, tex):
            uvs, tex_adj = template.adjust_uv_and_texture(tex)
            image, _, _ = render_mesh(
                vtx, template.tensor("faces", dev), uvs,
                template.tensor("face_uvs", dev), tex_adj, renderer_res,
                renderer_res)
            return image

        def activations(images):
            x = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                                device=dev)
            with torch.no_grad():
                return inception(x / 2.0 + 0.5).cpu().numpy()

        all_act, all_path = [], []
        poses = {k: [] for k in ("scale", "translation", "rotation")}
        for batch in loader:
            nb = self._put({k: batch[k] for k in
                            ("scale", "translation", "rotation", "idx")
                            if k in batch})
            tex, mesh_map = self.predict(batch["image"])
            with torch.no_grad():
                vtx = self._pose(template.get_vertex_positions(mesh_map), nb)
            if tex.shape[1] > renderer_res // 8:
                tex = resize_bilinear(tex, renderer_res // 8,
                                      renderer_res // 8, align_corners=False)
            visibility = visibility_mask(render_for_vis, vtx, tex)
            hd = torch.as_tensor(np.asarray(batch["hd_image"]),
                                 dtype=torch.float32, device=dev)
            with torch.no_grad():
                inv_tex, inv_alpha = inverse_render(template, vtx, hd, R)
                mask = resize_bilinear(visibility, R, R, align_corners=False)
                mask = (mask > 0).any(dim=-1, keepdim=True).to(inv_tex.dtype)
                inv_tex = inv_tex * mask
                inv_alpha = inv_alpha * mask

            all_act.append(activations(batch["inception_image"]))
            for k in poses:
                poses[k].append(np.asarray(batch[k]))
            mesh_np = mesh_map.cpu().numpy()
            tex_np = inv_tex.cpu().numpy().astype(np.float16)
            alpha_np = inv_alpha.cpu().numpy().astype(np.float16)
            img_np = np.asarray(batch["inception_image"], np.float16)
            for i, idx in enumerate(np.asarray(batch["idx"]).reshape(-1)):
                idx = int(idx)
                if paths is not None:
                    all_path.append(paths[idx])
                pseudogt = {  # NCHW, the reference cache layout
                    "mesh": mesh_np[i].transpose(2, 0, 1),
                    "texture": tex_np[i].transpose(2, 0, 1),
                    "texture_alpha": alpha_np[i].transpose(2, 0, 1),
                    "image": img_np[i].transpose(2, 0, 1),
                }
                np.savez_compressed(os.path.join(pseudogt_dir, f"{idx}"),
                                    data=pseudogt)

        np.savez_compressed(os.path.join(cache_dir, "poses_metadata"), data={
            "scale": np.concatenate(poses["scale"], axis=0)[:, None],
            "translation": np.concatenate(poses["translation"], axis=0),
            "rotation": np.concatenate(poses["rotation"], axis=0),
            "path": all_path,
        })

        def write_stats(act, split):
            m, sigma = calculate_stats(act)
            r = inception_resolution
            np.savez_compressed(
                os.path.join(cache_dir, f"precomputed_fid_{r}x{r}_{split}"),
                stats_m=m, stats_s=np.tril(sigma.astype(np.float32)),
                num_images=len(act), resolution=r)

        act = np.concatenate(all_act, axis=0)
        if dataset_name == "p3d" and all_path:
            act = act[[i for i, p in enumerate(all_path)
                       if str(p).startswith("car_imagenet")]]
        write_stats(act, "train")
        if dataset_name == "cub" and val_loader is not None:
            write_stats(np.concatenate(
                [activations(np.asarray(b["inception_image"])[..., :3])
                 for b in val_loader], axis=0), "testval")
