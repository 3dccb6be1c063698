"""ShapeNet unsupervised learner: config, seeded init, AdamW train step,
eval step, training loop and checkpoints.

Counterpart of ``im23d_tpu/train/shapenet_learner.py``, on one device or
on a rank of a ``parallel.mesh.Mesh``:

* AdamW with the ``optax.adamw`` hyperparameters over every parameter;
* linear p/sigma schedules taken at the pre-update step as device scalars,
  so sigma reaches the projection kernels as a tensor and the step makes no
  host sync;
* the dropout keep mask drawn from a generator seeded by (seed, step);
* checkpoints ``{params, opt_state, step}`` by ``torch.save``, numbered or
  under the rolling tag ``latest``;
* while a profiler records, the spans ``im23d.train.step`` and in it
  ``.put``, ``.forward``, ``.loss`` (the K-way sweep ``.project`` nested
  in it), ``.optimizer``, ``.backward``, ``.optimizer``; the batch's
  host-to-device bytes in ``COUNTERS["h2d_bytes"]`` (``core/profiler.py``);
* on a mesh, ``batch_size`` is the rank's; the batch splits over the data
  axis (the keep mask is drawn for the global batch and sliced), the
  layers of ``dense_tp_layers`` split over the model axis, gradients and
  losses are averaged over the data group, and rank 0 writes checkpoints
  at full width (the one-process format) while the others wait.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator

import numpy as np
import torch

from im23d_tpu_torch.core.checkpoint import resolve_checkpoint, save_checkpoint
from im23d_tpu_torch.core.convert import unsupervised_part_state_dict
from im23d_tpu_torch.core.metrics_logger import MetricsLogger
from im23d_tpu_torch.core.profiler import span, to_device
from im23d_tpu_torch.losses.effective import unsupervised_loss
from im23d_tpu_torch.models.pointcloud_nets import (
    UnsupervisedPart,
    kaiming_init_,
)
from im23d_tpu_torch.ops.pointcloud import keep_mask
from im23d_tpu_torch.ops.sampling import resize_bilinear
from im23d_tpu_torch.parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class ShapeNetConfig:
    """Per-category run config (same fields and values as the JAX one)."""

    image_size: int = 128
    voxel_size: int = 64
    num_points: int = 8000
    num_views: int = 5
    num_candidates: int = 4
    batch_size: int = 24
    learning_rate: float = 1e-3
    weight_decay: float = 1e-3
    total_steps: int = 130_000
    p_schedule: tuple[float, float] = (0.07, 1.0)
    sigma_schedule: tuple[float, float] = (3.0, 0.2)
    student_weight: float = 20.0
    eval_every: int = 13_000
    log_every: int = 50
    seed: int = 100
    # encoder / pose-trunk compute dtype ("auto" = bfloat16 on CUDA, float32
    # on CPU); the heads and the projection loss stay float32
    compute_dtype: str = "auto"

    @staticmethod
    def chairs() -> "ShapeNetConfig":
        return ShapeNetConfig()

    @staticmethod
    def planes() -> "ShapeNetConfig":
        return ShapeNetConfig(
            image_size=64, voxel_size=32, num_points=4000, batch_size=16,
            learning_rate=1e-4, total_steps=30_000,
            p_schedule=(0.256, 1.0), sigma_schedule=(2.44, 0.2),
            eval_every=10_000,
        )

    @staticmethod
    def cars() -> "ShapeNetConfig":
        return ShapeNetConfig(
            image_size=64, voxel_size=32, num_points=4000, batch_size=16,
            learning_rate=1e-4, total_steps=50_000,
            p_schedule=(0.2095, 1.0), sigma_schedule=(2.58, 0.2),
            eval_every=10_000,
        )


def _interp(schedule: tuple[float, float], frac: torch.Tensor) -> torch.Tensor:
    lo, hi = schedule
    return lo * (1.0 - frac) + hi * frac


class ShapeNetLearner:
    """Holds the model and its AdamW optimizer on ``device``, the step
    counter and, with a ``workdir``, the metrics logger (rank 0's alone on
    a ``mesh``)."""

    def __init__(self, config: ShapeNetConfig, workdir: str | None = None,
                 device: str | torch.device = "cuda",
                 mesh: pmesh.Mesh | None = None):
        self.cfg = config
        self.workdir = workdir
        self.device = torch.device(device)
        self.mesh = mesh
        self.data_group = None if mesh is None else mesh.data_group
        dt = config.compute_dtype
        if dt == "auto":
            dt = "bfloat16" if self.device.type == "cuda" else "float32"
        self.model = UnsupervisedPart(
            image_size=config.image_size,
            num_points=config.num_points,
            num_candidates=config.num_candidates,
            compute_dtype=getattr(torch, dt),
        ).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(config.seed)
        kaiming_init_(self.model, gen)
        if mesh is not None and mesh.tp > 1:
            pmesh.parallelize_columns(
                self.model, pmesh.dense_tp_layers(self.model, mesh.tp), mesh)
        self.model.eval()
        self.opt = torch.optim.AdamW(
            self.model.parameters(), lr=config.learning_rate,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=config.weight_decay,
        )
        self.step = 0
        self._last_min_idx = None
        self.logger = (MetricsLogger(workdir, "shapenet")
                       if workdir and pmesh.is_main(mesh) else None)

    # -- schedules and batches ---------------------------------------------

    def _schedules(self, step: int):
        """(p, sigma) as device scalars at ``step``."""
        frac = torch.clamp(
            torch.full((), step / float(self.cfg.total_steps),
                       dtype=torch.float32, device=self.device),
            0.0, 1.0,
        )
        return _interp(self.cfg.p_schedule, frac), _interp(
            self.cfg.sigma_schedule, frac
        )

    def _normalize(self, batch: dict) -> dict:
        """numpy or torch arrays -> device tensors; uint8 batches are sent
        as uint8 (4x fewer bytes) and become float32 / 255 on the device.
        The copies are dispatched without waiting for them; a batch it has
        already normalized comes back as it is."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            t = to_device(t, self.device, non_blocking=True)
            out[k] = (t.to(torch.float32) / 255.0 if t.dtype == torch.uint8
                      else t.to(torch.float32))
        return out

    def _keep_mask(self, batch_size: int, p, seed_offset: int = 0):
        """This rank's rows of the global batch's mask."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed * 2**32 + seed_offset + self.step
        )
        d, dp = pmesh.data_position(self.mesh)
        return keep_mask(gen, batch_size * dp, self.cfg.num_points,
                         p)[d * batch_size:(d + 1) * batch_size]

    # -- training -------------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One AdamW step on ``batch`` (host arrays, or the device tensors
        of ``put_batch``); returns the losses as device scalars (no host
        sync).  The schedules are taken at the pre-update step and the keep
        mask comes from a generator seeded by (seed, step)."""
        cfg, it = self.cfg, self.step
        with span("train.step", it):
            with span("train.put", it):
                nb = self._normalize(batch)
            with span("train.forward", it):
                self.model.train()
                p, sigma = self._schedules(self.step)
                keep_w = self._keep_mask(nb["images"].shape[0], p)
                outputs = self.model(nb["images"], nb["pose_input"])
            with span("train.loss", it):
                losses, aux = unsupervised_loss(
                    outputs, nb["masks"], sigma, keep_w, cfg.num_views,
                    voxel_size=cfg.voxel_size,
                    student_weight=cfg.student_weight, training=True,
                )
            with span("train.optimizer", it):
                self.opt.zero_grad(set_to_none=True)
            with span("train.backward", it):
                losses["total_loss"].backward()
                pmesh.all_reduce_grads(self.model.parameters(),
                                       self.data_group)
            with span("train.optimizer", it):
                self.opt.step()
        self.step += 1
        self._last_min_idx = aux["min_indexes"]
        return pmesh.mean_over({k: v.detach() for k, v in losses.items()},
                               self.data_group)

    def put_batch(self, batch: dict) -> dict:
        """Dispatch the host->device copy of a batch (it overlaps with the
        running step)."""
        with span("train.put", self.step):
            return self._normalize(batch)

    def fit(self, train_iter: Iterator[dict], num_steps: int | None = None,
            valid_batches=None) -> dict:
        """Run the training loop; returns the final losses as floats.

        The next batch's host->device copy is dispatched before the current
        step.  Every ``log_every`` steps the losses, ``steps_per_sec`` and
        the predictor histogram are logged; every ``eval_every`` steps the
        learner evaluates, logs a projection grid and saves a checkpoint.
        """
        cfg = self.cfg
        num_steps = num_steps or cfg.total_steps
        losses: dict[str, Any] = {}
        t0 = time.time()
        pending = self.put_batch(next(train_iter))
        for i in range(num_steps):
            batch_dev = pending
            if i + 1 < num_steps:
                pending = self.put_batch(next(train_iter))
            losses = self.train_step(batch_dev)
            step = self.step
            if self.logger and step % cfg.log_every == 0:
                host = {k: float(v) for k, v in losses.items()}
                host["steps_per_sec"] = cfg.log_every / max(time.time() - t0,
                                                            1e-9)
                t0 = time.time()
                self.logger.log(step, host)
                self.logger.log_histogram(step, "other/predictors",
                                          self._last_min_idx.cpu().numpy())
            if step % cfg.eval_every == 0:
                if valid_batches is not None:
                    self.evaluate(valid_batches)
                if self.workdir:
                    self.log_projection_grid(batch_dev, step)
                    self.save()
        return {k: float(v) for k, v in losses.items()}

    @torch.no_grad()
    def log_projection_grid(self, batch: dict, step: int) -> None:
        """Log the student projections of up to 8 pose images under the
        target masks (eval mode, no dropout, the scheduled sigma); every
        rank of a mesh computes them (tensor-parallel layers gather), rank
        0 logs."""
        cfg = self.cfg
        nb = self._normalize(batch)
        self.model.eval()
        out = self.model(nb["images"], nb["pose_input"])
        _, sigma = self._schedules(self.step)
        _, aux = unsupervised_loss(out, nb["masks"], sigma, None,
                                   cfg.num_views, voxel_size=cfg.voxel_size,
                                   training=False)
        if self.logger is None:
            return
        proj = aux["projection"][:8]
        masks_s = resize_bilinear(nb["masks"][:8], proj.shape[1],
                                  proj.shape[2])
        self.logger.log_images(
            step, "renders",
            torch.cat([masks_s, proj], dim=0).cpu().numpy(), nrow=8,
        )

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Eval-mode projection loss of one batch (dict of device scalars).

        The dropout keep mask is drawn at the scheduled p from a generator
        seeded by (seed, step), the same for every batch of one evaluation.
        On a mesh the losses are the global batch's means.
        """
        cfg = self.cfg
        nb = self._normalize(batch)
        self.model.eval()
        outputs = self.model(nb["images"], nb["pose_input"])
        p, sigma = self._schedules(self.step)
        keep_w = self._keep_mask(nb["images"].shape[0], p, seed_offset=2**30)
        losses, _ = unsupervised_loss(
            outputs, nb["masks"], sigma, keep_w, cfg.num_views,
            voxel_size=cfg.voxel_size, student_weight=cfg.student_weight,
            training=False,
        )
        return pmesh.mean_over(losses, self.data_group)

    def evaluate(self, valid_batches) -> dict:
        """Mean of each eval loss over ``valid_batches`` (iterable or
        callable returning one); logged as ``valid/<loss>``."""
        all_losses = []
        batches = valid_batches() if callable(valid_batches) else valid_batches
        for batch in batches:
            out = self.eval_step(batch)
            all_losses.append({k: float(v) for k, v in out.items()})
        if not all_losses:
            return {}
        means = {k: float(np.mean([d[k] for d in all_losses]))
                 for k in all_losses[0]}
        if self.logger:
            self.logger.log(self.step,
                            {f"valid/{k}": v for k, v in means.items()})
        return means

    # -- params and checkpoints -------------------------------------------

    def load_params(self, flax_params: dict) -> None:
        """Load JAX ``UnsupervisedPart`` params (nested numpy dicts)."""
        sd = unsupervised_part_state_dict(flax_params,
                                          self.cfg.num_candidates)
        pmesh.load_full_state(self.model, self.opt, self.mesh, sd, None)

    def save(self, workdir: str | None = None, tag: str | None = None) -> str:
        """``torch.save`` of ``{params, opt_state, step}``: tag None writes
        the permanent checkpoint_<step>.pt, tag "latest" overwrites the
        rolling checkpoint_latest.pt.  On a mesh every rank gathers the
        column slices, rank 0 writes and the others wait for it."""
        params, opt_state = pmesh.full_state(self.model, self.opt, self.mesh)
        path = None
        if pmesh.is_main(self.mesh):
            path = save_checkpoint(
                workdir or self.workdir, self.step if tag is None else tag,
                dict(params=params, opt_state=opt_state, step=self.step))
        pmesh.barrier(self.mesh)
        return path

    def restore(self, workdir: str | None = None, step=None) -> None:
        """Load the checkpoint of ``step`` (an int or "latest"); by default
        the newer, by file time, of the highest numbered one and the rolling
        "latest".  A checkpoint without ``opt_state`` leaves the optimizer
        as it is."""
        path = resolve_checkpoint(workdir or self.workdir, step)
        tree = torch.load(path, map_location=self.device, weights_only=True)
        pmesh.load_full_state(self.model, self.opt, self.mesh,
                              tree["params"], tree.get("opt_state"))
        self.step = int(tree["step"])
