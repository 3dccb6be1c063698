"""ShapeNet unsupervised learner: config, seeded init, eval step, checkpoints.

Counterpart of the inference surface of
``im23d_tpu/train/shapenet_learner.py``.  The p/sigma schedules are device
scalars derived from the step, so sigma reaches the projection kernel as a
tensor, never as a constant.  No optimizer or train step yet.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from im23d_tpu_torch.core.convert import unsupervised_part_state_dict
from im23d_tpu_torch.losses.effective import unsupervised_loss
from im23d_tpu_torch.models.pointcloud_nets import (
    UnsupervisedPart,
    kaiming_init_,
)
from im23d_tpu_torch.ops.pointcloud import keep_mask


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


_CKPT = re.compile(r"^checkpoint_(\d+)\.pt$")


class ShapeNetLearner:
    """Holds the model on ``device`` and the step counter."""

    def __init__(self, config: ShapeNetConfig, workdir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.cfg = config
        self.workdir = workdir
        self.device = torch.device(device)
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
        self.model.eval()
        self.step = 0

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
        as uint8 (4x fewer bytes) and become float32 / 255 on the device."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
            t = t.to(self.device, non_blocking=True)
            out[k] = (t.to(torch.float32) / 255.0 if t.dtype == torch.uint8
                      else t.to(torch.float32))
        return out

    # -- inference ----------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, batch: dict) -> dict:
        """Eval-mode projection loss of one batch (dict of device scalars).

        The dropout keep mask is drawn at the scheduled p from a generator
        seeded by (seed, step), the same for every batch of one evaluation.
        """
        cfg = self.cfg
        nb = self._normalize(batch)
        outputs = self.model(nb["images"], nb["pose_input"])
        p, sigma = self._schedules(self.step)
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed * 2**32 + 2**30 + self.step
        )
        keep_w = keep_mask(gen, nb["images"].shape[0], cfg.num_points, p)
        losses, _ = unsupervised_loss(
            outputs, nb["masks"], sigma, keep_w, cfg.num_views,
            voxel_size=cfg.voxel_size, student_weight=cfg.student_weight,
            training=False,
        )
        return losses

    def evaluate(self, valid_batches) -> dict:
        """Mean of each eval loss over ``valid_batches`` (iterable or
        callable returning one)."""
        all_losses = []
        batches = valid_batches() if callable(valid_batches) else valid_batches
        for batch in batches:
            out = self.eval_step(batch)
            all_losses.append({k: float(v) for k, v in out.items()})
        if not all_losses:
            return {}
        return {k: float(np.mean([d[k] for d in all_losses]))
                for k in all_losses[0]}

    # -- params and checkpoints -------------------------------------------

    def load_params(self, flax_params: dict) -> None:
        """Load JAX ``UnsupervisedPart`` params (nested numpy dicts)."""
        sd = unsupervised_part_state_dict(flax_params,
                                          self.cfg.num_candidates)
        self.model.load_state_dict(sd)

    def save(self, workdir: str | None = None) -> str:
        """``torch.save`` of ``{params, step}`` as checkpoint_<step>.pt."""
        workdir = workdir or self.workdir
        os.makedirs(workdir, exist_ok=True)
        path = os.path.join(workdir, f"checkpoint_{self.step}.pt")
        params = {k: v.detach().cpu() for k, v in
                  self.model.state_dict().items()}
        torch.save(dict(params=params, step=self.step), path)
        return path

    def restore(self, workdir: str | None = None,
                step: int | None = None) -> None:
        """Load the checkpoint of ``step`` (default: the latest)."""
        workdir = workdir or self.workdir
        steps = sorted(
            int(m.group(1)) for m in map(_CKPT.match, os.listdir(workdir))
            if m
        ) if os.path.isdir(workdir) else []
        if step is None and steps:
            step = steps[-1]
        if step is None or step not in steps:
            raise FileNotFoundError(f"no checkpoint {step} under {workdir}")
        tree = torch.load(os.path.join(workdir, f"checkpoint_{step}.pt"),
                          map_location=self.device, weights_only=True)
        self.model.load_state_dict(tree["params"])
        self.step = int(tree["step"])
