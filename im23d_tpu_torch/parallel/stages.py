"""One training step of each pipeline on a ``Mesh`` or in one process: the
stages of ``graft_entry.dryrun_multichip``, at the sizes the caller gives.

A stage builds its trainer for this rank's share of a global batch and
keeps this rank's rows of it: on a ``parallel.mesh.Mesh`` rows ``[d * b,
(d + 1) * b)`` at data rank ``d``, with ``mesh=None`` the whole batch in
one process, so that the two runs can be held against each other.  A
config's ``batch_size`` is the global batch here (the CLIs' is per
process).  The dry run takes the stages at the tiny sizes below and at
the chairs production size, the CPU tests hold 2 ranks against one
process, and ``chip_smoke.py`` does so at the CLIs' sizes on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from im23d_tpu_torch.parallel import mesh as pmesh

# the JAX dry run's tiny chairs config, and recon and GAN sizes as small
TINY_CHAIRS = dict(image_size=32, voxel_size=16, num_points=128,
                   num_views=2, num_candidates=2, total_steps=10)
TINY_RECON = dict(image_resolution=64, texture_resolution=64,
                  mesh_resolution=32, optimize_deltas=True, optimize_z0=True)
TINY_GAN = dict(texture_resolution=128, mesh_resolution=32)


@dataclasses.dataclass
class Stage:
    """A trainer and this rank's rows of the global batch."""

    trainer: object
    rows: dict

    def step(self) -> dict:
        """One train step on the rows; its losses as floats."""
        return {k: float(v)
                for k, v in self.trainer.train_step(self.rows).items()}


def _share(cfg, mesh):
    d, dp = pmesh.data_position(mesh)
    return d, dp, dataclasses.replace(cfg, batch_size=cfg.batch_size // dp)


def chairs_batch(cfg, seed: int = 0) -> dict:
    """``cfg.batch_size`` synthetic chairs samples (host uint8 arrays)."""
    from im23d_tpu_torch.data.synthetic import SyntheticSilhouettes

    return SyntheticSilhouettes(cfg.batch_size, cfg.image_size,
                                cfg.num_views, seed=seed).next_batch()


def recon_batch(cfg, seed: int = 0) -> dict:
    """``cfg.batch_size`` random RGBA photos and poses of a dataset of twice
    as many instances (``idx`` the even ones)."""
    b, res = cfg.batch_size, cfg.image_resolution
    gen = torch.Generator().manual_seed(seed)
    return dict(image=torch.rand((b, res, res, 4), generator=gen),
                scale=0.6 + 0.2 * torch.rand((b,), generator=gen),
                translation=0.1 * torch.randn((b, 3), generator=gen),
                rotation=torch.randn((b, 4), generator=gen),
                idx=torch.arange(b) * 2)


def gan_batch(cfg, seed: int = 0) -> dict:
    """``cfg.batch_size`` random textures, alpha masks and mesh maps (and
    classes under class conditioning) at the model's resolutions."""
    m, b = cfg.model, cfg.batch_size
    t, r = m.texture_resolution, m.mesh_resolution
    gen = torch.Generator().manual_seed(seed)
    out = dict(texture=2 * torch.rand((b, t, t, 3), generator=gen) - 1,
               alpha=(torch.rand((b, t, t, 1), generator=gen) > 0.3).float(),
               mesh=0.01 * torch.randn((b, r, r, 3), generator=gen))
    if m.conditional_class:
        out["c"] = torch.randint(0, m.n_classes[0], (b, 1), generator=gen)
    return out


def chairs(cfg, batch: dict, mesh, device) -> Stage:
    """The chairs ``ShapeNetLearner`` (He init from ``cfg.seed``)."""
    from im23d_tpu_torch.train.shapenet_learner import ShapeNetLearner

    d, dp, cfg = _share(cfg, mesh)
    return Stage(ShapeNetLearner(cfg, device=device, mesh=mesh),
                 pmesh.shard_rows(batch, d, dp))


def recon(cfg, batch: dict, mesh, device, template) -> Stage:
    """The ``ReconTrainer`` over a dataset of ``recon_batch``'s size."""
    from im23d_tpu_torch.train.recon_trainer import ReconTrainer

    d, dp, cfg = _share(cfg, mesh)
    trainer = ReconTrainer(cfg, dataset_size=int(batch["idx"].max()) + 1,
                           template=template, device=device, mesh=mesh)
    return Stage(trainer, pmesh.shard_rows(batch, d, dp))


def gan(cfg, batch: dict, mesh, device, template) -> Stage:
    """The ``GANTrainer``; its rows staged on the device once (each
    ``step`` is then a G step or a D step, as the trainer's schedule
    says)."""
    from im23d_tpu_torch.train.gan_trainer import GANTrainer

    d, dp, cfg = _share(cfg, mesh)
    trainer = GANTrainer(cfg, template=template, device=device, mesh=mesh)
    return Stage(trainer, trainer.put_batch(pmesh.shard_rows(batch, d, dp)))


def grads(module: torch.nn.Module, mesh=None) -> dict:
    """The gradients of ``module``'s parameters at full width (a
    column-parallel parameter's slices gathered over the model group:
    every rank of it must call this)."""
    sharded = set() if mesh is None else pmesh.sharded_params(module)
    return {k: (pmesh.gather_rows(p.grad, mesh) if k in sharded
                else p.grad.detach().clone())
            for k, p in module.named_parameters() if p.grad is not None}
