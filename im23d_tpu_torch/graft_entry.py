"""Entry points of the port: one-device compile check and multi-rank dry run
(counterparts of ``__graft_entry__.py``'s ``entry`` and
``dryrun_multichip``).

The device is explicit and is used as given: asked for ``"cuda"`` without
a card, these raise rather than run on the CPU.

    python -c "from im23d_tpu_torch.graft_entry import dryrun_multichip; \\
        dryrun_multichip(2)"
"""

from __future__ import annotations

import math
import time

import torch

B, V, K = 2, 5, 4  # the JAX entry's batch, views and pose candidates
IMAGE_SIZE, VOXEL_SIZE, NUM_POINTS = 128, 64, 2000


def entry(device: str = "cuda"):
    """(fn, example_args): the Pipeline-A forward (``UnsupervisedPart``,
    seeded He init) plus ``unsupervised_loss(training=True)`` at sigma 1,
    on zero images at the JAX entry's shapes (B 2, V 5, K 4, 128², 64³,
    2000 points).  ``fn(params, images, pose_input, masks, keep_w)``
    returns the total loss; ``params`` is the model's state dict (through
    ``torch.func.functional_call``) and ``keep_w`` a (B, N) keep mask at
    p 0.5.  On a card the projection runs kernel K1."""
    from torch.func import functional_call

    from im23d_tpu_torch.losses.effective import unsupervised_loss
    from im23d_tpu_torch.models.pointcloud_nets import (
        UnsupervisedPart,
        kaiming_init_,
    )
    from im23d_tpu_torch.ops.pointcloud import keep_mask

    dev = torch.device(device)
    model = UnsupervisedPart(image_size=IMAGE_SIZE, num_points=NUM_POINTS,
                             num_candidates=K).to(dev)
    kaiming_init_(model, torch.Generator(device=dev).manual_seed(0))
    params = dict(model.state_dict())
    images = torch.zeros((B, IMAGE_SIZE, IMAGE_SIZE, 3), device=dev)
    pose_input = torch.zeros((B * V, IMAGE_SIZE, IMAGE_SIZE, 3), device=dev)
    masks = torch.zeros((B * V, IMAGE_SIZE, IMAGE_SIZE), device=dev)
    keep_w = keep_mask(torch.Generator(device=dev).manual_seed(1), B,
                       NUM_POINTS, 0.5)
    sigma = torch.ones((), device=dev)

    def fn(params, images, pose_input, masks, keep_w):
        outputs = functional_call(model, params, (images, pose_input))
        losses, _ = unsupervised_loss(outputs, masks, sigma, keep_w, V,
                                      voxel_size=VOXEL_SIZE, training=True)
        return losses["total_loss"]

    return fn, (params, images, pose_input, masks, keep_w)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """One training step of each pipeline on ``n_devices`` spawned ranks
    (gloo, ``parallel/launch.py``), the stages of the JAX dry run: a tiny
    chairs step in dp x tp (tp 2 when ``n_devices`` is even), a GAN G step
    and D step in dp, a recon step in dp, then the production chairs step
    (bs 24, 8000 points, 64³: on CUDA only; on the CPU, where it would take
    minutes, it prints that it is skipped).  Rank 0 prints each stage's
    "ok" line; returns each rank's losses by stage."""
    from im23d_tpu_torch.parallel.launch import launch

    return launch(_dryrun_rank, n_devices, device, time.time())


def _finite(name: str, value: float) -> float:
    if not math.isfinite(value):
        raise AssertionError(f"non-finite loss in the {name} stage: {value}")
    return value


def _dryrun_rank(rank: int, world: int, dev: torch.device,
                 t_start: float) -> dict:
    import dataclasses

    from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
    from im23d_tpu_torch.models.gan import GANConfig
    from im23d_tpu_torch.parallel import stages
    from im23d_tpu_torch.parallel.mesh import make_2d_mesh
    from im23d_tpu_torch.train.gan_trainer import GANTrainConfig
    from im23d_tpu_torch.train.recon_trainer import ReconConfig
    from im23d_tpu_torch.train.shapenet_learner import ShapeNetConfig

    def say(msg: str) -> None:
        if rank == 0:
            print(f"dryrun_multichip({world}, {msg} [t+"
                  f"{time.time() - t_start:.0f}s]", flush=True)

    def chairs_loss(cfg: ShapeNetConfig) -> float:
        stage = stages.chairs(cfg, stages.chairs_batch(cfg), mesh, dev)
        return _finite("chairs", stage.step()["total_loss"])

    out = {}
    tp = 2 if world % 2 == 0 else 1
    mesh = make_2d_mesh(tp)
    dp = mesh.data_size
    layout = "dp x tp" if tp > 1 else "dp"
    # a global batch divisible by the data axis, as in JAX
    out["chairs"] = chairs_loss(ShapeNetConfig(**stages.TINY_CHAIRS,
                                               batch_size=max(2, dp)))
    say(f"{layout}): total_loss={out['chairs']:.4f} ok")

    # the GAN and recon steps: every rank on the data axis
    dp_mesh = make_2d_mesh(1)
    gb = max(2, world)
    tpl = MeshTemplate(segments=8, rings=4)
    cfg = GANTrainConfig(model=GANConfig(**stages.TINY_GAN), batch_size=gb)
    gan = stages.gan(cfg, stages.gan_batch(cfg), dp_mesh, dev, tpl)
    gan.step()  # a G step, then a D step
    out["gan"] = {k: _finite("gan", v) for k, v in gan.step().items()}
    say("gan dp): ok")

    cfg = ReconConfig(batch_size=gb, **stages.TINY_RECON)
    recon = stages.recon(cfg, stages.recon_batch(cfg), dp_mesh, dev, tpl)
    out["recon"] = _finite("recon", recon.step()["recon_loss"])
    say("recon dp): ok")

    chairs = ShapeNetConfig.chairs()
    global_b = -(-chairs.batch_size // dp) * dp
    if dev.type != "cuda":
        say(f"chairs production bs{global_b}): skipped on the CPU")
        return out
    out["chairs_production"] = chairs_loss(
        dataclasses.replace(chairs, batch_size=global_b))
    say(f"chairs production bs{global_b}/8000pts/voxel64/KV20): "
        f"total_loss={out['chairs_production']:.2f} ok")
    return out
