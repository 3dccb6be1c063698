"""Rank functions for ``tests/test_torch_port_parallel.py``.

They run in processes spawned by ``im23d_tpu_torch.parallel.launch``, which
import this module by name: it imports torch and the port only (no JAX,
so a rank starts in seconds).  Each takes ``(rank, world, device, ...)`` and
returns host tensors.
"""

from __future__ import annotations

import copy
import datetime
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from im23d_tpu_torch.geometry.mesh_template import MeshTemplate
from im23d_tpu_torch.models.gan import GANConfig
from im23d_tpu_torch.models.reconstruction import _bn
from im23d_tpu_torch.parallel import mesh as pmesh
from im23d_tpu_torch.parallel import stages
from im23d_tpu_torch.train.gan_trainer import GANTrainConfig
from im23d_tpu_torch.train.recon_trainer import ReconConfig
from im23d_tpu_torch.train.shapenet_learner import ShapeNetConfig


# -- (a) cross-replica batch norm ---------------------------------------------


def bn_rank(rank, world, device, weight, x, y, stats):
    """conv (no bias) -> ``_bn`` over the data group -> relu on this rank's
    rows; returns the output rows, the running statistics after the step,
    the input gradient of the global mean loss and the parameter
    gradients averaged over the ranks."""
    mesh = pmesh.make_2d_mesh()
    rows = slice(rank * len(x) // world, (rank + 1) * len(x) // world)
    conv = torch.nn.Conv2d(weight.shape[1], weight.shape[0], 3, padding=1,
                           bias=False)
    bn = torch.nn.BatchNorm2d(weight.shape[0], eps=1e-5, momentum=0.01)
    with torch.no_grad():
        conv.weight.copy_(weight)
        bn.running_mean.copy_(stats[0])
        bn.running_var.copy_(stats[1])
    bn.train()
    xr = x[rows].clone().requires_grad_()
    with pmesh.batch_norm_group(mesh.data_group):
        out = F.relu(_bn(bn, conv(xr.permute(0, 3, 1, 2))))
    loss = ((out.permute(0, 2, 3, 1) - y[rows]) ** 2).mean()
    loss.backward()
    params = list(conv.parameters()) + list(bn.parameters())
    pmesh.all_reduce_grads(params, mesh.data_group)
    return dict(out=out.permute(0, 2, 3, 1).detach(),
                running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(),
                dx=xr.grad / world,  # each rank's loss is a 1/world share
                dw=conv.weight.grad, dscale=bn.weight.grad,
                dbias=bn.bias.grad)


# -- (b) the chairs step in dp x tp -------------------------------------------


def chairs_rank(rank, world, device, tp, global_b, flax_params, batch,
                keep):
    """One chairs step at dp x tp from converted params, the global batch
    and keep mask given; returns the losses and the gradients before AdamW
    at full width (the model group's slices gathered)."""
    mesh = pmesh.make_2d_mesh(tp)
    cfg = ShapeNetConfig(batch_size=global_b, **stages.TINY_CHAIRS)
    stage = stages.chairs(cfg, batch, mesh, device)
    stage.trainer.load_params(flax_params)
    rows = pmesh.shard_rows(keep, mesh.data_rank, mesh.data_size)
    stage.trainer._keep_mask = lambda n, p, seed_offset=0: rows
    losses = stage.step()
    return dict(losses=losses, grads=stages.grads(stage.trainer.model, mesh),
                sharded=sorted(pmesh.sharded_params(stage.trainer.model)))


# -- (c) the three steps at dp 2 against one process --------------------------


def steps(mesh, device, global_b: int) -> dict:
    """The chairs, recon and GAN (G step, then D step) stages at the global
    batch ``global_b`` on ``mesh`` (None: one process): the losses,
    gradients and the state the steps move, and the chairs and recon
    ``evaluate``."""
    d, dp = pmesh.data_position(mesh)
    out = {}
    cfg = ShapeNetConfig(batch_size=global_b, **stages.TINY_CHAIRS)
    chairs = stages.chairs(cfg, stages.chairs_batch(cfg), mesh, device)
    out["chairs_losses"] = chairs.step()
    out["chairs_grads"] = stages.grads(chairs.trainer.model)
    out["chairs_eval"] = chairs.trainer.evaluate([chairs.rows])

    tpl = MeshTemplate(segments=8, rings=4)
    cfg = ReconConfig(batch_size=global_b, **stages.TINY_RECON)
    batch = stages.recon_batch(cfg, seed=3)
    recon = stages.recon(cfg, batch, mesh, device, tpl)
    out["recon_losses"] = recon.step()
    out["recon_grads"] = {**stages.grads(recon.trainer.model), **{
        f"dp.{k}": g for k, g in stages.grads(recon.trainer.dp_model).items()}}
    out["recon_stats"] = {k: v.clone() for k, v in
                          recon.trainer.model.named_buffers()}
    # a full global batch, then a tail of half a rank batch a rank (host
    # arrays, as the CLI's iterator gives them)
    full = {k: v.numpy() for k, v in batch.items()}
    out["recon_eval"] = recon.trainer.evaluate(
        [pmesh.shard_rows(full, d, dp),
         pmesh.shard_rows(pmesh.shard_rows(full, 0, 2), d, dp)])

    cfg = GANTrainConfig(model=GANConfig(**stages.TINY_GAN),
                         batch_size=global_b)
    gan = stages.gan(cfg, stages.gan_batch(cfg, seed=4), mesh, device, tpl)
    out["gan_g_losses"] = gan.step()
    out["gan_d_losses"] = gan.step()
    out["gan_g_grads"] = stages.grads(gan.trainer.generator)
    out["gan_d_grads"] = stages.grads(gan.trainer.discriminator)
    out["gan_ema"] = {k: v.clone()
                      for k, v in gan.trainer.g_ema.state_dict().items()}
    return out


def steps_rank(rank, world, device, global_b):
    return steps(pmesh.make_2d_mesh(), device, global_b)


# -- (e) checkpoints between tp ranks and one process -------------------------


def checkpoint_rank(rank, world, device, tp, global_b, workdir,
                    one_process_dir):
    """At dp x tp: restore the one-process checkpoint (returning this rank's
    slices), take a step and save to ``workdir`` (rank 0 writes the full
    width); returns the state both times."""
    mesh = pmesh.make_2d_mesh(tp)
    cfg = ShapeNetConfig(batch_size=global_b, **stages.TINY_CHAIRS)
    stage = stages.chairs(cfg, stages.chairs_batch(cfg), mesh, device)
    learner = stage.trainer
    learner.restore(one_process_dir)
    restored = copy.deepcopy(dict(params=learner.model.state_dict(),
                                  opt=learner.opt.state_dict()["state"],
                                  step=learner.step))
    stage.step()
    learner.save(workdir)
    params, opt = pmesh.full_state(learner.model, learner.opt, mesh)
    dist.barrier()
    return dict(restored=restored, saved=dict(params=params,
                                              opt=opt["state"]),
                model_rank=mesh.model_rank, world=world)


def barrier_rank(rank, world, device, timeout_s, away_s):
    """Rank 0 stays ``away_s`` from ``Mesh.barrier``, whose timeout is set
    to ``timeout_s``; the others wait there."""
    pmesh.RANK0_PASS_TIMEOUT = datetime.timedelta(seconds=timeout_s)
    mesh = pmesh.make_2d_mesh()
    if rank == 0:
        time.sleep(away_s)
    mesh.barrier()
    return rank


def stuck_rank(rank, world, device):
    """Rank 0 waits in a collective that rank 1 never joins."""
    if rank == 0:
        dist.barrier()
    else:
        time.sleep(120)


def failing_rank(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank
